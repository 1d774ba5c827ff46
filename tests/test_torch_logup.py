"""The port's LogUp aux columns on the CPU (stark/lookup.py:
RangeLookup.build_aux_plain and its pieces _aux_w, _aux_wt, _aux_scan,
_aux_assemble, and the twins of the card's two kernels, logup_terms_plain
and logup_scan_plain; the card's are csrc/logup.cu, tests/test_torch_cuda.py)
against the JAX package's RangeLookup.build_aux and its ``_aux_*_kernel``
programs: no pad, pad 1-3 in the last batch, one table column and several
(n_rows < table_size), checked columns out of order, the edge values 0, 1,
p-1, 2^32 and p - 2^32, and a gamma equal to a checked value (a zero
denominator, inverted to 0 on both sides). Then a Python model of
csrc/logup.cu's term formula (pad cells d = 1, (BATCH - real) denom taken
out) and its group and scan partition. Then a Python model of
csrc/logup.cu's schedule: each thread's runs of _LOGUP_TERMS terms, each
term's numerator and denominator (the closed form of a full batch, the
reference's form with pad cells), the divisions by their norms done
together by ext.cuh's batch_div (zeros masked, at the first, a middle and
the last position of a run), groups whose term count is no multiple of
the run, pad 1-3; and of its scan: tile sums, then each tile's chunks
scanned after the carry of the tiles before it (one tile, many, a ragged
last tile). Tolerance: exact equality."""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.ext import GF2 as JGF2
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import lookup as jlookup
from tendermintx_tpu_torch.ops.ext import GF2, W, ext_add, ext_mul, ext_sub
from tendermintx_tpu_torch.ops.goldilocks import GF, P
from tendermintx_tpu_torch.stark import lookup as lk

EDGES = [0, 1, P - 1, 2**32, P - 2**32]

# (checked columns, n_rows, table_bits): pad = 4 ceil(K / 4) - K
CASES = {
    "pad0-width1": (8, 64, 5),
    "pad2-width1": (6, 32, 5),
    "pad3-width4": (5, 16, 6),
    "pad1-width2": (7, 32, 6),
    "pad3-runs": (45, 16, 5),  # 12 batches + 2 table columns: runs of 8 and 6 terms
}


def _case(name: str, seed: int, gamma_hits: bool = False):
    K, n, bits = CASES[name]
    rng = np.random.default_rng(seed)
    probe = lk.RangeLookup(list(range(K)), 0, n, bits)
    width = probe.width
    n_cols = K + width + 3
    # the multiplicity columns are consecutive: place them first, then the
    # checked columns from the rest, out of order
    mult_base = int(rng.integers(0, n_cols - width + 1))
    rest = [c for c in range(n_cols) if not mult_base <= c < mult_base + width]
    checked = [int(c) for c in rng.permutation(rest)[:K]]
    trace = (rng.integers(0, 2**63, size=(n_cols, n)).astype(object) * 2
             + rng.integers(0, 2, size=(n_cols, n))) % P
    trace[checked[0], : len(EDGES)] = EDGES
    gamma = (int(rng.integers(0, 2**62)), int(rng.integers(0, 2**62)))
    if gamma_hits:
        gamma = (int(trace[checked[-1], 5]), 0)
    port = lk.RangeLookup(checked, mult_base, n, bits)
    ref = jlookup.RangeLookup(checked, mult_base, n, bits)
    return port, ref, trace, gamma


def _gamma(g) -> GF2:
    return GF2(GF.from_ints(np.array([g[0]], dtype=object)), GF.from_ints(np.array([g[1]], dtype=object)))


def _jgamma(g) -> JGF2:
    return JGF2(JGF.from_ints(np.array([g[0]], dtype=object)), JGF.from_ints(np.array([g[1]], dtype=object)))


def _u(t: torch.Tensor) -> list:
    return t.numpy().view(np.uint64).astype(object).tolist()


def _ju(g: JGF) -> list:
    return np.asarray(g.to_ints()).tolist()


@pytest.mark.parametrize("name", list(CASES))
def test_build_aux_plain_matches_reference(name):
    port, ref, trace, gamma = _case(name, 7)
    got = port.build_aux(GF.from_ints(trace), _gamma(gamma))
    want = ref.build_aux(JGF.from_ints(trace), gamma)
    assert _u(got.v) == _ju(want)
    assert tuple(got.shape) == (port.n_aux_cols, port.n_rows)


def test_zero_denominator_inverts_to_zero_on_both_sides():
    port, ref, trace, gamma = _case("pad2-width1", 8, gamma_hits=True)
    got = _u(port.build_aux(GF.from_ints(trace), _gamma(gamma)).v)
    assert got == _ju(ref.build_aux(JGF.from_ints(trace), gamma))
    # the batch of the hit column is 0 at row 5
    b = port.checked_cols.index(port.checked_cols[-1]) // lk.BATCH
    assert (got[2 * b][5], got[2 * b + 1][5]) == (0, 0)


@pytest.mark.parametrize("name", ["pad0-width1", "pad3-width4"])
def test_each_piece_matches_its_reference_program(name):
    port, ref, trace, gamma = _case(name, 11)
    n, K, nb = port.n_rows, len(port.checked_cols), port.n_batches
    pad = nb * lk.BATCH - K
    cells = np.concatenate([trace[port.checked_cols], np.zeros((pad, n), dtype=object)]).reshape(nb, lk.BATCH, n)
    g, jg = _gamma(gamma), _jgamma(gamma)
    w = lk._aux_w(GF.from_ints(cells), g, pad)
    jw = jlookup._aux_w_kernel(JGF.from_ints(cells), jg, pad=pad)
    assert (_u(w.c0.v), _u(w.c1.v)) == (_ju(jw.c0), _ju(jw.c1))
    table = port._table_values()
    m = trace[port.mult_base : port.mult_base + port.width]
    wt = lk._aux_wt(GF.from_small(table), GF.from_ints(m), g)
    jwt = jlookup._aux_wt_kernel(JGF.from_u32(table), JGF.from_ints(m), jg)
    assert (_u(wt.c0.v), _u(wt.c1.v)) == (_ju(jwt.c0), _ju(jwt.c1))
    S = lk._aux_scan(w, wt)
    jS = jlookup._aux_scan_kernel(jw, jwt)
    assert (_u(S.c0.v), _u(S.c1.v)) == (_ju(jS.c0), _ju(jS.c1))
    assert _u(lk._aux_assemble(w, wt, S).v) == _ju(jlookup._aux_assemble_kernel(jw, jwt, jS))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_twins_give_the_aux_columns(name, monkeypatch):
    """logup_terms_plain's rows are the w and wt rows, its group sums
    those of the rows' signed terms, and logup_scan_plain's S the last two
    rows; with several groups (a small block target) and with one."""
    port, ref, trace, gamma = _case(name, 13)
    want = _ju(ref.build_aux(JGF.from_ints(trace), gamma))
    terms = port.n_batches + port.width
    for blocks in (1, 4096):
        monkeypatch.setattr(lk, "_LOGUP_BLOCKS", blocks)
        group, n_groups = port.logup_groups()
        assert group % lk._LOGUP_TERMS == 0 and (n_groups - 1) * group < terms <= group * n_groups
        assert (n_groups > 1) == (blocks > 1 and terms > lk._LOGUP_TERMS)
        rows, partial = port.logup_terms_plain(GF.from_ints(trace), _gamma(gamma))
        assert _u(rows) == want[: 2 * terms]
        assert tuple(partial.shape) == (2, n_groups, port.n_rows)
        for c in range(2):
            for r in range(port.n_rows):
                diff = sum(want[2 * t + c][r] * (1 if t < port.n_batches else -1) for t in range(terms)) % P
                assert sum(_u(partial[c, :, r])) % P == diff
        assert _u(lk.RangeLookup.logup_scan_plain(partial)) == want[2 * terms :]


def test_cpu_trace_never_reaches_a_kernel():
    port, _, trace, gamma = _case("pad2-width1", 3)
    before = (lk.logup_terms_kernel_launches, lk.logup_scan_kernel_launches)
    port.build_aux(GF.from_ints(trace), _gamma(gamma))
    assert (lk.logup_terms_kernel_launches, lk.logup_scan_kernel_launches) == before
    out = torch.empty((port.n_aux_cols, port.n_rows), dtype=torch.int64)
    with pytest.raises(TypeError):
        port.logup_terms_cuda(GF.from_ints(trace), _gamma(gamma), out)
    with pytest.raises(TypeError):
        port.logup_scan_cuda(torch.zeros((2, 1, port.n_rows), dtype=torch.int64), out)
    with pytest.raises(ValueError, match="device"):
        port.build_aux(GF(torch.zeros((1, 1), dtype=torch.int64, device="meta")), _gamma(gamma))


# ---------------------------------------------------------------------------
# A model of csrc/logup.cu on Python ints
# ---------------------------------------------------------------------------


def _batch_div_model(n: list[int], y: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """ext.cuh: batch_div, y[i] / n[i] by Montgomery's trick: each y[i]
    times the product of the n before it on the way up, times the inverse
    of the product up to n[i] on the way down; a zero n[i] masked to 1 in
    the products and its y[i] made 0."""
    n, y = list(n), list(y)
    pre = 1
    for i in range(len(n)):
        if n[i] == 0:
            n[i], y[i] = 1, (0, 0)
        y[i] = (y[i][0] * pre % P, y[i][1] * pre % P)
        pre = pre * n[i] % P
    acc = pow(pre, P - 2, P)
    for i in range(len(n) - 1, -1, -1):
        y[i] = (y[i][0] * acc % P, y[i][1] * acc % P)
        acc = acc * n[i] % P
    return y


def _dot2(a: int, b: int, c: int, d: int) -> int:
    return (a * b + c * d) % P


def _batch_term_model(port, gamma, cells: list[int]) -> tuple[tuple, tuple]:
    """csrc/logup.cu: batch_term, a checked term's numerator U and
    denominator D from its cells' values: the closed form of a full batch
    (every c1 is g1), and the reference's form with pad cells d = 1."""
    g0, g1 = gamma
    wg2 = g1 * g1 * W % P
    a = [(g0 - v) % P for v in cells]
    if len(a) == lk.BATCH:
        s01, s23 = (a[0] + a[1]) % P, (a[2] + a[3]) % P
        x, y = (a[0] * a[1] + wg2) % P, (a[2] * a[3] + wg2) % P
        m = s01 * s23 % P
        D = (_dot2(x, y, wg2, m), g1 * _dot2(x, s23, y, s01) % P)
        U = ((y * s01 + x * s23 + 2 * wg2 * (s01 + s23)) % P, 2 * g1 * (x + y + m) % P)
        return U, D
    d = [(ai, g1) for ai in a] + [(1, 0)] * (lk.BATCH - len(a))
    p01, p23 = ext_mul(d[0], d[1]), ext_mul(d[2], d[3])
    D = ext_mul(p01, p23)
    U = ext_add(ext_mul(p23, ext_add(d[0], d[1])), ext_mul(p01, ext_add(d[2], d[3])))
    pad = lk.BATCH - len(a)
    return ext_sub(U, (pad * D[0] % P, pad * D[1] % P)), D


def _kernel_model(port, trace, gamma, r: int) -> tuple[dict, list]:
    """csrc/logup.cu: tmx_logup_terms_kernel at row r, every group of its
    grid: each run of _LOGUP_TERMS terms of a group, each term's U and D
    (a table term's m and gamma - t), N(D) = D0^2 - W D1^2 and Y = U
    conj(D), the run's divisions Y / N(D) done together (1 and 0 in a slot
    past the group). Returns {term: (c0, c1)} and the groups' signed
    sums."""
    g0, g1 = gamma
    K, nb, span = len(port.checked_cols), port.n_batches, port._span
    terms = nb + port.width
    group, n_groups = port.logup_groups()
    vals, sums = {}, []
    for gi in range(n_groups):
        t0 = gi * group
        t1 = min(t0 + group, terms)
        s = (0, 0)
        for u0 in range(t0, t1, lk._LOGUP_TERMS):
            ys, norms = [], []
            for t in range(u0, u0 + lk._LOGUP_TERMS):
                if t >= t1:
                    ys.append((0, 0))
                    norms.append(1)
                    continue
                if t < nb:
                    cols = port.checked_cols[t * lk.BATCH : min(K, (t + 1) * lk.BATCH)]
                    U, D = _batch_term_model(port, gamma, [int(trace[c, r]) for c in cols])
                else:
                    D = ((g0 - ((t - nb) * span + r % span)) % P, g1)
                    U = (int(trace[port.mult_base + t - nb, r]), 0)
                nwd1 = -W * D[1] % P
                norms.append(_dot2(D[0], D[0], nwd1, D[1]))
                ys.append((_dot2(U[0], D[0], U[1], nwd1), _dot2(U[1], D[0], U[0], -D[1] % P)))
            div = _batch_div_model(norms, ys)
            for q, t in enumerate(range(u0, min(u0 + lk._LOGUP_TERMS, t1))):
                vals[t] = div[q]
                s = ext_add(s, vals[t]) if t < nb else ext_sub(s, vals[t])
        sums.append(s)
    return vals, sums


def test_batch_division_model_masks_zeros():
    """batch_div over a run of 8 norms: y / n exact for the nonzero n, 0
    for a zero at the first, a middle and the last position."""
    rng = np.random.default_rng(23)
    x = [int(a) for a in (rng.integers(1, 2**63, size=24).astype(object) * 2 + 1) % P]
    n, y = x[:8], list(zip(x[8:16], x[16:]))
    for zeros in ([], [0], [3], [7], [0, 3, 7], list(range(8))):
        nz = [0 if i in zeros else a for i, a in enumerate(n)]
        want = [(0, 0) if not a else (b[0] * pow(a, P - 2, P) % P, b[1] * pow(a, P - 2, P) % P) for a, b in zip(nz, y)]
        assert _batch_div_model(nz, y) == want


@pytest.mark.parametrize("name, blocks", [("pad3-width4", 2048), ("pad1-width2", 2048), ("pad2-width1", 2048),
                                          ("pad3-runs", 2048), ("pad3-runs", 1)])
def test_kernel_term_model_matches_reference(name, blocks, monkeypatch):
    """The model's terms equal the reference's aux rows and its group sums
    those of the rows' signed terms: pad 1-3, one to four table columns,
    and 14 terms in one group (runs of 8 and 6) or in two (8 and 6)."""
    monkeypatch.setattr(lk, "_LOGUP_BLOCKS", blocks)
    port, ref, trace, gamma = _case(name, 17)
    want = _ju(ref.build_aux(JGF.from_ints(trace), gamma))
    terms = port.n_batches + port.width
    group, n_groups = port.logup_groups()
    for r in (0, 5, port.n_rows - 1):
        vals, sums = _kernel_model(port, trace, gamma, r)
        assert [vals[t] for t in range(terms)] == [(want[2 * t][r], want[2 * t + 1][r]) for t in range(terms)]
        for gi, s in enumerate(sums):
            sign = lambda t: 1 if t < port.n_batches else -1
            ts = range(gi * group, min((gi + 1) * group, terms))
            assert s == tuple(sum(sign(t) * want[2 * t + c][r] for t in ts) % P for c in range(2))
    # the scan's tiles (whole chunks of _SCAN_THREADS consecutive rows, one
    # a thread, the rows past n adding nothing): each row once, in order,
    # and each S its chunk's inclusive scan plus the carry of the rows before
    rng = np.random.default_rng(19)
    for n in (1, 16, 1000, 1025, 1 << 12):
        diff = [int(v) for v in rng.integers(0, 2**62, size=n)]
        tile, n_tiles = lk.RangeLookup([0], 1, n, 13).scan_tiles()
        assert _scan_model(diff, tile, n_tiles) == [v % P for v in itertools.accumulate(diff)]


def _scan_model(diff: list[int], tile: int, n_tiles: int) -> list[int]:
    """csrc/logup.cu: tmx_logup_scan's two kernels over one component of
    the rows' sums: tmx_logup_tile_sums_kernel's sum of each tile of `tile`
    rows (the last one ragged), then tmx_logup_scan_kernel's tile b: the
    sums of the tiles before it as the carry, its rows in chunks of
    _SCAN_THREADS (one a thread, zero past the end), each chunk's
    inclusive scan by warps of 32 (a shuffle scan, then the warps'
    totals) plus the carry, which then takes the chunk's total."""
    n, threads = len(diff), lk._SCAN_THREADS
    assert tile % threads == 0 and n_tiles == -(-n // tile)
    sums = [sum(diff[b * tile : (b + 1) * tile]) % P for b in range(n_tiles)]
    S = []
    for b in range(n_tiles):
        carry = sum(sums[:b]) % P
        r1 = min(n, (b + 1) * tile)
        for base in range(b * tile, r1, threads):
            x = [diff[r] if r < r1 else 0 for r in range(base, base + threads)]
            warps = [list(itertools.accumulate(x[w : w + 32])) for w in range(0, threads, 32)]
            before = [0, *itertools.accumulate(w[-1] for w in warps)]
            chunk = [(v + before[i // 32] + carry) % P for i, v in enumerate(v for w in warps for v in w)]
            S += chunk[: r1 - base]
            carry = (carry + before[-1]) % P
    return S


@pytest.mark.parametrize("n, tiles", [(16, 128), (256, 128), (1 << 15, 128), (33_000, 128), (1025, 2), (5000, 3)])
def test_scan_tile_model_equals_the_plain_scan(n, tiles, monkeypatch):
    """The multi-block scan's schedule gives logup_scan_plain's S from the
    groups' sums: one tile (16 and 256 rows), Ed25519's 2^15 rows as 128
    tiles of one chunk, 33,000 rows as tiles of two chunks with a ragged
    last tile, and tiles of several chunks (fewer tiles a wave) at a
    ragged row count."""
    monkeypatch.setattr(lk, "_SCAN_TILES", tiles)
    port = lk.RangeLookup([0, 1], 2, n, 13)
    tile, n_tiles = port.scan_tiles()
    assert tile % lk._SCAN_THREADS == 0 and n_tiles <= tiles and (n_tiles - 1) * tile < n <= n_tiles * tile
    assert (n_tiles == 1) == (n <= lk._SCAN_THREADS or tiles == 1)
    rng = np.random.default_rng(n)
    partial = rng.integers(0, P, size=(2, 3, n), dtype=np.uint64)
    want = _u(lk.RangeLookup.logup_scan_plain(torch.from_numpy(partial.view(np.int64))))
    rows = partial.astype(object).sum(axis=1) % P
    assert [_scan_model([int(v) for v in rows[c]], tile, n_tiles) for c in range(2)] == want


def test_kernel_model_masks_zero_norms():
    """gamma = (v, 0) for a value v placed in cells of terms 0, 3 and 7 (the
    first, a middle and the last position of run 0's batch inversion) and
    9 (run 1), and then a table value as gamma: those terms' norms are 0,
    their values 0 as the reference's, every other term exact."""
    port, ref, trace, _ = _case("pad3-runs", 29)
    r = 3
    v = int(trace[port.checked_cols[0], r])
    for c in (13, 31, 9 * lk.BATCH + 1):
        trace[port.checked_cols[c], r] = v
    gamma = (v, 0)
    want = _ju(ref.build_aux(JGF.from_ints(trace), gamma))
    vals, _ = _kernel_model(port, trace, gamma, r)
    terms = port.n_batches + port.width
    assert [vals[t] for t in range(terms)] == [(want[2 * t][r], want[2 * t + 1][r]) for t in range(terms)]
    assert {t for t in range(terms) if vals[t] == (0, 0)} == {0, 3, 7, 9}
    gamma = (r % port._span, 0)  # table column 0's value at row r
    want = _ju(ref.build_aux(JGF.from_ints(trace), gamma))
    vals, _ = _kernel_model(port, trace, gamma, r)
    assert [vals[t] for t in range(terms)] == [(want[2 * t][r], want[2 * t + 1][r]) for t in range(terms)]
    assert vals[port.n_batches] == (0, 0)
