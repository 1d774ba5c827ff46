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
out) and its group and scan partition. Tolerance: exact equality."""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.ext import GF2 as JGF2
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import lookup as jlookup
from tendermintx_tpu_torch.ops.ext import GF2, ext_add, ext_inv, ext_mul, ext_sub
from tendermintx_tpu_torch.ops.goldilocks import GF, P
from tendermintx_tpu_torch.stark import lookup as lk

EDGES = [0, 1, P - 1, 2**32, P - 2**32]

# (checked columns, n_rows, table_bits): pad = 4 ceil(K / 4) - K
CASES = {
    "pad0-width1": (8, 64, 5),
    "pad2-width1": (6, 32, 5),
    "pad3-width4": (5, 16, 6),
    "pad1-width2": (7, 32, 6),
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
        assert (group - 1) * n_groups < terms <= group * n_groups and (n_groups > 1) == (blocks > 1 and terms > 1)
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


def _term_model(port, trace, gamma, t: int, r: int) -> tuple[int, int]:
    """csrc/logup.cu: tmx_logup_terms_kernel's value of term t at row r."""
    if t < port.n_batches:
        d, real = [], 0
        for i in range(lk.BATCH):
            c = t * lk.BATCH + i
            if c < len(port.checked_cols):
                d.append(((gamma[0] - int(trace[port.checked_cols[c], r])) % P, gamma[1]))
                real += 1
            else:
                d.append((1, 0))
        p01, p23 = ext_mul(d[0], d[1]), ext_mul(d[2], d[3])
        denom = ext_mul(p01, p23)
        numer = ext_add(ext_mul(p23, ext_add(d[0], d[1])), ext_mul(p01, ext_add(d[2], d[3])))
        if real < lk.BATCH:
            numer = ext_sub(numer, ((lk.BATCH - real) * denom[0] % P, (lk.BATCH - real) * denom[1] % P))
        return ext_mul(numer, ext_inv(denom))
    j = t - port.n_batches
    tv = j * port._span + r % port._span
    inv = ext_inv(((gamma[0] - tv) % P, gamma[1]))
    m = int(trace[port.mult_base + j, r])
    return inv[0] * m % P, inv[1] * m % P


@pytest.mark.parametrize("name", ["pad3-width4", "pad1-width2"])
def test_kernel_term_model_matches_reference(name):
    port, ref, trace, gamma = _case(name, 17)
    want = _ju(ref.build_aux(JGF.from_ints(trace), gamma))
    terms = port.n_batches + port.width
    for r in (0, 5, port.n_rows - 1):
        for t in range(terms):
            v = _term_model(port, trace, gamma, t, r)
            assert v == (want[2 * t][r], want[2 * t + 1][r])
    # the scan's chunks (SCAN_THREADS consecutive rows, one a thread, the
    # rows past n adding nothing): each row once, in order, and each S the
    # chunk's inclusive scan plus the chunks before it
    threads = 1024
    rng = np.random.default_rng(19)
    for n in (1, 16, 1000, 1025, 1 << 12):
        diff = [int(v) for v in rng.integers(0, 2**62, size=n)]
        S, carry = [], 0
        for base in range(0, n, threads):
            chunk = [diff[r] if r < n else 0 for r in range(base, base + threads)]
            incl = [v % P for v in itertools.accumulate(chunk)]
            S += [(carry + v) % P for v in incl[: max(0, min(threads, n - base))]]
            carry = (carry + incl[-1]) % P
        assert S == [v % P for v in itertools.accumulate(diff)]
