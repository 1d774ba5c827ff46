"""The recursion wrap's device programs on the CPU: the plain twins of
csrc/logup.cu's EvalAir entries (stark/evalair.py: _eval_terms, _eval_scan,
_eval_assemble, eval_aux_plain) against the JAX
package's _eval_terms_kernel, _eval_scan_kernel and _eval_assemble_kernel
at 2^4, 2^8 and 2^11 rows, with random gamma and delta and with a planted
zero denominator; Python models of the eval kernels' schedule (the four
terms' batch division, the scan's tiles) against the twins; the grinding
search (ops/poseidon.py: grind_plain, stark/fri.py: grind) against the JAX
package's _grind_fn and check_grind at pow_bits 1-10; a Python model of
csrc/poseidon.cu's round-state kernel against expand_plain; the ctypes
layout of EvalArgs against the source; and the CPU dispatch. The card's
kernels are held against the twins in tests/test_torch_cuda.py. Tolerance:
exact equality (field arithmetic)."""

import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.ext import GF2 as JGF2
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import evalair as jev
from tendermintx_tpu.stark import fri as jfri
from tendermintx_tpu_torch.ops import poseidon as ps
from tendermintx_tpu_torch.ops.ext import GF2, W, ext_mul
from tendermintx_tpu_torch.ops.goldilocks import GF, P, tensor_from_u64
from tendermintx_tpu_torch.stark import evalair as ev
from tendermintx_tpu_torch.stark import fri
from tendermintx_tpu_torch.stark import lookup as lk
from tendermintx_tpu_torch.stark import recursion as rec

from test_torch_logup import _batch_div_model, _dot2, _scan_model

EDGES = [0, 1, P - 1, 2**32 - 1, 2**32, P - 2**32]


def _felts(rng, shape) -> np.ndarray:
    x = (rng.integers(0, 2**63, size=shape).astype(object) * 2 + rng.integers(0, 2, size=shape)) % P
    x.reshape(-1)[: len(EDGES)] = EDGES[: x.size]
    return x


def _eval_case(n: int, seed: int, planted: bool):
    """(trace (8, n), static rows (8, n), gamma, delta) as Python ints:
    random values, addresses below n, multiplicities (a count row, then
    three 0/1 gate rows); `planted`: gamma made equal to one cell's a +
    delta v0 + delta^2 v1, a zero denominator at (row, term) (n // 2, 2)."""
    rng = np.random.default_rng(seed)
    trace = _felts(rng, (8, n))
    rows = np.concatenate([rng.integers(0, n, size=(4, n)), rng.integers(0, 2**32, size=(1, n)),
                           rng.integers(0, 2, size=(3, n))]).astype(object)
    ext = lambda: tuple(int(v) % P for v in rng.integers(0, 2**63, size=2).astype(object) * 2 + 1)
    delta = ext()
    if planted:
        r, k = n // 2, 2
        d2 = ext_mul(delta, delta)
        v0, v1 = int(trace[2 * k, r]), int(trace[2 * k + 1, r])
        gamma = ((int(rows[k, r]) + delta[0] * v0 + d2[0] * v1) % P, (delta[1] * v0 + d2[1] * v1) % P)
    else:
        gamma = ext()
    return trace, rows, gamma, delta


def _gf2(g) -> GF2:
    return GF2.from_ints([g[0]], [g[1]])


def _jgf2(g) -> JGF2:
    return JGF2(JGF.from_ints(np.array([g[0]], dtype=object)), JGF.from_ints(np.array([g[1]], dtype=object)))


def _u(t: torch.Tensor) -> list:
    return t.numpy().view(np.uint64).astype(object).tolist()


def _ju(g) -> list:
    return np.asarray(g.to_ints()).tolist()


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("n", [1 << 4, 1 << 8, 1 << 11])
def test_eval_programs_match_jax(n, planted):
    """Each plain program against its JAX program, and eval_aux_plain (the
    card entries' twin) against the assembled reference rows."""
    trace, rows, gamma, delta = _eval_case(n, 40 + n, planted)
    v0, v1 = GF.from_ints(trace[0::2]), GF.from_ints(trace[1::2])
    addrs, mults = GF.from_ints(rows[:4]), GF.from_ints(rows[4:])
    terms = ev._eval_terms(addrs, mults, v0, v1, _gf2(gamma), _gf2(delta))
    vals = JGF.from_ints(np.concatenate([trace[0::2], trace[1::2]]))
    jterms = jev._eval_terms_kernel(JGF.from_ints(rows[:4]), JGF.from_ints(rows[4:]), vals, _jgf2(gamma),
                                    _jgf2(delta))
    assert (_u(terms.c0.v), _u(terms.c1.v)) == (_ju(jterms.c0), _ju(jterms.c1))
    if planted:
        assert (_u(terms.c0.v)[2][n // 2], _u(terms.c1.v)[2][n // 2]) == (0, 0)
    S, jS = ev._eval_scan(terms), jev._eval_scan_kernel(jterms)
    assert (_u(S.c0.v), _u(S.c1.v)) == (_ju(jS.c0), _ju(jS.c1))
    want = _ju(jev._eval_assemble_kernel(jterms, jS))
    assert _u(ev._eval_assemble(terms, S).v) == want
    t, r = GF.from_ints(trace), tensor_from_u64(rows.astype(np.uint64))
    assert _u(ev.eval_aux_plain(t, r, _gf2(gamma), _gf2(delta)).v) == want


def _eval_kernel_model(trace, rows, gamma, delta, r: int) -> tuple[list, tuple]:
    """csrc/logup.cu: tmx_eval_terms_kernel at row r: delta^2, each term's
    D = gamma - (a + delta v0 + delta^2 v1) from the trace's rows 2k and
    2k + 1, N(D) = D0^2 - W D1^2 and Y = (m D0, -m D1), the four divisions
    Y / N(D) together (batch_div), then tw - ta - tb - tc."""
    e = ext_mul(delta, delta)
    norms, ys = [], []
    for k in range(4):
        v0, v1 = int(trace[2 * k, r]), int(trace[2 * k + 1, r])
        a, m = int(rows[k, r]), int(rows[4 + k, r])
        D0 = (gamma[0] - a - _dot2(delta[0], v0, e[0], v1)) % P
        D1 = (gamma[1] - _dot2(delta[1], v0, e[1], v1)) % P
        norms.append(_dot2(D0, D0, -W * D1 % P, D1))
        ys.append((m * D0 % P, -m * D1 % P))
    t = _batch_div_model(norms, ys)
    return t, tuple((t[0][c] - t[1][c] - t[2][c] - t[3][c]) % P for c in range(2))


@pytest.mark.parametrize("planted", [False, True])
def test_eval_kernel_model_matches_the_twins(planted, monkeypatch):
    """The terms kernel's model at every row equals eval_aux_plain's term
    rows (the planted zero denominator's term 0); the scan's model over the
    model's row sums, at the eval scan's tiles and at tiles of several
    chunks and a ragged last tile, equals eval_aux_plain's S rows (of a
    prefix of m rows, S's first m)."""
    n = 1 << 11
    trace, rows, gamma, delta = _eval_case(n, 7, planted)
    aux = _u(ev.eval_aux_plain(GF.from_ints(trace), tensor_from_u64(rows.astype(np.uint64)), _gf2(gamma),
                               _gf2(delta)).v)
    sums = [[], []]
    for r in range(n):
        terms, s = _eval_kernel_model(trace, rows, gamma, delta, r)
        assert terms == [(aux[2 * k][r], aux[2 * k + 1][r]) for k in range(4)]
        for c in range(2):
            sums[c].append(s[c])
        if planted and r == n // 2:
            assert terms[2] == (0, 0)
    for m, tiles in ((n, 128), (n, 3), (1000, 2), (257, 128)):
        monkeypatch.setattr(lk, "_SCAN_TILES", tiles)
        tile, n_tiles = lk.scan_tiles(m)
        assert tile % lk._SCAN_THREADS == 0 and (n_tiles - 1) * tile < m <= n_tiles * tile
        assert [_scan_model(sums[c][:m], tile, n_tiles) for c in range(2)] == [aux[8 + c][:m] for c in range(2)]


def test_eval_args_layout_matches_the_source():
    """ctypes' _EvalArgs has csrc/logup.cu's EvalArgs fields in order: a
    pointer for each pointer, a 64-bit int for each int64_t."""
    src = open(os.path.join(os.path.dirname(ev.__file__), "..", "csrc", "logup.cu")).read()
    body = re.search(r"struct EvalArgs \{(.*?)\};", src, re.S).group(1)
    fields = [(m.group(2), "*" in m.group(1)) for m in re.finditer(r"^\s*([\w\s*]+?)\s*(\w+);", body, re.M)]
    want = [(name, ctype.__name__ == "c_void_p") for name, ctype in ev._EvalArgs._fields_]
    assert fields == want


def test_grind_matches_jax_and_check_grind():
    """pow_bits 1-10, three seeds each (one the largest field element):
    the JAX package's _grind_fn over batches of 64 from 0, grind_plain over
    the same batches and the host loop of grind give one nonce, which
    check_grind accepts; at 7 bits and up the hits lie past the first
    batch."""
    batch = 64
    past = 0
    for pow_bits in range(1, 11):
        jfn = jfri._grind_fn(pow_bits, batch)
        for seed in (3, 0x1234_5678_9ABC, P - 1):
            start, jnonce = 0, None
            while jnonce is None:
                idx, found = jfn(np.uint32(seed & 0xFFFFFFFF), np.uint32(seed >> 32), np.uint32(start))
                jnonce = start + int(idx) if bool(found) else None
                start += batch
            start, nonce = 0, None
            while nonce is None:
                nonce = ps.grind_plain(seed, pow_bits, start, batch, "cpu")
                assert nonce is None or start <= nonce < start + batch
                start += batch
            assert nonce == jnonce == fri.grind(seed, pow_bits) == fri.grind(seed, pow_bits, "cpu")
            assert fri.check_grind(seed, nonce, pow_bits)
            past += nonce >= batch
    assert past >= 6


def test_grind_plain_refuses_what_the_kernel_does_not_take():
    for args in ((P, 4, 0, 8), (-1, 4, 0, 8), (1, 0, 0, 8), (1, 33, 0, 8), (1, 4, -1, 8), (1, 4, 0, 0)):
        with pytest.raises(ValueError):
            ps.grind_plain(*args, "cpu")
    with pytest.raises(TypeError):
        ps.grind_cuda(1, 4, 0, 8, "cpu")


def _sbox(x: int) -> int:
    return pow(x, 7, P)


def _expand_kernel_model(state: list[int]) -> list[int]:
    """csrc/poseidon.cu: tmx_poseidon_expand_kernel on one state, in its
    order of stores: rounds 0-2 each S-boxes s + rc[r], then an MDS layer
    adding the zero row (stored); round 3's MDS adds round 4's constants;
    each partial round stores lane 0 (the pre-S-box value), S-boxes it and
    runs an MDS adding the next round's constants (the zero row after round
    25: w26, stored); rounds 26-28 as rounds 0-2."""
    rc, mds = ps.round_constants(), ps.mds_matrix()
    zero = [0] * ps.WIDTH
    mds_layer = lambda s, k: [(sum(mds[i][j] * s[j] for j in range(ps.WIDTH)) + k[i]) % P for i in range(ps.WIDTH)]
    full = lambda s, r: [_sbox((x + c) % P) for x, c in zip(s, rc[r])]
    s, out = list(state), []
    for r in range(4):
        s = mds_layer(full(s, r), zero if r < 3 else rc[4])
        if r < 3:
            out += s
    for r in range(4, 26):
        out.append(s[0])
        s = mds_layer([_sbox(s[0])] + s[1:], rc[r + 1] if r < 25 else zero)
    out += s
    for r in range(26, 29):
        s = mds_layer(full(s, r), zero)
        out += s
    return out


def test_expand_kernel_model_matches_expand_plain():
    """The model's 106 stores, in order, are expand_plain's column of each
    state (edge values included): the kernel writes column c of state b at
    c n + b."""
    rng = np.random.default_rng(3)
    states = _felts(rng, (4, ps.WIDTH))
    got = _u(ps.expand_plain(GF.from_ints(states).v))
    assert len(got) == ps.EXPAND_COLS == rec.N_PERM_COLS - rec.COL_S
    for b in range(4):
        assert _expand_kernel_model([int(v) for v in states[b]]) == [got[c][b] for c in range(ps.EXPAND_COLS)]


def test_cpu_tensors_take_the_plain_twins():
    """A CPU trace or state takes the plain twin and launches nothing; the
    static rows are uploaded once per tape and device; the kernel wrappers
    refuse CPU tensors and an unknown device raises."""
    n = 1 << 4
    trace, rows, gamma, delta = _eval_case(n, 5, False)
    tape = ev.Tape(op=np.zeros(n - 1, dtype=np.uint8), a=np.zeros(n - 1, dtype=np.uint32),
                   b=np.zeros(n - 1, dtype=np.uint32), c=np.zeros(n - 1, dtype=np.uint32), const=[1] * (n - 1),
                   is_input=np.zeros(n - 1, dtype=bool), input_tags=[], assert_rows=np.zeros(0, dtype=np.uint32),
                   m=np.ones(n - 1, dtype=np.uint32))
    air = ev.EvalAir(tape)
    assert tape.n_rows == n
    counts = lambda: (ev.eval_terms_kernel_launches, ev.eval_scan_kernel_launches, ps.expand_kernel_launches,
                      ps.grind_kernel_launches, ps.permute_kernel_launches)
    before = counts()
    t, chal = GF.from_ints(trace), [_gf2(gamma), _gf2(delta)]
    got = air.aux_columns(t, chal, [])
    assert air.aux_rows("cpu") is air.aux_rows(torch.device("cpu")) is tape.device_rows[torch.device("cpu")]
    assert _u(got.v) == _u(ev.eval_aux_plain(t, air.aux_rows("cpu"), *chal).v)
    states = GF.from_ints(_felts(np.random.default_rng(1), (8, ps.WIDTH)))
    assert _u(rec.expand_perm_states(states).v) == _u(ps.expand_plain(states.v))
    assert fri.grind(11, 6, "cpu") == fri.grind(11, 6)
    assert counts() == before
    out = torch.empty((ev.N_AUX, n), dtype=torch.int64)
    with pytest.raises(TypeError):
        ev.eval_terms_cuda(t, air.aux_rows("cpu"), *chal, out)
    with pytest.raises(TypeError):
        ev.eval_scan_cuda(torch.zeros((2, 1, n), dtype=torch.int64), out)
    with pytest.raises(TypeError):
        ps.expand_cuda(states.v)
    meta = GF(torch.zeros((8, n), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="device"):
        air.aux_columns(meta, chal, [])
    with pytest.raises(ValueError, match="device"):
        rec.expand_perm_states(GF(torch.zeros((2, ps.WIDTH), dtype=torch.int64, device="meta")))
