"""The port's FRI fold and batch injection on the CPU (stark/fri.py:
fold_plain, inject_plain; the card's are csrc/fri.cu,
tests/test_torch_cuda.py) against the JAX package's ``_fold_jit`` over its
``_inv_x_table``, ``_inject_fn`` and ``_scale_fn``; Python models of what
the card computes that the CPU cannot run: the fold kernel's (2x)^-1
schedule (each thread's first factor from the powers w_N^-(2^b) over the
bits of its index, then stepped at the grid stride) and its arithmetic,
and ext_powers' schedule (csrc/ood.cu: a block's first warp squaring the
point up to its tile's base, each thread's first power one product, its
next ones at a stride of POW_THREADS); then whole proofs: fri_prove_batch
over three codewords of two sizes and fri_prove over one, against the
JAX package's, field for field; and chip_smoke.py's model of the calls
the FRI provers make (_fri_plan, whence the card check's shapes) against
their calls. Tolerance: exact equality."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.ext import GF2 as JGF2
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import fri as jfri
from tendermintx_tpu.stark.challenger import Challenger as JChallenger
from tendermintx_tpu_torch.ops import ntt as nttmod
from tendermintx_tpu_torch.ops.ext import GF2, W, ext_add, ext_mul, ext_sub
from tendermintx_tpu_torch.ops.goldilocks import GF, P
from tendermintx_tpu_torch.stark import fri
from tendermintx_tpu_torch.stark import prover as pr
from tendermintx_tpu_torch.stark.challenger import Challenger

EDGES = [0, 1, P - 1, 2**32, P - 2**32]
SHIFTS = [7, 49, 2**32 - 5]
INV2 = pow(2, P - 2, P)


def _rand(n: int, rng) -> np.ndarray:
    """n canonical felts, the edge values first."""
    x = (rng.integers(0, 2**63, size=n).astype(object) * 2 + rng.integers(0, 2, size=n)) % P
    x[: min(len(EDGES), n)] = EDGES[: min(len(EDGES), n)]
    return x


def _ext(n: int, rng) -> tuple[np.ndarray, np.ndarray]:
    return _rand(n, rng), _rand(n, rng)[::-1].copy()


def _point(rng) -> tuple[int, int]:
    return int(rng.integers(0, 2**63)) * 2 % P, int(rng.integers(0, 2**63)) * 2 % P


def _tgf2(v) -> GF2:
    return GF2.from_ints(np.asarray(v[0], dtype=object), np.asarray(v[1], dtype=object))


def _jgf2(v) -> JGF2:
    return JGF2(JGF.from_ints(np.asarray(v[0], dtype=object)), JGF.from_ints(np.asarray(v[1], dtype=object)))


def _ints(g) -> list[tuple[int, int]]:
    c0, c1 = g.to_ints()
    return [(int(a), int(b)) for a, b in zip(np.ravel(c0), np.ravel(c1))]


# ---------------------------------------------------------------------------
# The plain fold and injection against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("log_n", range(4, 13))
def test_fold_plain_matches_jax_fold(log_n, shift):
    rng = np.random.default_rng(log_n * 7 + shift % 1000)
    evals, beta = _ext(1 << log_n, rng), _point(rng)
    tab = jfri._inv_x_table(log_n, shift)
    want = jfri._fold_jit(_jgf2(evals), _jgf2(([beta[0]], [beta[1]])),
                          JGF(jax.numpy.asarray(tab[0]), jax.numpy.asarray(tab[1])))
    assert _ints(fri.fold(_tgf2(evals), beta, shift)) == _ints(want)


@pytest.mark.parametrize("log_n, start, half", [(5, 0, 16), (5, 8, 8), (8, 3, 61), (10, 128, 128), (12, 2047, 1)])
def test_fold_at_an_offset_is_the_slice_of_the_full_fold(log_n, start, half):
    """fold_halves at `start` (a row shard's outputs) equals outputs
    [start, start + half) of the whole layer's fold."""
    rng = np.random.default_rng(start + half)
    N = 1 << log_n
    evals, beta = _tgf2(_ext(N, rng)), _point(rng)
    full = _ints(fri.fold(evals, beta, 7))
    e, o = evals[start : start + half], evals[N // 2 + start : N // 2 + start + half]
    assert _ints(fri.fold_halves(e, o, beta, 7, start, log_n)) == full[start : start + half]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("with_cur", [False, True])
def test_inject_plain_matches_jax_inject(with_cur, k):
    rng = np.random.default_rng(10 * k + with_cur)
    n = 96
    Fs = [_ext(n, rng) for _ in range(k)]
    lams = [_point(rng) for _ in range(k)]
    cur = _ext(n, rng) if with_cur else None
    want = _jgf2(cur) if with_cur else None
    for lam, F in zip(lams, Fs):
        jl = _jgf2(([lam[0]], [lam[1]]))
        want = jfri._scale_fn(jl, _jgf2(F)) if want is None else jfri._inject_fn(want, jl, _jgf2(F))
    got = fri.inject(_tgf2(cur) if with_cur else None, lams, [_tgf2(F) for F in Fs])
    assert _ints(got) == _ints(want)


def test_inject_wants_a_lambda_a_codeword():
    rng = np.random.default_rng(3)
    with pytest.raises(ValueError):
        fri.inject(None, [_point(rng)], [])
    with pytest.raises(ValueError):
        fri.inject(None, [], [_tgf2(_ext(4, rng))])


def test_cpu_tensors_launch_no_fri_kernel():
    rng = np.random.default_rng(4)
    before = (fri.fri_fold_kernel_launches, fri.fri_inject_kernel_launches)
    evals = _tgf2(_ext(64, rng))
    fri.inject(fri.fold(evals, _point(rng), 7), [_point(rng)], [_tgf2(_ext(32, rng))])
    assert (fri.fri_fold_kernel_launches, fri.fri_inject_kernel_launches) == before
    with pytest.raises(TypeError):
        fri.fold_cuda(evals[:32], evals[32:], (1, 2), 7, 0, 6)
    with pytest.raises(TypeError):
        fri.inject_cuda(None, [(1, 2)], [evals])


# ---------------------------------------------------------------------------
# Models of csrc/fri.cu on Python ints
# ---------------------------------------------------------------------------


def _fold_twiddles_model(log_n: int, shift: int, start: int, half: int) -> list[int]:
    """csrc/fri.cu: tmx_fri_fold_kernel's (2 x_i)^-1: thread g < stride
    starts at (2 shift)^-1 times w_N^-(2^b) over the set bits b of start +
    g and steps by w_N^-stride to its outputs g, g + stride, .. (FOLD_RUN
    of them), with the host's constants (fri._fold_constants)."""
    inv2s, wipow, wistride, stride = fri._fold_constants(log_n, shift, half)
    assert stride == -(-half // fri.FOLD_RUN)
    out = [None] * half
    for g in range(stride):
        t = inv2s
        for b in range(32):
            if (start + g) >> b & 1:
                t = t * wipow[b] % P
        for j in range(fri.FOLD_RUN):
            i = g + j * stride
            if i >= half:
                break
            out[i] = t
            t = t * wistride % P
    return out


@pytest.mark.parametrize("log_n, start, half", [(1, 0, 1), (4, 0, 8), (6, 5, 27), (9, 0, 256), (11, 300, 301),
                                                (13, 4095, 1), (14, 1000, 7000)])
@pytest.mark.parametrize("shift", [7, 2**40 + 3])
def test_fold_twiddle_schedule_is_the_inverse_table(log_n, start, half, shift):
    assert _fold_twiddles_model(log_n, shift, start, half) == \
        fri._inv_x_table(log_n, shift)[start : start + half].tolist()


def test_fold_kernel_arithmetic_matches_fold_plain():
    """csrc/fri.cu: an output component is s inv2 + u0 beta0 + u1 W beta1
    (c0) or s inv2 + u0 beta1 + u1 beta0 (c1), s = e + o and u = (e - o)
    t, as one sum reduced once."""
    rng = np.random.default_rng(8)
    log_n, start, half, shift = 9, 17, 200, 7
    e, o, beta = _ext(half, rng), _ext(half, rng), _point(rng)
    tw = _fold_twiddles_model(log_n, shift, start, half)
    wb1 = W * beta[1] % P
    model = []
    for i in range(half):
        s = ext_add((e[0][i], e[1][i]), (o[0][i], o[1][i]))
        d = ext_sub((e[0][i], e[1][i]), (o[0][i], o[1][i]))
        u0, u1 = d[0] * tw[i], d[1] * tw[i]
        model.append(((s[0] * INV2 + u0 * beta[0] + u1 * wb1) % P, (s[1] * INV2 + u0 * beta[1] + u1 * beta[0]) % P))
    assert model == _ints(fri.fold_halves(_tgf2(e), _tgf2(o), beta, shift, start, log_n))


def test_inject_kernel_arithmetic_matches_inject_plain():
    """csrc/fri.cu: each component is one dot of the lambdas' components
    (W lambda_k1 from the host) against the codewords', reduced once,
    then cur added."""
    rng = np.random.default_rng(9)
    n, k = 40, 4
    Fs, lams, cur = [_ext(n, rng) for _ in range(k)], [_point(rng) for _ in range(k)], _ext(n, rng)
    model = []
    for i in range(n):
        c0 = sum(F[0][i] * l[0] + F[1][i] * (W * l[1] % P) for F, l in zip(Fs, lams)) % P
        c1 = sum(F[0][i] * l[1] + F[1][i] * l[0] for F, l in zip(Fs, lams)) % P
        model.append(((cur[0][i] + c0) % P, (cur[1][i] + c1) % P))
    assert model == _ints(fri.inject(_tgf2(cur), lams, [_tgf2(F) for F in Fs]))


# ---------------------------------------------------------------------------
# A model of csrc/ood.cu's ext_powers schedule
# ---------------------------------------------------------------------------


def _ext_powers_model(b: tuple[int, int], n: int, run: int) -> list[tuple[int, int]]:
    """csrc/ood.cu: tmx_ext_powers_kernel for one point. A block's tile is
    POW_THREADS * run powers from base; its first warp squares x = b^(2^q)
    for q < top (the bits of base, at least up to the step's, q = 8),
    multiplying lane l's lp by x at its set bits q < 5 and bb by x at
    base's set bits, and keeps b^32, b^64, b^128 and b^256; warp w's first
    power is bb times those at w's bits; thread t = 32 w + l starts at
    that times lp and steps by b^256."""
    T = pr.POW_THREADS
    out = [None] * n
    for base in range(0, n, T * run):
        top = base.bit_length() if base >> 9 else 9
        x, lp, bb, keep = b, [(1, 0)] * 32, (1, 0), {}
        for q in range(top):
            lp = [ext_mul(v, x) if q < 5 and l >> q & 1 else v for l, v in enumerate(lp)]
            if base >> q & 1:
                bb = ext_mul(bb, x)
            keep[q] = x
            x = ext_mul(x, x)
        warp_base = []
        for w in range(T // 32):
            v = bb
            for bit, q in ((1, 5), (2, 6), (4, 7)):
                if w & bit:
                    v = ext_mul(v, keep[q])
            warp_base.append(v)
        for t in range(T):
            v = ext_mul(warp_base[t // 32], lp[t % 32])
            for j in range(run):
                i = base + j * T + t
                if i >= n:
                    break
                out[i] = v
                v = ext_mul(v, keep[8])
    return out


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, (1 << 15) + 3])
def test_ext_powers_schedule_equals_the_sequential_powers(n):
    rng = np.random.default_rng(n)
    b = _point(rng)
    seq = [(1, 0)]
    for _ in range(n - 1):
        seq.append(ext_mul(seq[-1], b))
    runs = {pr._powers_run(n, k) for k in (1, 2, 8)}
    for run in sorted(runs | {8}):
        assert _ext_powers_model(b, n, run) == seq


def test_ext_powers_runs_at_the_statement_shapes():
    """The run a thread: about POW_BLOCKS blocks, at most POW_MAX_RUN
    powers a thread."""
    assert pr._powers_run(1 << 15, 2) == 1  # Ed25519, WrapAir: 256 blocks
    assert pr._powers_run(1 << 16, 8) == 8  # SHA-256: 256 blocks
    assert pr._powers_run(1 << 15, 8) == 4  # SHA-512, the step's SHA-256
    assert pr._powers_run(1 << 17, 2) == 4  # EvalAir
    assert pr._powers_run(2407, 1) == 1  # Ed25519's alpha
    assert pr._powers_run(1 << 24, 8) == pr.POW_MAX_RUN


# ---------------------------------------------------------------------------
# Whole proofs against the JAX package
# ---------------------------------------------------------------------------

CFG = dict(rate_bits=2, n_queries=6, final_poly_len=8, proof_of_work_bits=3, cap_bits=2)


def _low_degree(log_n: int, rate_bits: int, shift: int, rng) -> tuple[list[int], list[int]]:
    """Evaluations on shift <w_N> (N = 2^log_n) of a random ext polynomial
    of degree < N / 2^rate_bits."""
    N = 1 << log_n
    w = nttmod.primitive_root_of_unity(log_n)
    comps = []
    for _ in range(2):
        coeffs = [int(c) for c in _rand(N >> rate_bits, rng)]
        vals, x = [], shift % P
        for _ in range(N):
            acc = 0
            for c in reversed(coeffs):
                acc = (acc * x + c) % P
            vals.append(acc)
            x = x * w % P
        comps.append(vals)
    return comps[0], comps[1]


def _norm(v):
    """A proof's fields as nested lists of Python ints."""
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return int(v)


def test_batch_fri_proof_equals_jax():
    """Three codewords of two sizes (two at 2^8, one at 2^7 on the squared
    shift): the port's fri_prove_batch gives the JAX package's proof, field
    for field, and it verifies."""
    rng = np.random.default_rng(21)
    shift = 7
    words = [_low_degree(8, 2, shift, rng), _low_degree(7, 2, shift * shift % P, rng),
             _low_degree(8, 2, shift, rng)]
    got = fri.fri_prove_batch([_tgf2(v) for v in words], Challenger(), fri.FriConfig(**CFG), shift)
    want = jfri.fri_prove_batch([_jgf2(v) for v in words], JChallenger(), jfri.FriConfig(**CFG), shift)
    assert _norm(dataclasses.asdict(got)) == _norm(dataclasses.asdict(want))
    host = [list(zip(*v)) for v in words]
    fns = [lambda idx, h=h: h[idx] for h in host]
    assert fri.fri_verify_batch(got, [256, 128, 256], fns, Challenger(), fri.FriConfig(**CFG), shift)


def test_single_fri_proof_equals_jax():
    rng = np.random.default_rng(22)
    word = _low_degree(8, 2, 7, rng)
    got = fri.fri_prove(_tgf2(word), Challenger(), fri.FriConfig(**CFG), 7)
    want = jfri.fri_prove(_jgf2(word), JChallenger(), jfri.FriConfig(**CFG), 7)
    assert _norm(dataclasses.asdict(got)) == _norm(dataclasses.asdict(want))
    assert fri.fri_verify(got, 64, 256, Challenger(), fri.FriConfig(**CFG), 7)


# ---------------------------------------------------------------------------
# chip_smoke.py's model of the FRI's kernel calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes, rate, final, shards", [
    ([1 << 10, 1 << 9, 1 << 9], 3, 8, 1),  # the skip composite's shape
    ([1 << 10, 1 << 9, 1 << 9], 3, 8, 4),  # the same on a 4-shard mesh
    ([1 << 9] * 3, 3, 8, 1),  # the step composite's: three codewords of one size
    ([1 << 9, 1 << 11], 4, 4, 1),  # the wrap's: the larger codeword second
    ([1 << 10], 2, 8, 1),  # a single-statement FRI (hash and leaf bundles)
    ([1 << 10], 2, 8, 4),
    ([1 << 8, 1 << 12, 1 << 8, 1 << 10], 2, 2, 2),
])
def test_chip_smoke_fri_plan_is_the_provers_calls(monkeypatch, sizes, rate, final, shards):
    """chip_smoke.py::_fri_plan, from which the card check derives the
    fold and injection shapes it holds against their plain versions, gives
    exactly the calls fri_prove / fri_prove_batch make, in order, with and
    without a mesh."""
    import chip_smoke

    from tendermintx_tpu_torch.parallel.sharding import LaneMesh

    calls = []
    fold_plain, inject_plain = fri.fold_plain, fri.inject_plain

    def fold(e, o, beta, shift, start, log_n):
        calls.append((log_n, shift % P, start, int(e.shape[0])))
        return fold_plain(e, o, beta, shift, start, log_n)

    def inject(cur, lams, Fs):
        calls.append((int(Fs[0].shape[0]).bit_length() - 1, len(Fs), cur is not None))
        return inject_plain(cur, lams, Fs)

    monkeypatch.setattr(fri, "fold_plain", fold)
    monkeypatch.setattr(fri, "inject_plain", inject)
    cfg = pr.StarkConfig(rate_bits=rate, n_queries=2, final_poly_len=final)
    rng = np.random.default_rng(sum(sizes) + shards)
    words = [_tgf2(_ext(n, rng)) for n in sizes]
    mesh = LaneMesh([torch.device("cpu")] * shards) if shards > 1 else None
    with pytest.raises(RuntimeError, match="final poly"):  # random words: the commit phase runs, the degree fails
        if len(sizes) > 1:
            fri.fri_prove_batch(words, Challenger(), cfg.fri, cfg.shift, mesh=mesh)
        else:
            fri.fri_prove(words[0], Challenger(), cfg.fri, cfg.shift, mesh=mesh)
    folds, injections = chip_smoke._fri_plan(sizes, cfg, shards)
    assert [c for c in calls if len(c) == 4] == folds
    assert [c for c in calls if len(c) == 3] == injections
