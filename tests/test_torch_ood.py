"""The port's OOD evaluation and DEEP inverse tables on the CPU
(stark/prover.py: ext_powers_plain, ood_values, ood_evaluate,
deep_inverses_plain; the card's are csrc/ood.cu,
tests/test_torch_cuda.py) against the JAX package's ``_zpowers_fn``,
``_ood_trace_fn`` over ``_gk_table``, ``_ood_ext_fn`` and
``_deep_invs_fn``, at one, two and eight opening points (the SHA AIRs'),
n = 2^8-2^10, up to 40 rows and the edge values 0, 1, p-1, 2^32 and
p - 2^32. Then Python models of what csrc/ood.cu computes that the CPU
cannot run: the base inversion's addition chain (goldilocks.cuh), the
powers built by runs (RUN a thread), and ood_eval's slices summed in
160-bit accumulators, at the longest row it accepts. Tolerance: exact
equality."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops import ntt as jntt
from tendermintx_tpu.ops.ext import GF2 as JGF2
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import prover as jprover
from tendermintx_tpu_torch.ops.ext import GF2, ext_mul, ext_pow
from tendermintx_tpu_torch.ops.goldilocks import GF, P
from tendermintx_tpu_torch.stark import prover as pr

EDGES = [0, 1, P - 1, 2**32, P - 2**32]
SHIFT = 7


def _rand(shape, rng):
    """Canonical felts, the edge values first."""
    x = (rng.integers(0, 2**63, size=shape).astype(object) * 2 + rng.integers(0, 2, size=shape)) % P
    flat = x.reshape(-1)
    flat[: min(len(EDGES), flat.size)] = EDGES[: flat.size]
    return x


def _point(rng) -> tuple[int, int]:
    x = (rng.integers(0, 2**63, size=2).astype(object) * 2 + rng.integers(0, 2, size=2)) % P
    return int(x[0]), int(x[1])


def _jext(v: tuple[int, int]) -> JGF2:
    return JGF2(JGF.from_ints(np.array([v[0]], dtype=object)), JGF.from_ints(np.array([v[1]], dtype=object)))


def _ints(g: GF2) -> list[tuple[int, int]]:
    c0, c1 = g.to_ints()
    return [(int(a), int(b)) for a, b in zip(np.ravel(c0), np.ravel(c1))]


def _jints(g: JGF2) -> list[tuple[int, int]]:
    c0, c1 = g.to_ints()
    return [(int(a), int(b)) for a, b in zip(np.ravel(c0), np.ravel(c1))]


@pytest.mark.parametrize("log_n", [8, 10])
def test_ext_powers_plain_matches_zpowers(log_n):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    points = [(P - 1, 0), (0, 1), _point(rng), (2**32, P - 2**32)]
    got = pr.ext_powers(points, n, "cpu")
    assert tuple(got.shape) == (len(points), n)
    for k, pt in enumerate(points):
        want = _jints(jprover._zpowers_fn(_jext(pt), n))
        assert _ints(GF2(got.c0[k], got.c1[k])) == want


@pytest.mark.parametrize(
    "offsets, n_cols, log_n",
    [((0,), 40, 8), ((0, 1), 13, 9), ((0, 1, 2, 3, 4, 5, 6, 7), 9, 10)],
    ids=["one-point", "two-points", "sha-eight"],
)
def test_ood_values_match_reference(offsets, n_cols, log_n):
    """Every row at z g^k for each offset k, against _ood_trace_fn at z
    over _gk_table (ood_values), and ood_evaluate, the prover's one call,
    giving those rows and the quotient chunks at z against _ood_ext_fn."""
    n = 1 << log_n
    rng = np.random.default_rng(100 + n_cols)
    coeffs = _rand((n_cols, n), rng)
    chunks = _rand((6, n), rng)  # rows [c0_0, c1_0, c0_1, c1_1, c0_2, c1_2]
    z = _point(rng)
    g = jntt.primitive_root_of_unity(log_n)
    points = [ext_mul(z, (pow(g, k, P), 0)) for k in offsets]

    zpow = jprover._zpowers_fn(_jext(z), n)
    gk = jprover._np_gf(jprover._gk_table(log_n, tuple(offsets)))
    want = jprover._ood_trace_fn(JGF.from_ints(coeffs), zpow, gk)  # (offsets, C)
    wc0, wc1 = want.to_ints()
    want_rows = [[(int(a), int(b)) for a, b in zip(wc0[k], wc1[k])] for k in range(len(offsets))]
    jchunks = JGF2(JGF.from_ints(chunks[0::2]), JGF.from_ints(chunks[1::2]))
    want_quot = _jints(jprover._ood_ext_fn(jchunks, zpow))

    port_coeffs = GF.from_ints(coeffs)
    port_chunks = GF.from_ints(chunks)
    assert pr.ood_values(port_coeffs, points) == want_rows
    assert pr.ood_evaluate(port_coeffs, port_chunks, points) == (want_rows, want_quot)


@pytest.mark.parametrize("n_points, log_N", [(1, 8), (2, 9), (8, 10)])
def test_deep_inverses_match_reference(n_points, log_N):
    """(x - z_k)^-1 over the domain, one point a domain point (its
    inverse there is 0 on both sides) and one with c1 = 0."""
    rng = np.random.default_rng(n_points)
    pts = jprover._domain_points(log_N, SHIFT)
    zks = [_point(rng) for _ in range(n_points)]
    zks[0] = (pts[3], 0)
    if n_points > 1:
        zks[1] = (P - 1, 0)
    got = pr.deep_inverses(log_N, SHIFT, zks, "cpu")
    lo, hi = jprover._domain_points_limbs(log_N, SHIFT)
    zk = JGF2(JGF.from_ints(np.array([z[0] for z in zks], dtype=object)),
              JGF.from_ints(np.array([z[1] for z in zks], dtype=object)))
    want = jprover._deep_invs_fn(log_N)(JGF(jax.numpy.asarray(lo), jax.numpy.asarray(hi)), zk.c0, zk.c1)
    assert _ints(got) == _jints(want)
    assert _ints(got)[3] == (0, 0)


def test_cpu_tensors_take_the_plain_versions():
    """The CPU never reaches a kernel: no launch is counted, and the CUDA
    wrappers refuse a CPU tensor."""
    before = (pr.ext_powers_kernel_launches, pr.ood_kernel_launches, pr.deep_inverses_kernel_launches)
    rng = np.random.default_rng(3)
    coeffs = GF.from_ints(_rand((3, 16), rng))
    pr.ood_evaluate(coeffs, GF.from_ints(_rand((2, 16), rng)), [(5, 6), (7, 8)])
    pr.ood_values(coeffs, [(5, 6)])
    pr.deep_inverses(6, SHIFT, [(5, 6)], torch.device("cpu"))
    assert (pr.ext_powers_kernel_launches, pr.ood_kernel_launches, pr.deep_inverses_kernel_launches) == before
    powers = pr.ext_powers([(5, 6)], 16, "cpu")
    with pytest.raises(TypeError):
        pr.ood_eval_cuda(coeffs, None, powers)
    with pytest.raises(TypeError):
        pr.ext_powers_cuda([(5, 6)], 16, "cpu")
    with pytest.raises(TypeError):
        pr.deep_inverses_cuda(6, SHIFT, [(5, 6)], "cpu")
    with pytest.raises(ValueError, match="device"):
        pr.deep_inverses(6, SHIFT, [(5, 6)], "meta")


# ---------------------------------------------------------------------------
# Models of csrc/ood.cu on Python ints
# ---------------------------------------------------------------------------

M32 = (1 << 32) - 1


def _inv_chain(a: int) -> int:
    """goldilocks.cuh: inv, the addition chain for a^(p-2)."""
    sqn = lambda x, k: pow(x, 1 << k, P)
    t2 = sqn(a, 1) * a % P
    t4 = sqn(t2, 2) * t2 % P
    t8 = sqn(t4, 4) * t4 % P
    t16 = sqn(t8, 8) * t8 % P
    t24 = sqn(t16, 8) * t8 % P
    t28 = sqn(t24, 4) * t4 % P
    t30 = sqn(t28, 2) * t2 % P
    t31 = sqn(t30, 1) * a % P
    u = sqn(t31, 1)
    return sqn(u, 32) * (u * a % P) % P


def test_inverse_chain_is_the_fermat_power():
    rng = np.random.default_rng(5)
    for a in [*EDGES, P - 2, 2**32 - 1, 7, *[int(v) for v in _rand((64,), rng)]]:
        assert _inv_chain(a) == pow(a, P - 2, P)
        assert _inv_chain(a) * a % P == (a != 0)
    # its exponent: 63 squarings and 10 multiplies
    assert ((2**32 - 2) << 32) + 2**32 - 1 == P - 2


def test_powers_by_runs_equal_the_sequential_powers():
    """csrc/ood.cu: ext_powers, each run of RUN powers from its first by
    square and multiply, a length that is no multiple of RUN."""
    run, n = 16, 1000
    b = (123456789, P - 5)
    seq = [(1, 0)]
    for _ in range(n - 1):
        seq.append(ext_mul(seq[-1], b))
    runs = []
    for i0 in range(0, n, run):
        x = ext_pow(b, i0)
        for _ in range(min(run, n - i0)):
            runs.append(x)
            x = ext_mul(x, b)
    assert runs == seq
    assert pr._ext_powers_u64(b, 5)[0].tolist() == [v[0] for v in seq[:5]]


def _mac(w: list[int], b: int, t: int) -> list[int]:
    """goldilocks.cuh: mac, s += b * t over five 32-bit limbs (the carry
    out of limb 4 is lost, as in the kernel)."""
    w = list(w)
    b0, b1, t0, t1 = b & M32, b >> 32, t & M32, t >> 32

    def chain(start: int, parts: list[int]):
        carry = 0
        for i in range(start, 5):
            v = w[i] + (parts[i - start] if i - start < len(parts) else 0) + carry
            w[i], carry = v & M32, v >> 32

    chain(0, [(b0 * t0) & M32, (b0 * t0) >> 32, (b1 * t1) & M32, (b1 * t1) >> 32])
    chain(1, [(b0 * t1) & M32, (b0 * t1) >> 32])
    chain(1, [(b1 * t0) & M32, (b1 * t0) >> 32])
    return w


def _reduce(w: list[int]) -> int:
    """goldilocks.cuh: reduce."""
    x = w[0] | (w[1] << 32)
    x = x - P if x >= P else x
    x = (x + w[2] * M32) % P
    x = (x - w[3]) % P
    return (x - (w[4] << 32)) % P


def _value(w: list[int]) -> int:
    return sum(x << (32 * i) for i, x in enumerate(w))


def _limbs(v: int) -> list[int]:
    return [(v >> (32 * i)) & M32 for i in range(5)]


@pytest.mark.parametrize("rows, n", [(3, 256), (40, 1024), (176, 1 << 16), (2933, 1 << 15), (18, 1 << 17)])
def test_ood_slices_cover_every_coefficient(rows, n):
    """The slices ood_eval_cuda cuts a row into: a power of two of them,
    each at least a tile long (or the whole row), together the row, and
    the blocks near _OOD_BLOCKS for the N=128 statements."""
    s = pr._ood_slices(rows, n)
    length = -(-n // s)
    assert s & (s - 1) == 0 and s * length >= n > (s - 1) * length
    assert length >= pr._OOD_TJ or s == 1
    if n >= 1 << 15:
        assert -(-rows // pr._OOD_ROWS) * s >= pr._OOD_BLOCKS


def test_ood_eval_model_equals_the_plain_values():
    """ood_eval's arithmetic on Python ints: each slice of each row summed
    by the limb chains and reduced once, the slices' canonical partials
    added; at two points over three rows, against ood_eval_plain."""
    rng = np.random.default_rng(9)
    n, rows, pts = 200, 3, [(3, 4), (P - 1, 2**32)]
    coeffs = _rand((rows, n), rng)
    powers = pr.ext_powers(pts, n, "cpu")
    pw = [[int(v) for v in c.v[k].numpy().view(np.uint64)] for c in (powers.c0, powers.c1) for k in range(2)]
    s = 4
    length = -(-n // s)
    model = np.zeros((2, 2, rows), dtype=object)
    for c in range(2):
        for k in range(2):
            for r in range(rows):
                total = 0
                for j0 in range(0, n, length):
                    w = [0] * 5
                    for j in range(j0, min(j0 + length, n)):
                        w = _mac(w, pw[2 * c + k][j], int(coeffs[r, j]))
                    total = (total + _reduce(w)) % P
                model[c, k, r] = total
    plain = pr.ood_eval_plain(GF.from_ints(coeffs), None, powers)
    assert plain.numpy().view(np.uint64).astype(object).tolist() == model.tolist()


def test_ood_accumulator_holds_at_the_longest_row():
    """A slice's 160-bit sums at OOD_MAX_LENGTH products, every one (p-1)^2
    (the row ood_eval_cuda accepts at its longest, cut into one slice):
    no carry leaves limb 4, the reduction is canonical, and the bound is
    within what 160 bits hold."""
    cmax = pr.OOD_MAX_LENGTH
    top = P - 1
    w = _mac(_limbs((cmax - 1) * top * top), top, top)
    assert _value(w) == cmax * top * top < 1 << 160
    assert _reduce(w) == cmax * top * top % P
    assert ((1 << 160) - 1) // (top * top) >= cmax
