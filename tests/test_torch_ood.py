"""The port's OOD evaluation and DEEP inverse tables on the CPU
(stark/prover.py: ext_powers_plain, ood_values, ood_evaluate,
deep_inverses_plain; the card's are csrc/ood.cu,
tests/test_torch_cuda.py) against the JAX package's ``_zpowers_fn``,
``_ood_trace_fn`` over ``_gk_table``, ``_ood_ext_fn`` and
``_deep_invs_fn``, at one, two and eight opening points (the SHA AIRs'),
n = 2^8-2^10, up to 40 rows and the edge values 0, 1, p-1, 2^32 and
p - 2^32. Then Python models of what csrc/ood.cu computes that the CPU
cannot run: the base inversion's addition chain (goldilocks.cuh), the
DEEP inverse tables' schedule (J domain points at a grid stride by every
opening point a thread, their norms inverted together by Montgomery's
trick in prefix form, a planted domain point masked), the powers built by runs (a tile of POW_THREADS * run a block), and ood_eval's launch plan (row
blocks, the threads' rows, slices cut into tiles: every coefficient once)
and its arithmetic: each thread's rows summed in 160-bit accumulators a
slice, the rows of the second operand (the quotient chunks) at the first
point alone, against ood_eval_plain and _ood_ext_fn, and the accumulators
at the longest row the kernel accepts. Tolerance: exact equality."""

import itertools

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


@pytest.mark.parametrize("n_points, log_N, planted", [(1, 8, 3), (2, 9, 3), (8, 10, 3), (3, 7, 127), (8, 6, 0)])
def test_deep_inverses_match_reference(n_points, log_N, planted):
    """(x - z_k)^-1 over the domain, one point a domain point (z1 = 0, z0 =
    shift w^j for the planted column j; its inverse there is 0 on both
    sides, every other column exact) and one with c1 = 0."""
    rng = np.random.default_rng(n_points)
    pts = jprover._domain_points(log_N, SHIFT)
    zks = [_point(rng) for _ in range(n_points)]
    zks[0] = (pts[planted], 0)
    if n_points > 1:
        zks[1] = (P - 1, 0)
    got = pr.deep_inverses(log_N, SHIFT, zks, "cpu")
    lo, hi = jprover._domain_points_limbs(log_N, SHIFT)
    zk = JGF2(JGF.from_ints(np.array([z[0] for z in zks], dtype=object)),
              JGF.from_ints(np.array([z[1] for z in zks], dtype=object)))
    want = jprover._deep_invs_fn(log_N)(JGF(jax.numpy.asarray(lo), jax.numpy.asarray(hi)), zk.c0, zk.c1)
    assert _ints(got) == _jints(want)
    row = _ints(got)[: 1 << log_N]  # the planted point's row
    assert [i for i, v in enumerate(row) if v == (0, 0)] == [planted]


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


def _deep_inverses_model(log_N: int, shift: int, zks: list[tuple[int, int]]) -> list[list[tuple[int, int]]]:
    """csrc/ood.cu: tmx_deep_inverses_kernel<K> on Python ints. Thread i0 <
    stride = ceil(N / J) builds x = shift w^i0 from the powers w^(2^b) and,
    for each pair p = (j, k) of its J domain points (x times w^stride a
    point) and K opening points, the norm n_p = (x_j - z0_k)^2 - W z1_k^2
    (W z1_k^2 a point's constant; 1 past the domain; a zero masked to 1
    and flagged) and the products c_p = n_0 .. n_p; then one inversion of
    c_(B-1) and, from the last pair down, 1 / n_p = acc c_(p-1) with acc
    stepped back by n_p and x by w^-stride, storing (x_j - z0_k) / n_p and
    z1_k / n_p (0 for a flagged pair) at (k, i0 + j stride) on the
    domain."""
    N, K = 1 << log_N, len(zks)
    J = pr._deep_inv_points(K)
    # the launch's constants as deep_inverses_cuda passes them, against
    # the reference's root of unity
    stride, wpow, wstride, wistride = pr._deep_inv_domain(log_N, K)
    w = jntt.primitive_root_of_unity(log_N)
    assert J * K <= pr.DEEP_INV_BATCH and stride == -(-N // J) and (stride - 1) * J < N
    assert list(wpow) == [pow(w, 1 << b, P) for b in range(32)]
    assert wstride == pow(w, stride, P) and wstride * wistride % P == 1
    wz1 = [7 * z1 * z1 % P for _, z1 in zks]
    out = [[None] * N for _ in range(K)]
    for i0 in range(stride):
        x = shift
        for b in range(32):
            if (i0 >> b) & 1:
                x = x * wpow[b] % P
        n, c, zero = [], [], set()
        for j in range(J):
            for k, (z0, _) in enumerate(zks):
                d = (x - z0) % P
                m = (d * d - wz1[k]) % P if i0 + j * stride < N else 1
                if m == 0:
                    zero.add(len(n))
                    m = 1
                n.append(m)
                c.append(c[-1] * m % P if c else m)
            if j + 1 < J:
                x = x * wstride % P
        acc = _inv_chain(c[-1])
        for j in range(J - 1, -1, -1):
            for k in range(K - 1, -1, -1):
                p = j * K + k
                r = acc * c[p - 1] % P if p else acc
                acc = acc * n[p] % P
                if i0 + j * stride < N:
                    d = (x - zks[k][0]) % P
                    out[k][i0 + j * stride] = (0, 0) if p in zero else (d * r % P, zks[k][1] * r % P)
            x = x * wistride % P
    return out


@pytest.mark.parametrize("n_points, log_N", [(1, 0), (1, 1), (1, 7), (2, 1), (2, 8), (8, 2), (8, 7), (3, 5)])
def test_deep_inverse_schedule_equals_the_plain_version(n_points, log_N):
    """The kernel's schedule (J domain points at a grid stride times K
    opening points a thread, norms from the points' constants, one
    prefix-product batch inversion a thread with the zero masked) gives
    deep_inverses_plain's tables: a planted domain point (z1 = 0) is 0 in
    its column alone, J past a domain of 1 or 2 points, a stride below J."""
    N = 1 << log_N
    rng = np.random.default_rng(40 + 8 * n_points + log_N)
    zks = [_point(rng) for _ in range(n_points)]
    planted = (N * 2) // 3
    zks[-1] = (int(pr._domain_points(log_N, SHIFT)[planted]), 0)
    model = _deep_inverses_model(log_N, SHIFT, zks)
    plain = pr.deep_inverses_plain(log_N, SHIFT, zks, "cpu")
    assert _ints(plain) == [v for row in model for v in row]
    assert [i for i, v in enumerate(model[-1]) if v == (0, 0)] == [planted]
    assert all(v != (0, 0) for row in model[:-1] for v in row)


def test_powers_by_runs_equal_the_sequential_powers():
    """csrc/ood.cu: ext_powers, a block's tile of POW_THREADS * run powers
    from base, thread t's run the powers base + j POW_THREADS + t from
    b^base b^t stepped by b^POW_THREADS, at every run and a length that is
    no multiple of a tile (tests/test_torch_fri_fold.py models the
    squaring chain that makes b^base and b^t)."""
    T, n = pr.POW_THREADS, 1000
    b = (123456789, P - 5)
    seq = [(1, 0)]
    for _ in range(n - 1):
        seq.append(ext_mul(seq[-1], b))
    for run in (1, 2, 4, pr.POW_MAX_RUN):
        runs = [None] * n
        for base in range(0, n, T * run):
            for t in range(T):
                x = ext_mul(ext_pow(b, base), ext_pow(b, t))
                for j in range(run):
                    if base + j * T + t < n:
                        runs[base + j * T + t] = x
                    x = ext_mul(x, ext_pow(b, T))
        assert runs == seq
    assert pr._ext_powers_u64(b, 5)[0].tolist() == [v[0] for v in seq[:5]]


def _chain(limbs: list[int], parts: list[int]) -> list[int]:
    """A PTX carry chain: parts added into the 32-bit limbs from the lowest,
    the carry rippled to the top and lost past it, as in the kernel."""
    out, carry = list(limbs), 0
    for i in range(len(out)):
        v = out[i] + (parts[i] if i < len(parts) else 0) + carry
        out[i], carry = v & M32, v >> 32
    return out


def _dot_mac(s: tuple, b: int, t: int) -> tuple:
    """csrc/ood.cu: dot_mac, the diagonal halves b0 t0 + 2^64 b1 t1 into the
    five limbs w, the cross halves b0 t1 and b1 t0 into the three x."""
    w, x = s
    b0, b1, t0, t1 = b & M32, b >> 32, t & M32, t >> 32
    w = _chain(w, [(b0 * t0) & M32, (b0 * t0) >> 32, (b1 * t1) & M32, (b1 * t1) >> 32])
    x = _chain(x, [(b0 * t1) & M32, (b0 * t1) >> 32])
    return w, _chain(x, [(b1 * t0) & M32, (b1 * t0) >> 32])


def _reduce_dot(s: tuple) -> int:
    """csrc/ood.cu: reduce_dot, w + 2^32 x in five limbs, then reduce."""
    w, x = s
    return _reduce([w[0], *_chain(w[1:], x)])


def _reduce(w: list[int]) -> int:
    """goldilocks.cuh: reduce."""
    x = w[0] | (w[1] << 32)
    x = x - P if x >= P else x
    x = (x + w[2] * M32) % P
    x = (x - w[3]) % P
    return (x - (w[4] << 32)) % P


def _value(w: list[int]) -> int:
    return sum(x << (32 * i) for i, x in enumerate(w))


def _limbs(v: int, k: int = 5) -> list[int]:
    return [(v >> (32 * i)) & M32 for i in range(k)]


def _ood_blocks(n_a: int, n_b: int, n: int, n_points: int, threads: int, slice_: int, slices: int):
    """csrc/ood.cu: tmx_ood_kernel's grid. Yields each thread's (slice,
    row, its points, its slice's tiles): row blocks of ceil(rows /
    row_blocks) rows, one a thread; point group z taking points z np ..
    (z + 1) np - 1 of the rows of a, the first group also point 0 of the
    rows of b; the slice [s slice, min((s + 1) slice, n)) in tiles of
    OOD_TJ."""
    rows = n_a + n_b
    row_blocks = -(-rows // threads)
    block_rows = -(-rows // row_blocks)
    groups, np_ = pr._ood_groups(n_points)
    for rb, s, z in itertools.product(range(row_blocks), range(slices), range(groups)):
        r0 = rb * block_rows
        js, je = s * slice_, min((s + 1) * slice_, n)
        tiles = [range(j0, min(j0 + pr.OOD_TJ, je)) for j0 in range(js, je, pr.OOD_TJ)]
        for g in range(r0, min(r0 + block_rows, rows)):
            pts = range(z * np_, min((z + 1) * np_, n_points)) if g < n_a else range(1) if z == 0 else range(0)
            yield s, g, pts, tiles


# each N=128 statement (trace + aux rows, chunk rows, n, points), then two
# small ones, each with a number of resident blocks an SM for the plan
N128_OOD = [(2929, 8, 1 << 15, 2, 7), (170, 6, 1 << 16, 8, 5), (340, 6, 1 << 15, 8, 20), (136, 14, 1 << 15, 2, 20),
            (18, 4, 1 << 17, 2, 20), (3, 2, 203, 2, 2), (300, 0, 1000, 5, 1)]


@pytest.mark.parametrize("n_a, n_b, n, points, blocks_per_sm", N128_OOD)
def test_ood_slices_cover_every_coefficient(n_a, n_b, n, points, blocks_per_sm):
    """The plan ood_eval_cuda launches: each (row, point, coefficient) of
    the function (the rows of b at point 0 alone) in exactly one thread's
    tiles, slices of a multiple of OOD_TJ within the accumulators' bound,
    the threads that leave the fewest idle, and about one wave of resident
    blocks on 132 SMs (at least 90% of it where a slice is 16 tiles or more)."""
    rows, sms = n_a + n_b, 132
    threads, slice_, slices = pr._ood_plan(rows, n, points, sms, blocks_per_sm)
    assert threads in (32, 64, 128) and all(-(-rows // threads) * threads <= -(-rows // t) * t for t in (32, 64, 128))
    assert slice_ % pr.OOD_TJ == 0 and (slices - 1) * slice_ < n <= slices * slice_ <= 65535 * slice_
    assert min(slice_, n) <= pr.OOD_MAX_SLICE
    blocks = -(-rows // threads) * pr._ood_groups(points)[0]
    assert blocks * slices <= sms * blocks_per_sm + blocks
    want = -(-sms * blocks_per_sm // blocks)
    if n >= 16 * pr.OOD_TJ * want:  # slices of 16 tiles or more: rounding costs under 10%
        assert blocks * slices >= 0.9 * sms * blocks_per_sm
    seen = np.zeros((rows, points), dtype=np.int64)
    slice_tiles = {}
    for s, g, pts, tiles in _ood_blocks(n_a, n_b, n, points, threads, slice_, slices):
        seen[g, list(pts)] += 1
        slice_tiles.setdefault(s, tiles)
    assert (seen[:n_a] == slices).all() and (seen[n_a:, 0] == slices).all() and not seen[n_a:, 1:].any()
    assert [j for s in range(slices) for tile in slice_tiles[s] for j in tile] == list(range(n))


def test_ood_eval_model_equals_the_plain_values():
    """tmx_ood_kernel's arithmetic on Python ints at a plan of four slices
    (the last ragged, n odd) and two point groups (5 points: 4 and 1):
    each thread's row summed by the limb chains over its slice's tiles and
    reduced once, the rows of b at the first point alone, partials (a's
    rows at (c, k, row), then b's at (c, row)) added over the slices;
    against ood_eval_plain, and b's chunk values at z against
    _ood_ext_fn."""
    rng = np.random.default_rng(9)
    n, n_a, n_b = 203, 3, 2
    z = (3, 4)
    pts = [z, (P - 1, 2**32), *[_point(rng) for _ in range(3)]]
    K = len(pts)
    coeffs = _rand((n_a + n_b, n), rng)
    powers = pr.ext_powers(pts, n, "cpu")
    pw = [[[int(v) for v in c.v[k].numpy().view(np.uint64)] for k in range(K)] for c in (powers.c0, powers.c1)]
    threads, slice_, slices = pr._ood_plan(n_a + n_b, n, K, 4, 2)
    assert slices == 4 and n % pr.OOD_TJ and pr._ood_groups(K) == (2, 4)
    n_out = 2 * (K * n_a + n_b)
    partial = np.zeros((slices, n_out), dtype=object)
    for s, g, ks, tiles in _ood_blocks(n_a, n_b, n, K, threads, slice_, slices):
        for k in ks:
            for c in range(2):
                acc = ([0] * 5, [0] * 3)
                for tile in tiles:
                    for j in tile:
                        acc = _dot_mac(acc, pw[c][k][j], int(coeffs[g, j]))
                o = (c * K + k) * n_a + g if g < n_a else 2 * K * n_a + c * n_b + g - n_a
                partial[s, o] = _reduce_dot(acc)
    model = [int(v) % P for v in partial.sum(axis=0)]
    plain = pr.ood_eval_plain(GF.from_ints(coeffs[:n_a]), GF.from_ints(coeffs[n_a:]), powers)
    assert plain.numpy().view(np.uint64).astype(object).tolist() == model
    # b's rows as one chunk's c0 and c1 at z: E0 + X E1
    b0 = 2 * K * n_a
    e0, e1 = (model[b0], model[b0 + n_b]), (model[b0 + 1], model[b0 + 1 + n_b])
    chunk = ((e0[0] + 7 * e1[1]) % P, (e0[1] + e1[0]) % P)
    jchunk = JGF2(JGF.from_ints(coeffs[n_a : n_a + 1]), JGF.from_ints(coeffs[n_a + 1 :]))
    assert [chunk] == _jints(jprover._ood_ext_fn(jchunk, jprover._zpowers_fn(_jext(z), n)))


def test_ood_accumulator_holds_at_the_longest_row():
    """A slice's sums at OOD_MAX_SLICE products, every one (p-1)^2: no
    carry leaves w's limb 4 or x's limb 2, w + 2^32 x stays below 2^160 and
    reduces canonically; and the longest row ood_eval_cuda accepts is cut
    into slices no longer than that."""
    smax, top = pr.OOD_MAX_SLICE, P - 1
    b0, b1 = top & M32, top >> 32
    diag, cross = b0 * b0 + (b1 * b1 << 64), 2 * b0 * b1
    acc = _dot_mac((_limbs((smax - 1) * diag), _limbs((smax - 1) * cross, 3)), top, top)
    assert (_value(acc[0]), _value(acc[1])) == (smax * diag, smax * cross)
    assert smax * cross < 1 << 96 and smax * top * top < 1 << 160
    assert _reduce_dot(acc) == smax * top * top % P
    for sms, blocks_per_sm in ((1, 1), (132, 16)):
        threads, slice_, slices = pr._ood_plan(1, pr.OOD_MAX_LENGTH, 1, sms, blocks_per_sm)
        assert slice_ <= pr.OOD_MAX_SLICE and slices <= 65535
