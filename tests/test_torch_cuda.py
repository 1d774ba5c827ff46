"""The hand-written CUDA kernels (the Poseidon permutation, column sponge
and Merkle tree layer; the constraint quotient's tape kernel; the NTT,
inverse NTT and coset LDE; the DEEP composition; the OOD powers,
evaluation and DEEP inverse tables; the LogUp aux columns; the FRI fold
and injection) against
their plain torch versions on the card, at small shapes and with the edge
values 0, 1, p-1, 2^32-1, 2^32 and 2^63 mod p. Exact equality: integer
field arithmetic has no tolerance.

Every test needs an NVIDIA GPU and skips without one (the kernel has no
CPU mode). The file imports no jax, so on a GPU machine it runs without
the JAX package's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu_torch.ops import goldilocks as gl
from tendermintx_tpu_torch.ops import poseidon as ps
from tendermintx_tpu_torch.stark import fri
from tendermintx_tpu_torch.stark.air import Air

P = gl.P
EDGES = [0, 1, P - 1, 2**32 - 1, 2**32, 2**63 % P, P - 2**32]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _felts(shape, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**63, size=shape, dtype=np.uint64) * np.uint64(2)
    u += rng.integers(0, 2, size=shape, dtype=np.uint64)
    u[u >= np.uint64(P)] -= np.uint64(P)
    flat = u.reshape(-1)
    k = min(len(EDGES), flat.size)
    flat[:k] = np.array(EDGES[:k], dtype=np.uint64)
    return gl.tensor_from_u64(u, dev)


@pytest.mark.parametrize("b", [1, 7, 4099, 65536])
def test_poseidon_kernel_matches_plain(dev, b):
    s = _felts((b, ps.WIDTH), b, dev)
    assert torch.equal(ps.permute_cuda(s), ps.permute_plain(s))


def test_poseidon_kernel_matches_host_oracle(dev):
    s = _felts((8, ps.WIDTH), 3, dev)
    got = gl.tensor_to_u64(ps.permute_cuda(s)).tolist()
    assert got == [ps.permute_ints(row) for row in gl.tensor_to_u64(s).tolist()]


def test_cuda_tensors_launch_the_kernel(dev):
    x = _felts((64, ps.WIDTH), 5, dev)
    n_perm = ps.permute_kernel_launches
    ps.permute(gl.GF(x))
    assert ps.permute_kernel_launches == n_perm + 1


def test_grind_on_card_finds_the_host_nonce(dev):
    for seed in (1, 12345, P - 1):
        assert fri.grind(seed, 8, dev) == fri.grind(seed, 8)


@pytest.mark.parametrize("L", [1, 7, 8, 9, 17, 170])
@pytest.mark.parametrize("n", [1, 129])
def test_sponge_cols_kernel_matches_plain(dev, L, n):
    cols = _felts((L, n), 1000 * L + n, dev)
    assert torch.equal(ps.sponge_cols_cuda(cols), ps.hash_no_pad_cols_plain(cols))


def test_sponge_cols_kernel_matches_host_oracle(dev):
    cols = _felts((13, 8), 4, dev)
    got = gl.tensor_to_u64(ps.sponge_cols_cuda(cols)).tolist()
    rows = gl.tensor_to_u64(cols.t().contiguous()).tolist()
    assert got == [ps.hash_ints(r + [0, 0, 0]) for r in rows]


@pytest.mark.parametrize("n", [2, 4, 258, 4096])
def test_merkle_layer_kernel_matches_plain(dev, n):
    d = _felts((n, ps.DIGEST), n, dev)
    assert torch.equal(ps.merkle_layer_cuda(d), ps.merkle_layer_plain(d))


def test_merkle_layer_kernel_matches_host_oracle(dev):
    d = _felts((16, ps.DIGEST), 6, dev)
    got = gl.tensor_to_u64(ps.merkle_layer_cuda(d)).tolist()
    rows = gl.tensor_to_u64(d).tolist()
    assert got == [ps.two_to_one_ints(rows[2 * i], rows[2 * i + 1]) for i in range(8)]


@pytest.mark.parametrize(
    "fn, shape",
    [
        (ps.permute_cuda, (12, 8)),
        (ps.sponge_cols_cuda, (16, 8)),
        (ps.merkle_layer_cuda, (4, 8)),
    ],
)
def test_kernels_reject_non_contiguous(dev, fn, shape):
    x = _felts(shape, 8, dev).t()  # a transposed view
    assert not x.is_contiguous()
    with pytest.raises(ValueError):
        fn(x)


def test_each_entry_counts_its_launches(dev):
    from tendermintx_tpu_torch.ops.merkle import MerkleTree

    before = (ps.permute_kernel_launches, ps.sponge_kernel_launches, ps.layer_kernel_launches)
    tree = MerkleTree.from_leaves(ps.hash_no_pad_cols(gl.GF(_felts((9, 16), 7, dev))))
    assert len(tree.dev_layers) == 5
    parents = ps.merkle_layer(gl.GF(_felts((6, 4), 8, dev)))
    assert parents.shape == (3, 4)
    ps.permute(gl.GF(_felts((3, 12), 9, dev)))
    after = (ps.permute_kernel_launches, ps.sponge_kernel_launches, ps.layer_kernel_launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 5)


def test_row_major_tree_on_card_matches_cpu(dev):
    """MerkleTree.build (the FRI layer trees): the leaf sponge's digests
    feed the tree layer kernel; every layer equals the CPU tree's."""
    from tendermintx_tpu_torch.ops.merkle import MerkleTree

    rows = _felts((64, 2), 10, dev)
    card = MerkleTree.build(gl.GF(rows))
    host = MerkleTree.build(gl.GF(rows.cpu()))
    assert len(card.dev_layers) == len(host.dev_layers) == 7
    for a, b in zip(card.dev_layers, host.dev_layers):
        assert torch.equal(a.v.cpu(), b.v)


# ---------------------------------------------------------------------------
# The NTT kernel (csrc/ntt.cu) and the DEEP kernel (csrc/deep.cu)
# ---------------------------------------------------------------------------


def _ntt_counts():
    from tendermintx_tpu_torch.ops import ntt

    return (ntt.ntt_kernel_launches, ntt.intt_kernel_launches, ntt.lde_kernel_launches)


@pytest.mark.parametrize("rows, log_n", [(1, 0), (3, 1), (5, 2), (7, 3), (1, 10), (3, 11), (2, 13), (1, 17)])
def test_ntt_entries_match_plain(dev, rows, log_n):
    from tendermintx_tpu_torch.ops import ntt

    x = _felts((rows, 1 << log_n), 40 + log_n, dev)
    g = gl.GF(x)
    assert torch.equal(ntt.ntt_cuda(x), ntt.ntt_plain(g).v)
    assert torch.equal(ntt.intt_cuda(x), ntt.intt_plain(g).v)
    pw = ntt.power_tensor(pow(11, P - 2, P), 1 << log_n, dev)
    assert torch.equal(ntt.intt_cuda(x, pw), (ntt.intt_plain(g) * gl.GF(pw)).v)
    for rate_bits in (1, 3, 4):
        assert torch.equal(ntt.coset_lde_cuda(x, rate_bits, 11), ntt.coset_lde_plain(g, rate_bits, 11).v)


def test_ntt_four_step_row_shapes_match_plain(dev):
    """The mesh's four-step NTT: many rows of length 4, and one row of C/4."""
    from tendermintx_tpu_torch.ops import ntt

    x = _felts((1 << 14, 4), 51, dev)
    assert torch.equal(ntt.ntt_cuda(x), ntt.ntt_plain(gl.GF(x)).v)
    y = _felts((1, 1 << 16), 52, dev)
    assert torch.equal(ntt.ntt_cuda(y), ntt.ntt_plain(gl.GF(y)).v)


def test_ntt_entries_count_and_refuse(dev):
    """Each entry counts the pass kernels a call launches (one a pass of
    its plan); a non-contiguous or CPU-typed operand raises, and nothing
    falls back to the plain version."""
    from tendermintx_tpu_torch.ops import ntt

    x = _felts((4, 64), 53, dev)
    before = _ntt_counts()
    ntt.ntt(gl.GF(x))
    ntt.intt(gl.GF(x))
    ntt.coset_lde(gl.GF(x), 2)
    assert _ntt_counts() == tuple(b + 1 for b in before)
    before = _ntt_counts()
    wide = _felts((2, 1 << 11), 54, dev)
    ntt.ntt(gl.GF(wide))
    ntt.intt(gl.GF(wide))
    ntt.coset_lde(gl.GF(wide), 2)
    passes = (len(ntt.ntt_plan(11)), len(ntt.ntt_plan(11)), len(ntt.ntt_plan(13, 2)))
    assert passes == (2, 2, 2)
    assert _ntt_counts() == tuple(b + k for b, k in zip(before, passes))
    before = _ntt_counts()
    strided = x.t().contiguous().t()
    for fn in (ntt.ntt_cuda, ntt.intt_cuda, lambda t: ntt.coset_lde_cuda(t, 2)):
        with pytest.raises(ValueError, match="contiguous"):
            fn(strided)
    with pytest.raises(TypeError):
        ntt.intt_cuda(x, ntt.power_tensor(3, 64, torch.device("cpu")))
    with pytest.raises(TypeError):
        ntt.ntt_cuda(x.cpu())
    assert _ntt_counts() == before


# every transform shape of the N=128 paths on one card (entry, rows,
# log2 n, rate bits): each AIR's trace (and aux) iNTT and LDE and its
# quotient's coset iNTT, a mesh shard's column block, the hash bundles'
# rate-2 LDEs, the four-step NTT's rows and the single-device 2^20 NTT
N128_NTT_SHAPES = [
    ("coset_lde", 2031, 15, 3), ("intt", 2031, 15, 0), ("coset_intt", 2, 18, 0),
    ("coset_lde", 898, 15, 3), ("coset_lde", 508, 15, 3),
    ("coset_lde", 170, 16, 3), ("intt", 170, 16, 0), ("coset_intt", 2, 19, 0),
    ("coset_lde", 340, 15, 3), ("coset_lde", 136, 15, 4),
    ("coset_lde", 18, 17, 4), ("intt", 18, 17, 0), ("coset_intt", 2, 21, 0),
    ("coset_lde", 170, 16, 2), ("coset_lde", 170, 15, 2), ("coset_intt", 2, 17, 0),
    ("ntt", 1 << 16, 2, 0), ("ntt", 1, 18, 0), ("ntt", 1, 20, 0),
]


def _ntt_pair(entry, x, rate):
    """(kernel, plain) of one entry over x, at shift 7 (the configs')."""
    from tendermintx_tpu_torch.ops import ntt

    g = gl.GF(x)
    if entry == "coset_lde":
        return ntt.coset_lde_cuda(x, rate, 7), ntt.coset_lde_plain(g, rate, 7).v
    if entry == "coset_intt":
        pw = ntt.power_tensor(pow(7, P - 2, P), int(x.shape[-1]), x.device)
        return ntt.intt_cuda(x, pw), (ntt.intt_plain(g) * gl.GF(pw)).v
    if entry == "intt":
        return ntt.intt_cuda(x), ntt.intt_plain(g).v
    return ntt.ntt_cuda(x), ntt.ntt_plain(g).v


@pytest.mark.parametrize("entry, rows, log_n, rate", N128_NTT_SHAPES)
def test_ntt_kernel_matches_plain_at_n128_shapes(dev, entry, rows, log_n, rate):
    """Every pass plan of the N=128 paths: (9, 9) at 2^18, (7, 6, 6) at
    2^19, (7, 7, 7) at 2^21, (8, 7) / (8, 8) / (9, 8) inverses, the rate-2
    and rate-4 first passes, 4-point rows."""
    x = _felts((rows, 1 << log_n), 80 + log_n + rows, dev)
    got, want = _ntt_pair(entry, x, rate)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [1, 2, 3, 508, 2031])
@pytest.mark.parametrize("log_n", [0, 1, 3, 6, 11])
def test_ntt_kernel_edge_rows_match_plain(dev, rows, log_n):
    """1- and 2-point rows, row counts that are no multiple of a block's
    lines, every entry and rate."""
    x = _felts((rows, 1 << log_n), 90 + 7 * log_n + rows, dev)
    for entry, rate in (("ntt", 0), ("intt", 0), ("coset_intt", 0), ("coset_lde", 1), ("coset_lde", 3),
                        ("coset_lde", 4)):
        got, want = _ntt_pair(entry, x, rate)
        assert torch.equal(got, want), (entry, rate)


def test_ntt_launches_follow_the_plan(dev):
    """Each call launches one pass kernel a pass of ntt_plan(log N, rate)."""
    from tendermintx_tpu_torch.ops import ntt

    for entry, rows, log_n, rate in (("coset_lde", 5, 15, 3), ("coset_lde", 3, 16, 3), ("intt", 4, 15, 0),
                                     ("coset_intt", 2, 21, 0), ("ntt", 8, 2, 0), ("coset_lde", 2, 0, 2)):
        before = _ntt_counts()
        _ntt_pair(entry, _felts((rows, 1 << log_n), 3, dev), rate)
        i = {"ntt": 0, "intt": 1, "coset_intt": 1, "coset_lde": 2}[entry]
        want = list(before)
        want[i] += len(ntt.ntt_plan(log_n + rate, rate))
        assert _ntt_counts() == tuple(want), (entry, log_n, rate)


def _deep_case(n_main, n_aux, n_chunks, n_groups, rows, seed, dev):
    from tendermintx_tpu_torch.ops.ext import GF2

    f = lambda *shape: gl.GF(_felts(shape, seed + len(shape) * 1000 + shape[0], dev))
    q = f(2 * n_chunks, rows)  # the quotient's row block: rows c0_0, c1_0, c0_1, ...
    invs = f(n_groups, 2 * rows)
    return (
        f(n_main, rows), f(n_aux + 1, rows)[1:] if n_aux else None,
        GF2(q[0::2], q[1::2]), GF2(f(n_groups, n_main + n_aux), f(n_groups + 1, n_main + n_aux)[1:]),
        GF2(f(n_chunks), gl.GF(_felts((n_chunks,), seed + 7, dev))),
        GF2(f(n_groups), gl.GF(_felts((n_groups,), seed + 9, dev))),
        GF2(gl.GF(invs.v[:, :rows]), gl.GF(invs.v[:, rows:])),
    )


@pytest.mark.parametrize(
    "n_main, n_aux, n_chunks, n_groups, rows",
    [(1, 0, 1, 1, 1), (5, 0, 2, 2, 129), (7, 3, 2, 2, 1000), (3, 0, 1, 8, 257), (9, 4, 3, 3, 4096)],
)
def test_deep_kernel_matches_plain(dev, n_main, n_aux, n_chunks, n_groups, rows):
    """The kernel over strided row views (the chunks are the quotient row
    block's even and odd rows; the inverses a slice of wider rows) equals
    the plain version."""
    from tendermintx_tpu_torch.stark import prover as pr

    args = _deep_case(n_main, n_aux, n_chunks, n_groups, rows, 60 + rows, dev)
    before = pr.deep_kernel_launches
    got = pr.deep_composition(*args)
    assert pr.deep_kernel_launches == before + 1
    assert _gf2_equal(got, pr.deep_composition_plain(*args))


@pytest.mark.parametrize(
    "n_main, n_aux, n_chunks, n_groups, rows",
    [(2031, 898, 4, 2, 1 << 18), (170, 0, 3, 8, 1 << 19), (340, 0, 3, 8, 1 << 18), (136, 0, 7, 2, 1 << 19),
     (8, 10, 2, 2, 1 << 21)],
    ids=["ed25519", "sha256", "sha512", "wrap", "eval"],
)
def test_deep_kernel_matches_plain_at_n128_shards(dev, n_main, n_aux, n_chunks, n_groups, rows):
    """Each AIR's one-device shard of the N=128 paths, one launch."""
    from tendermintx_tpu_torch.stark import prover as pr

    args = _deep_case(n_main, n_aux, n_chunks, n_groups, rows, 61, dev)
    before = pr.deep_kernel_launches
    got = pr.deep_cuda(*args)
    assert pr.deep_kernel_launches == before + 1
    assert _gf2_equal(got, pr.deep_composition_plain(*args))


def test_deep_kernel_refuses_columns_beyond_its_accumulator(dev):
    """More trace and aux columns than the 160-bit sums take raise before
    anything is launched (the columns are one zero-stride row)."""
    from tendermintx_tpu_torch.stark import prover as pr

    trace, aux, chunks, bt, bq, g0, invs = _deep_case(4, 2, 2, 2, 64, 73, dev)
    wide = gl.GF(torch.zeros((1, 64), dtype=torch.int64, device=dev).expand(pr.DEEP_MAX_COLUMNS, 64))
    before = pr.deep_kernel_launches
    with pytest.raises(ValueError, match="columns"):
        pr.deep_cuda(wide, aux, chunks, bt, bq, g0, invs)
    assert pr.deep_kernel_launches == before


def test_deep_kernel_refuses_instead_of_falling_back(dev):
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.stark import prover as pr

    trace, aux, chunks, bt, bq, g0, invs = _deep_case(4, 2, 2, 2, 64, 70, dev)
    before = pr.deep_kernel_launches
    with pytest.raises(ValueError, match="unit stride"):
        pr.deep_cuda(gl.GF(trace.v.t().contiguous().t()), aux, chunks, bt, bq, g0, invs)
    with pytest.raises(TypeError):
        pr.deep_cuda(trace, aux, chunks, GF2(gl.GF(bt.c0.v.cpu()), bt.c1), bq, g0, invs)
    with pytest.raises(ValueError, match="opening groups"):
        nine = GF2(gl.GF(_felts((9,), 71, dev)), gl.GF(_felts((9,), 72, dev)))
        pr.deep_cuda(trace, aux, chunks, bt, bq, nine, invs)
    assert pr.deep_kernel_launches == before


# ---------------------------------------------------------------------------
# The OOD evaluation and DEEP inverse tables (csrc/ood.cu)
# ---------------------------------------------------------------------------


def _ood_counts():
    from tendermintx_tpu_torch.stark import prover as pr

    return (pr.ext_powers_kernel_launches, pr.ood_kernel_launches, pr.deep_inverses_kernel_launches)


def _ext_points(k: int, seed: int) -> list[tuple[int, int]]:
    vals = gl.tensor_to_u64(_felts((2 * k,), seed, torch.device("cpu"))).tolist()
    pts = [(int(vals[2 * i]), int(vals[2 * i + 1])) for i in range(k)]
    return [(P - 1, 0), *pts[1:]] if k > 1 else pts


@pytest.mark.parametrize("n_points, n", [(1, 1), (2, 17), (8, 1000), (3, 4096), (8, 1 << 16), (2, 1 << 17),
                                         (2, 1 << 15), (8, 1 << 15), (1, 2407), (1, 18), (5, 257), (4, 513)])
def test_ood_ext_powers_kernel_matches_plain(dev, n_points, n):
    from tendermintx_tpu_torch.stark import prover as pr

    pts = _ext_points(n_points, n)
    before = _ood_counts()
    got = pr.ext_powers(pts, n, dev)
    assert _ood_counts() == (before[0] + 1, before[1], before[2])
    assert _gf2_equal(got, pr.ext_powers_plain(pts, n, dev))


@pytest.mark.parametrize(
    "n_a, n_b, n, n_points",
    [(1, 0, 1, 1), (3, 2, 7, 2), (130, 6, 1000, 8), (300, 0, 4096, 2), (1, 4, 33, 3), (257, 14, 1 << 12, 7)],
)
def test_ood_eval_kernel_matches_plain(dev, n_a, n_b, n, n_points):
    """Rows from a strided view (every other row of a wider block) and a
    second block, against ood_eval_plain."""
    from tendermintx_tpu_torch.stark import prover as pr

    a = gl.GF(_felts((2 * n_a, n), 80 + n, dev)[0::2])
    b = gl.GF(_felts((n_b, n), 81 + n, dev)) if n_b else None
    powers = pr.ext_powers(_ext_points(n_points, n_a), n, dev)
    before = _ood_counts()
    got = pr.ood_eval_cuda(a, b, powers)
    assert _ood_counts() == (before[0], before[1] + 2, before[2])  # its slice and sum kernels
    assert torch.equal(got, pr.ood_eval_plain(a, b, powers))


@pytest.mark.parametrize("chunk_rows", [0, 6])
@pytest.mark.parametrize("n_points", [1, 2, 8])
@pytest.mark.parametrize("rows", [1, 127, 129, 176])
def test_ood_eval_rows_points_and_chunks_match_plain(dev, rows, n_points, chunk_rows):
    """Row counts about the block's 2 x 64 and 2 x 128 rows, 1, 2 and 8
    points, with the chunk rows (taken at the first point alone) and
    without; an odd row length (8-byte copies, a ragged last tile) beside
    an even one."""
    from tendermintx_tpu_torch.stark import prover as pr

    n = 4095 if rows % 2 else 4096
    a = gl.GF(_felts((rows, n), 60 + rows, dev))
    b = gl.GF(_felts((chunk_rows, n), 61 + rows, dev)) if chunk_rows else None
    powers = pr.ext_powers(_ext_points(n_points, rows + chunk_rows), n, dev)
    got = pr.ood_eval_cuda(a, b, powers)
    assert got.shape == (2 * (n_points * rows + chunk_rows),)
    assert torch.equal(got, pr.ood_eval_plain(a, b, powers))


# each AIR of the N=128 paths: (trace + aux rows, chunk rows, log2 n, points)
N128_OOD_SHAPES = [(2929, 8, 15, 2), (170, 6, 16, 8), (340, 6, 15, 8), (136, 14, 15, 2), (18, 4, 17, 2)]


@pytest.mark.parametrize("rows, chunk_rows, log_n, n_points", N128_OOD_SHAPES,
                         ids=["ed25519", "sha256", "sha512", "wrap", "eval"])
def test_ood_kernel_matches_plain_at_n128_shapes(dev, rows, chunk_rows, log_n, n_points):
    from tendermintx_tpu_torch.stark import prover as pr

    n = 1 << log_n
    a = gl.GF(_felts((rows, n), 82, dev))
    b = gl.GF(_felts((chunk_rows, n), 83, dev))
    powers = pr.ext_powers(_ext_points(n_points, rows), n, dev)
    assert torch.equal(pr.ood_eval_cuda(a, b, powers), pr.ood_eval_plain(a, b, powers))


def test_ood_values_on_card_equal_cpu(dev):
    """ood_values and ood_evaluate on the card give the CPU's values; the
    prover's ood_evaluate is one powers launch and one evaluation call
    (two kernel launches)."""
    from tendermintx_tpu_torch.stark import prover as pr

    coeffs = _felts((11, 512), 84, dev)
    chunks = _felts((6, 512), 85, dev)
    pts = _ext_points(8, 86)
    cpu = (gl.GF(coeffs.cpu()), gl.GF(chunks.cpu()))
    before = _ood_counts()
    assert pr.ood_evaluate(gl.GF(coeffs), gl.GF(chunks), pts) == pr.ood_evaluate(*cpu, pts)
    assert _ood_counts() == (before[0] + 1, before[1] + 2, before[2])
    assert pr.ood_values(gl.GF(coeffs), pts[:2]) == pr.ood_values(cpu[0], pts[:2])
    assert _ood_counts() == (before[0] + 2, before[1] + 4, before[2])


@pytest.mark.parametrize("n_points, log_N", [(1, 0), (2, 5), (8, 12), (3, 17), (8, 19), (2, 18)])
def test_ood_deep_inverses_kernel_matches_plain(dev, n_points, log_N):
    """One point a domain point (its inverse there is 0) and one in the
    base field."""
    from tendermintx_tpu_torch.stark import prover as pr

    zks = _ext_points(n_points, log_N)
    zks[0] = (int(pr._domain_points(log_N, 7)[(1 << log_N) // 3]), 0)
    before = _ood_counts()
    got = pr.deep_inverses(log_N, 7, zks, dev)
    assert _ood_counts() == (before[0], before[1], before[2] + 1)
    assert got.c0.v.stride() == (1 << log_N, 1) and got.c1.v.data_ptr() > got.c0.v.data_ptr()
    assert _gf2_equal(got, pr.deep_inverses_plain(log_N, 7, zks, dev))


@pytest.mark.parametrize("log_N", [0, 1, 5, 11])
@pytest.mark.parametrize("n_points", [1, 2, 3, 4, 5, 6, 7, 8])
def test_ood_deep_inverses_planted_point_matches_plain(dev, n_points, log_N):
    """Every instance of the kernel (1-8 points, 32 / K domain points a
    thread) with the last opening point planted on the domain (z1 = 0): 0
    in that column alone, exact elsewhere; at N = 1 and 2 (fewer domain
    points than a thread takes), strides below a block's threads (N =
    2^5), and domains that are no multiple of the points a thread (3, 5, 6
    and 7 opening points)."""
    from tendermintx_tpu_torch.stark import prover as pr

    N = 1 << log_N
    planted = (2 * N) // 3
    zks = _ext_points(n_points, 300 + 8 * log_N + n_points)
    zks[-1] = (int(pr._domain_points(log_N, 7)[planted]), 0)
    got = pr.deep_inverses(log_N, 7, zks, dev)
    assert _gf2_equal(got, pr.deep_inverses_plain(log_N, 7, zks, dev))
    zero = (got.c0.v[-1] == 0) & (got.c1.v[-1] == 0)
    assert zero.nonzero().flatten().tolist() == [planted]


def test_ood_kernels_refuse_instead_of_falling_back(dev):
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.stark import prover as pr

    a = gl.GF(_felts((4, 64), 87, dev))
    powers = pr.ext_powers(_ext_points(2, 88), 64, dev)
    before = _ood_counts()
    with pytest.raises(ValueError, match="points"):
        pr.ext_powers_cuda(_ext_points(9, 89), 64, dev)
    with pytest.raises(ValueError, match="points"):
        pr.deep_inverses_cuda(6, 7, _ext_points(9, 89), dev)
    with pytest.raises(ValueError, match="unit stride"):
        pr.ood_eval_cuda(gl.GF(a.v.t().contiguous().t()), None, powers)
    with pytest.raises(ValueError, match="one contiguous"):
        pr.ood_eval_cuda(a, None, GF2(powers.c0, gl.GF(powers.c1.v.clone())))
    with pytest.raises(TypeError):
        pr.ood_eval_cuda(a, gl.GF(a.v.cpu()), powers)
    with pytest.raises(ValueError):
        pr.ood_eval_cuda(gl.GF(a.v[:, :32]), None, powers)
    assert _ood_counts() == before


# ---------------------------------------------------------------------------
# The FRI fold and injection (csrc/fri.cu)
# ---------------------------------------------------------------------------


def _fri_counts():
    return (fri.fri_fold_kernel_launches, fri.fri_inject_kernel_launches)


def _ext_rows(n: int, seed: int, dev):
    from tendermintx_tpu_torch.ops.ext import GF2

    t = _felts((2, n), seed, dev)
    return GF2(gl.GF(t[0]), gl.GF(t[1]))


@pytest.mark.parametrize("log_n", range(1, 22))
def test_fri_fold_kernel_matches_plain(dev, log_n):
    """Every layer size of the composite's batch FRI (2^19 down) and the
    wrap's (2^21 down), at the first layer's shift and a squared one."""
    N, half = 1 << log_n, 1 << (log_n - 1)
    evals = _ext_rows(N, 300 + log_n, dev)
    (beta,) = _ext_points(1, 400 + log_n)
    for shift in (7, pow(7, 1 << 9, P)):
        before = _fri_counts()
        got = fri.fold(evals, beta, shift)
        assert _fri_counts() == (before[0] + 1, before[1])
        assert _gf2_equal(got, fri.fold_plain(evals[:half], evals[half:], beta, shift, 0, log_n))


@pytest.mark.parametrize("log_n, start, half", [(2, 1, 1), (10, 3, 61), (12, 1000, 1047), (19, 5, (1 << 18) - 5),
                                                (21, (1 << 19) + 7, 99_999)])
def test_fri_fold_kernel_at_an_offset_matches_plain(dev, log_n, start, half):
    e, o = _ext_rows(half, 500 + half, dev), _ext_rows(half, 600 + half, dev)
    (beta,) = _ext_points(1, 700 + half)
    got = fri.fold_halves(e, o, beta, 7, start, log_n)
    assert _gf2_equal(got, fri.fold_plain(e, o, beta, 7, start, log_n))


@pytest.mark.parametrize("n, k, with_cur", [(1 << 19, 1, False), (1 << 18, 2, True), (1 << 18, 3, False), (1, 1, True),
                                            (1000, 3, False), (4097, 4, True), (333, 5, True), (77, 9, False)])
def test_fri_inject_kernel_matches_plain(dev, n, k, with_cur):
    """The skip composite's two injections (2^19 into nothing, two
    codewords at 2^18 into the folded layer), the step composite's three
    codewords at 2^18, ragged lengths and more than INJECT_MAX codewords
    (one launch a group)."""
    Fs = [_ext_rows(n, 800 + 17 * i + n % 97, dev) for i in range(k)]
    lams = _ext_points(k, 900 + n % 89)
    cur = _ext_rows(n, 950, dev) if with_cur else None
    before = _fri_counts()
    got = fri.inject(cur, lams, Fs)
    assert _fri_counts() == (before[0], before[1] + -(-k // fri.INJECT_MAX))
    assert _gf2_equal(got, fri.inject_plain(cur, lams, Fs))


def test_fri_kernels_refuse_instead_of_falling_back(dev):
    from tendermintx_tpu_torch.ops.ext import GF2

    evals = _ext_rows(64, 61, dev)
    strided = GF2(gl.GF(evals.c0.v[::2]), gl.GF(evals.c1.v[::2]))
    before = _fri_counts()
    with pytest.raises(ValueError, match="unit stride"):
        fri.fold_cuda(strided, evals[32:], (1, 2), 7, 0, 6)
    with pytest.raises(ValueError, match="outside"):
        fri.fold_cuda(evals[:32], evals[32:], (1, 2), 7, 1, 6)
    with pytest.raises(TypeError):
        fri.inject_cuda(GF2(gl.GF(evals.c0.v.cpu()), gl.GF(evals.c1.v.cpu())), [(1, 2)], [evals])
    with pytest.raises(ValueError, match="unit stride"):
        fri.inject_cuda(None, [(1, 2)], [strided])
    assert _fri_counts() == before


def test_fri_prove_on_card_equals_cpu(dev):
    """fri_prove_batch over three codewords of two sizes and fri_prove over
    one, on the card (folds and injections through csrc/fri.cu) and on
    the CPU: the same proofs."""
    import dataclasses

    from tendermintx_tpu_torch.ops import ntt as nttmod
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.stark.challenger import Challenger

    cfg = fri.FriConfig(rate_bits=2, n_queries=6, final_poly_len=8, proof_of_work_bits=3, cap_bits=2)
    coeffs = [_felts((2, n // 4), 970 + n, torch.device("cpu")) for n in (1024, 512, 1024)]
    words = []
    for c, shift in zip(coeffs, (7, 49, 7)):
        lde = nttmod.coset_lde(gl.GF(c), 2, shift)
        words.append(GF2(gl.GF(lde.v[0].contiguous()), gl.GF(lde.v[1].contiguous())))
    to = lambda w, d: GF2(gl.GF(w.c0.v.to(d)), gl.GF(w.c1.v.to(d)))
    before = _fri_counts()
    card = fri.fri_prove_batch([to(w, dev) for w in words], Challenger(), cfg, 7)
    folds = fri.fri_fold_kernel_launches - before[0]
    assert (folds, fri.fri_inject_kernel_launches - before[1]) == (fri._batch_layer_count([1024, 512, 1024], cfg), 2)
    host = fri.fri_prove_batch(words, Challenger(), cfg, 7)
    assert dataclasses.asdict(card) == dataclasses.asdict(host)
    single = fri.fri_prove(to(words[0], dev), Challenger(), cfg, 7)
    assert dataclasses.asdict(single) == dataclasses.asdict(fri.fri_prove(words[0], Challenger(), cfg, 7))


# ---------------------------------------------------------------------------
# The LogUp aux columns (csrc/logup.cu)
# ---------------------------------------------------------------------------


def _logup_case(K: int, n: int, bits: int, seed: int, dev):
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.stark.lookup import RangeLookup

    width = RangeLookup(list(range(K)), 0, n, bits).width
    rng = np.random.default_rng(seed)
    n_cols = K + width + 3
    mult_base = int(rng.integers(0, n_cols - width + 1))
    rest = [c for c in range(n_cols) if not mult_base <= c < mult_base + width]
    lk = RangeLookup([int(c) for c in rng.permutation(rest)[:K]], mult_base, n, bits)
    g = _felts((2,), seed + 1, dev)
    return lk, gl.GF(_felts((n_cols, n), seed, dev)), GF2(gl.GF(g[0:1]), gl.GF(g[1:2]))


def _logup_counts():
    from tendermintx_tpu_torch.stark import lookup

    return (lookup.logup_terms_kernel_launches, lookup.logup_scan_kernel_launches)


# (checked columns, rows, table bits): pads 0-3, one or several table
# columns, odd row counts across the scan's runs; the last is Ed25519's at N=128
LOGUP_SHAPES = [(8, 64, 5), (6, 32, 5), (5, 16, 6), (7, 32, 6), (1, 4, 2), (13, 1 << 12, 13), (1788, 1 << 15, 13)]


@pytest.mark.parametrize("K, n, bits", LOGUP_SHAPES)
def test_logup_kernels_match_plain(dev, K, n, bits):
    lk, trace, gamma = _logup_case(K, n, bits, 90 + K, dev)
    before = _logup_counts()
    got = lk.build_aux(trace, gamma)
    assert _logup_counts() == (before[0] + 1, before[1] + 2)  # the scan's tile-sum and scan kernels
    assert torch.equal(got.v, lk.build_aux_plain(trace, gamma).v)
    out = torch.empty_like(got.v)
    partial = lk.logup_terms_cuda(trace, gamma, out)
    rows, want_partial = lk.logup_terms_plain(trace, gamma)
    assert torch.equal(out[: rows.shape[0]], rows) and torch.equal(partial, want_partial)
    lk.logup_scan_cuda(partial, out)
    assert torch.equal(out[rows.shape[0]:], lk.logup_scan_plain(partial))


@pytest.mark.parametrize("n, tiles", [(1, 128), (255, 128), (257, 128), (5000, 3), (33_000, 128), (1 << 15, 128),
                                      ((1 << 18) + 7, 128)])
def test_logup_scan_tiles_match_plain(dev, n, tiles, monkeypatch):
    """The scan alone over random group sums (15 batches and the table
    columns: 1-1,026 groups): one tile, a ragged second tile, tiles of
    several chunks with a ragged last one, 2^15 rows in 128 tiles, and
    2^18 + 7 rows (tiles of 9 chunks); two kernel launches a call."""
    from tendermintx_tpu_torch.stark import lookup
    from tendermintx_tpu_torch.stark.lookup import RangeLookup

    monkeypatch.setattr(lookup, "_SCAN_TILES", tiles)
    lk = RangeLookup(list(range(60)), 60, n, 13)
    partial = _felts((2, lk.logup_groups()[1], n), 400 + n, dev)
    out = _felts((lk.n_aux_cols, n), 401 + n, dev)
    rows = out[:-2].clone()
    before = _logup_counts()
    lk.logup_scan_cuda(partial, out)
    assert _logup_counts() == (before[0], before[1] + 2)
    assert torch.equal(out[-2:], lk.logup_scan_plain(partial)) and torch.equal(out[:-2], rows)


@pytest.mark.parametrize("K", [51, 52, 59, 60])
def test_logup_terms_about_a_run_match_plain(dev, K):
    """15 and 17 terms (13 or 15 batches, pad 1 or 0, and two table
    columns): runs of 8 terms with one left over or one short."""
    lk, trace, gamma = _logup_case(K, 64, 7, 70 + K, dev)
    assert lk.n_batches + lk.width in (15, 17)
    out = torch.empty((lk.n_aux_cols, lk.n_rows), dtype=torch.int64, device=dev)
    partial = lk.logup_terms_cuda(trace, gamma, out)
    rows, want_partial = lk.logup_terms_plain(trace, gamma)
    assert torch.equal(out[: rows.shape[0]], rows) and torch.equal(partial, want_partial)


def test_logup_zero_norms_inside_a_run_on_card(dev):
    """gamma = (v, 0) for a value v in cells of terms 0, 3 and 7 (the
    first, a middle and the last position of the first run's batch
    inversion) and 9 (the second run's), at one row: those terms are 0,
    the rest exact, as in the plain version."""
    from tendermintx_tpu_torch.ops.ext import GF2

    lk, trace, _ = _logup_case(60, 64, 7, 97, dev)
    v = trace.v[lk.checked_cols[13], 9].clone()
    for c in (1, 31, 32 + 5):
        trace.v[lk.checked_cols[c], 9] = v
    gamma = GF2(gl.GF(v.reshape(1)), gl.GF(torch.zeros(1, dtype=torch.int64, device=dev)))
    got = lk.build_aux(trace, gamma)
    assert torch.equal(got.v, lk.build_aux_plain(trace, gamma).v)
    for t in (0, 3, 7, 9):
        assert int(got.v[2 * t, 9]) == 0 and int(got.v[2 * t + 1, 9]) == 0


def test_logup_zero_denominator_on_card(dev):
    """gamma equal to a checked value: the batch's inverse is 0, as on the CPU."""
    from tendermintx_tpu_torch.ops.ext import GF2

    lk, trace, _ = _logup_case(6, 32, 5, 95, dev)
    hit = trace.v[lk.checked_cols[2], 7:8].clone()
    gamma = GF2(gl.GF(hit), gl.GF(torch.zeros(1, dtype=torch.int64, device=dev)))
    got = lk.build_aux(trace, gamma)
    assert torch.equal(got.v, lk.build_aux_plain(trace, gamma).v)
    assert int(got.v[0, 7]) == 0 and int(got.v[1, 7]) == 0


def test_logup_kernels_refuse_instead_of_falling_back(dev):
    from tendermintx_tpu_torch.ops.ext import GF2

    lk, trace, gamma = _logup_case(6, 32, 5, 96, dev)
    out = torch.empty((lk.n_aux_cols, lk.n_rows), dtype=torch.int64, device=dev)
    before = _logup_counts()
    with pytest.raises(ValueError, match="unit stride"):
        lk.logup_terms_cuda(gl.GF(trace.v.t().contiguous().t()), gamma, out)
    with pytest.raises(TypeError):
        lk.logup_terms_cuda(trace, GF2(gl.GF(gamma.c0.v.cpu()), gamma.c1), out)
    with pytest.raises(ValueError, match="output"):
        lk.logup_terms_cuda(trace, gamma, out[1:])
    with pytest.raises(ValueError):
        lk.logup_terms_cuda(gl.GF(trace.v[:2]), gamma, out)
    with pytest.raises(ValueError, match="group sums"):
        lk.logup_scan_cuda(torch.zeros((2, 1, 31), dtype=torch.int64, device=dev), out)
    assert _logup_counts() == before


# ---------------------------------------------------------------------------
# The constraint quotient's tape kernel (csrc/quotient.cu)
# ---------------------------------------------------------------------------


def _quotient_airs() -> dict:
    from tendermintx_tpu_torch.graft_entry import dryrun_air
    from tendermintx_tpu_torch.stark import evalair as ev
    from tendermintx_tpu_torch.stark.ed25519_air import Ed25519Air
    from tendermintx_tpu_torch.stark.poseidon_air import PoseidonChainAir
    from tendermintx_tpu_torch.stark.prover import StarkConfig
    from tendermintx_tpu_torch.stark.recursion import WrapAir, wrap_shape
    from tendermintx_tpu_torch.stark.sha256_air import Sha256Air
    from tendermintx_tpu_torch.stark.sha512_air import Sha512Air

    return {
        "poseidon_chain": PoseidonChainAir,
        "evalair": lambda: ev.EvalAir(ev.build_tape([PoseidonChainAir()])),
        "sha256": lambda: Sha256Air(2),
        "sha512": lambda: Sha512Air(2),
        "ed25519": lambda: Ed25519Air(2),
        "wrap": lambda: WrapAir(
            wrap_shape([Sha256Air(2), Ed25519Air(2), Sha512Air(2)], StarkConfig(), [128, 512, 64])
        ),
        "mix": lambda: dryrun_air(8)[0],
    }


def _quotient_case(air, log_n: int, rate_bits: int, seed: int, dev) -> tuple:
    """A whole random LDE (columns, N) of `air` made on the card, and its
    row inputs: alpha powers, publics, periodic, public and zerofier
    columns (whole (N,) columns), challenges. Full-range canonical felts."""
    from tendermintx_tpu_torch.ops.ext import GF2

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def f(*shape):
        x = torch.randint(0, 2**63 - 1, shape, dtype=torch.int64, device=dev, generator=gen)
        x.mul_(2).add_(torch.randint(0, 2, shape, dtype=torch.int64, device=dev, generator=gen))
        return gl.GF(gl._canon(x))

    N = 1 << (log_n + rate_bits)
    K = air.n_constraints
    lde = f(air.n_cols + air.n_aux_cols, N)
    lde.v[0, : len(EDGES)] = gl.tensor_from_u64(np.array(EDGES, dtype=np.uint64), dev)
    vecs = (
        GF2(f(K), f(K)), f(air.n_public),
        tuple(f(N) for _ in air.periodic_columns()), tuple(f(N) for _ in range(air.n_public_cols)),
        tuple(f(N) for _ in range(4)), f(2 * air.n_challenges),
    )
    return lde, vecs


def _shards_of(air, lde, mesh, log_n: int, rate_bits: int) -> list:
    from tendermintx_tpu_torch.parallel import prover as shp

    trace = [gl.GF(b.contiguous()) for b in mesh.split(lde.v[: air.n_cols], 1)]
    aux = [gl.GF(b.contiguous()) for b in mesh.split(lde.v[air.n_cols :], 1)] if air.n_aux_cols else None
    return shp.lde_shards_fn(mesh, air, log_n, rate_bits)(trace, aux)


def _shard_rows(vecs: tuple, r0: int, r1: int) -> tuple:
    """The row inputs with rows [r0, r1) of each whole column, as
    parallel/prover.py::sharded_quotient_fn hands them to a shard."""
    alpha, pub, periodic, public_cols, zinvs, chal = vecs
    cut = lambda group: tuple(gl.GF(v.v[r0:r1]) for v in group)
    return alpha, pub, cut(periodic), cut(public_cols), cut(zinvs), chal


def _gf2_equal(a, b) -> bool:
    return torch.equal(a.c0.v, b.c0.v) and torch.equal(a.c1.v, b.c1.v)


def _gf2_cat(parts):
    from tendermintx_tpu_torch.ops.ext import GF2

    return GF2.concatenate([GF2(gl.GF(p.c0.v.cpu()), gl.GF(p.c1.v.cpu())) for p in parts], axis=0)


@pytest.mark.parametrize("name", ["poseidon_chain", "evalair", "sha256", "sha512", "ed25519", "wrap", "mix"])
def test_quotient_kernel_matches_plain(dev, name):
    """One launch over a one-device shard of 1,024 LDE rows (its last rows
    read the halo: the block's own leading rows) equals the tape's plain
    twin and the DeviceAlgebra evaluation of the gathered frame on the
    same card tensors; the prover's sharded quotient on four shards of
    cuda:0 (four launches) equals it and the CPU mesh's plain path."""
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.parallel import prover as shp
    from tendermintx_tpu_torch.parallel.sharding import LaneMesh
    from tendermintx_tpu_torch.stark import prover as pr
    from tendermintx_tpu_torch.stark import quotient_tape as qtm

    air = _quotient_airs()[name]()
    log_n, rate_bits = 9, 1
    N = 1 << (log_n + rate_bits)
    lde, vecs = _quotient_case(air, log_n, rate_bits, len(name), dev)
    (shard,) = _shards_of(air, lde, LaneMesh([dev]), log_n, rate_bits)
    before = qtm.quotient_kernel_launches
    got = qtm.quotient_cuda(air, shard, *vecs)
    assert qtm.quotient_kernel_launches == before + 1
    assert _gf2_equal(got, qtm.execute_plain(qtm.quotient_tape(air), shard, *vecs))
    stacked = qtm.gather_frame(shard, air.frame_offsets, 0, N)
    assert _gf2_equal(got, pr._eval_quotient_plain(air, stacked, *vecs, N))
    trace, aux = lde.v[: air.n_cols], lde.v[air.n_cols :] if air.n_aux_cols else None
    outs = []
    for mesh in (LaneMesh([dev] * 4), LaneMesh([torch.device("cpu")] * 4)):
        d0 = mesh.devices[0]
        blocks = lambda x: [gl.GF(b.contiguous()) for b in mesh.split(x.to(d0), 1)]
        move = lambda group: tuple(gl.GF(v.v.to(d0)) for v in group)
        alpha, pub, periodic, public_cols, zinvs, chal = vecs
        before = qtm.quotient_kernel_launches
        out = shp.sharded_quotient_fn(mesh, air, log_n, rate_bits)(
            blocks(trace), None if aux is None else blocks(aux),
            GF2(gl.GF(alpha.c0.v.to(d0)), gl.GF(alpha.c1.v.to(d0))), gl.GF(pub.v.to(d0)),
            move(periodic), move(public_cols), move(zinvs), gl.GF(chal.v.to(d0)),
        )
        assert qtm.quotient_kernel_launches == before + (4 if d0.type == "cuda" else 0)
        outs.append(_gf2_cat(out))
    assert _gf2_equal(outs[0], outs[1])
    assert _gf2_equal(outs[0], _gf2_cat([got]))


@pytest.mark.parametrize("name", ["ed25519", "sha256", "sha512", "wrap", "evalair", "poseidon_chain"])
def test_quotient_kernel_matches_twin_at_n128_shards(dev, name):
    """At each AIR's N=128 shape (chip_smoke.py::_quotient_airs): one
    launch over the whole one-device shard equals the plain twin on the
    card, exactly; four shards on cuda:0 (four launches, halos from the
    neighbours, the last one's from shard 0) give the same rows, and the
    twin over the last shard's final rows (read through its halo) equals
    them."""
    import chip_smoke
    from tendermintx_tpu_torch.parallel.sharding import LaneMesh
    from tendermintx_tpu_torch.stark import quotient_tape as qtm

    air, N, rate_bits = next((a, n, r) for nm, a, n, r in chip_smoke._quotient_airs() if nm == name)
    log_n = N.bit_length() - 1 - rate_bits
    lde, vecs = _quotient_case(air, log_n, rate_bits, 100 + len(name), dev)
    qt = qtm.quotient_tape(air)
    assert qt.n_slots <= 256
    (shard,) = _shards_of(air, lde, LaneMesh([dev]), log_n, rate_bits)
    before = qtm.quotient_kernel_launches
    got = qtm.quotient_cuda(air, shard, *vecs)
    assert qtm.quotient_kernel_launches == before + 1
    assert _gf2_equal(got, qtm.execute_plain(qt, shard, *vecs))
    shards = _shards_of(air, lde, LaneMesh([dev] * 4), log_n, rate_bits)
    nb = N // 4
    before = qtm.quotient_kernel_launches
    parts = [qtm.quotient_cuda(air, s, *_shard_rows(vecs, d * nb, (d + 1) * nb)) for d, s in enumerate(shards)]
    assert qtm.quotient_kernel_launches == before + 4
    assert _gf2_equal(_gf2_cat(parts), _gf2_cat([got]))
    tail = qtm.execute_plain(qt, shards[3], *_shard_rows(vecs, 3 * nb, N), (nb - 1024, nb))
    assert torch.equal(tail.c0.v, parts[3].c0.v[nb - 1024 :])
    assert torch.equal(tail.c1.v, parts[3].c1.v[nb - 1024 :])


def test_quotient_kernel_row_range_is_a_slice_of_the_shard(dev):
    """A launch over rows [r0, r1) of a shard (chip_smoke.py times the
    CPU path's row block this way) gives those rows of the whole-shard
    launch."""
    from tendermintx_tpu_torch.parallel.sharding import LaneMesh
    from tendermintx_tpu_torch.stark import quotient_tape as qtm

    air = _quotient_airs()["sha256"]()
    lde, vecs = _quotient_case(air, 9, 1, 3, dev)
    (shard,) = _shards_of(air, lde, LaneMesh([dev]), 9, 1)
    whole = qtm.quotient_cuda(air, shard, *vecs)
    for r0, r1 in ((0, 1), (5, 300), (1000, 1024), (7, 7)):
        part = qtm.quotient_cuda(air, shard, *vecs, (r0, r1))
        assert torch.equal(part.c0.v, whole.c0.v[r0:r1]) and torch.equal(part.c1.v, whole.c1.v[r0:r1])


def test_quotient_tape_beyond_shared_memory_raises(dev, monkeypatch):
    """Every value slot lives in shared memory and there is no spill tier:
    a tape whose slots do not fit a block raises and launches nothing."""
    from tendermintx_tpu_torch.parallel.sharding import LaneMesh
    from tendermintx_tpu_torch.stark import quotient_tape as qtm

    air = _quotient_airs()["sha256"]()
    lde, vecs = _quotient_case(air, 9, 1, 4, dev)
    (shard,) = _shards_of(air, lde, LaneMesh([dev]), 9, 1)
    qt = qtm.quotient_tape(air)
    monkeypatch.setattr(qtm, "SMEM_PER_BLOCK", qtm.shared_bytes(qt.row_words, qt.n_uniform, 32) - 8)
    before = qtm.quotient_kernel_launches
    with pytest.raises(ValueError, match="shared memory"):
        qtm.quotient_cuda(air, shard, *vecs)
    assert qtm.quotient_kernel_launches == before


def test_quotient_on_card_raises_instead_of_falling_back(dev):
    """The card's quotient launches the kernel or raises: a
    non-contiguous LDE block, an operand on another device, or a gathered
    frame handed to _eval_quotient_core is refused, and nothing runs the
    plain version in its place."""
    import dataclasses

    from tendermintx_tpu_torch.parallel.sharding import LaneMesh
    from tendermintx_tpu_torch.stark import prover as pr
    from tendermintx_tpu_torch.stark import quotient_tape as qtm

    air = _quotient_airs()["poseidon_chain"]()
    lde, vecs = _quotient_case(air, 7, 1, 5, dev)
    (shard,) = _shards_of(air, lde, LaneMesh([dev]), 7, 1)
    before = qtm.quotient_kernel_launches
    strided = gl.GF(shard.trace.v.t().contiguous().t())
    assert not strided.v.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        qtm.quotient_cuda(air, dataclasses.replace(shard, trace=strided), *vecs)
    alpha, pub, *tail = vecs
    with pytest.raises(TypeError):
        qtm.quotient_cuda(air, shard, alpha, gl.GF(pub.v.cpu()), *tail)
    N = int(lde.shape[1])
    with pytest.raises(ValueError, match="quotient_cuda"):
        pr._eval_quotient_core(air, qtm.gather_frame(shard, air.frame_offsets, 0, N), *vecs, N)
    assert qtm.quotient_kernel_launches == before


def test_composite_on_card_equals_cpu_with_one_quotient_launch_per_statement(dev, tmp_path, monkeypatch):
    """The N=4 skip composite at the parity config proven on the card is
    the CPU's proof byte for byte; on one device the card's quotient is
    one launch per statement, DEEP one, OOD and the DEEP inverses one each
    (and two powers launches: alpha's and the opening points'), the LogUp
    terms kernel once and the scan's two kernels for the Ed25519 statement, and each NTT entry launches the
    passes of ntt_plan for every transform the prove asks of it. The CPU
    prove launches nothing."""
    from tendermintx_tpu_torch.circuits.composite import prove_skip_composite
    from tendermintx_tpu_torch.ops import ntt
    from tendermintx_tpu_torch.stark import prover as pr
    from tendermintx_tpu_torch.stark import quotient_tape as qtm
    from tendermintx_tpu_torch.stark.prover import StarkConfig

    chain, f = _chain(tmp_path, n_validators=4, heights=5)
    trusted = chain.headers[1].hash()
    inputs = f.get_skip_inputs(1, trusted, 5, max_validators=4)
    cfg = StarkConfig(rate_bits=3, n_queries=6, final_poly_len=64, proof_of_work_bits=4)
    planned = [0, 0, 0]
    launch = ntt._launch

    def recorded(entry, x, rate_bits=0, *args, **kwargs):
        log_n = int(x.shape[-1]).bit_length() - 1
        rate = rate_bits if entry == "coset_lde" else 0
        if x.numel():
            planned[("ntt", "intt", "coset_lde").index(entry)] += len(ntt.ntt_plan(log_n + rate, rate))
        return launch(entry, x, rate_bits, *args, **kwargs)

    monkeypatch.setattr(ntt, "_launch", recorded)
    before = qtm.quotient_kernel_launches
    deep_before, ntt_before = pr.deep_kernel_launches, _ntt_counts()
    ood_before, logup_before = _ood_counts(), _logup_counts()
    card = prove_skip_composite(1, trusted, 5, inputs, cfg, device=dev)
    assert qtm.quotient_kernel_launches == before + 3
    # one DEEP launch a statement; the LDEs and the quotient's iNTT on the card
    assert pr.deep_kernel_launches == deep_before + 3
    assert _ood_counts() == (ood_before[0] + 6, ood_before[1] + 6, ood_before[2] + 3)
    assert _logup_counts() == (logup_before[0] + 1, logup_before[1] + 2)
    ntt_after = _ntt_counts()
    assert ntt_after[1] > ntt_before[1] and ntt_after[2] > ntt_before[2]
    assert tuple(a - b for a, b in zip(ntt_after, ntt_before)) == tuple(planned)
    launched = (qtm.quotient_kernel_launches, pr.deep_kernel_launches, _ntt_counts(), _ood_counts(),
                _logup_counts())
    host = prove_skip_composite(1, trusted, 5, inputs, cfg, device="cpu")
    assert card.to_bytes() == host.to_bytes()
    assert (qtm.quotient_kernel_launches, pr.deep_kernel_launches, _ntt_counts(), _ood_counts(),
            _logup_counts()) == launched


# ---------------------------------------------------------------------------
# Witness programs and the prover service on the card
# ---------------------------------------------------------------------------


def _chain(tmp_path, n_validators=6, heights=5):
    from tendermintx_tpu_torch.inputs.fetcher import InputDataFetcher, InputDataMode
    from tendermintx_tpu_torch.inputs.testchain import TestChain

    chain = TestChain(n_validators=n_validators, chain_id="cuda-chain")
    for _ in range(heights):
        chain.extend()
    chain.write_fixtures(str(tmp_path))
    return chain, InputDataFetcher(fixture_path=str(tmp_path), mode=InputDataMode.FIXTURE)


def test_hashes_on_card_match_cpu(dev):
    from tendermintx_tpu_torch.ops import sha256, sha512

    rng = np.random.default_rng(4)
    msgs = [rng.bytes(int(n)) for n in (0, 3, 55, 64, 119, 200)]
    assert sha256.sha256_many(msgs, device=dev) == sha256.sha256_many(msgs, device="cpu")
    assert sha512.sha512_many(msgs, device=dev) == sha512.sha512_many(msgs, device="cpu")


def test_ladder_and_binding_on_card_match_cpu(dev, tmp_path):
    from tendermintx_tpu_torch.inputs.conversion import get_validator_data_from_block, signature_lanes
    from tendermintx_tpu_torch.ops import ed25519 as ed

    chain, _ = _chain(tmp_path, heights=1)
    lanes = get_validator_data_from_block(chain.val_set, chain.commits[2], chain.chain_id, 8)
    pks, msgs, sigs = (list(x) for x in signature_lanes(lanes))
    msgs[1] = msgs[1][:-1] + bytes([msgs[1][-1] ^ 1])  # one failing lane
    card = ed.verify_batch_bound(pks, msgs, sigs, device=dev)
    host = ed.verify_batch_bound(pks, msgs, sigs, device="cpu")
    assert card.tolist() == host.tolist() and not card[1] and card[0]


def test_skip_and_step_programs_on_card_match_cpu(dev, tmp_path):
    from tendermintx_tpu_torch.circuits.config import TendermintConfig
    from tendermintx_tpu_torch.circuits.skip import SkipCircuit, encode_skip_input
    from tendermintx_tpu_torch.circuits.step import StepCircuit, encode_step_input

    chain, f = _chain(tmp_path)
    cfg = TendermintConfig(chain_id="cuda-chain")
    skip_in = encode_skip_input(1, chain.headers[1].hash(), 5)
    step_in = encode_step_input(2, chain.headers[2].hash())
    for circuit, inp in ((SkipCircuit, skip_in), (StepCircuit, step_in)):
        card = circuit(8, cfg, f, device=dev).run(inp)
        assert card == circuit(8, cfg, f, device="cpu").run(inp)
    bad = SkipCircuit(8, TendermintConfig(chain_id="other"), f, device=dev)
    with pytest.raises(ValueError, match="skip verification failed"):
        bad.run(skip_in)


def test_service_round_trip_on_card(dev, tmp_path, monkeypatch):
    """A step request through the HTTP service, proven on the card at a
    100-bit config; the proof verifies on the host and equals the CPU's."""
    from tendermintx_tpu_torch.circuits.composite import (
        CompositeProof,
        prove_step_composite,
        runtime_configs,
        verify_step_composite,
    )
    from tendermintx_tpu_torch.circuits.step import encode_step_input
    from tendermintx_tpu_torch.runtime.service import ProverClient, ProverService

    monkeypatch.setenv("TMX_FRI_CONFIG", "2,42,16,16")
    chain, f = _chain(tmp_path, n_validators=4, heights=3)
    svc = ProverService(allowed_fixture_roots=[str(tmp_path)], device=dev)
    svc.start()
    try:
        client = ProverClient(svc.url)
        rid = client.submit("step", "cuda-chain", "0x" + encode_step_input(2, chain.headers[2].hash()).hex(),
                            max_validators=4, fixture_path=str(tmp_path))
        out = client.wait(rid, timeout=600, poll=0.2)
    finally:
        svc.stop()
    assert out["output"] == "0x" + chain.headers[3].hash().hex()
    proof = CompositeProof.from_dict(out["proof"])
    base, wrap, bits = runtime_configs()
    assert verify_step_composite(proof, "cuda-chain", config=base, min_security_bits=bits) is not None
    inputs = f.get_step_inputs(2, chain.headers[2].hash(), 4)
    host = prove_step_composite(2, chain.headers[2].hash(), inputs, base, device="cpu")
    assert proof.to_bytes() == host.to_bytes()


# ---------------------------------------------------------------------------
# The lane mesh on the card: four shards on cuda:0, each piece against
# its run on a CPU mesh of four shards
# ---------------------------------------------------------------------------


def _meshes(dev):
    from tendermintx_tpu_torch.parallel.sharding import LaneMesh

    return LaneMesh([dev] * 4), LaneMesh([torch.device("cpu")] * 4)


def test_sharded_poseidon_and_sha256_on_card_match_cpu(dev):
    from tendermintx_tpu_torch.ops import sha256
    from tendermintx_tpu_torch.parallel.sharding import sharded_poseidon_throughput, sharded_sha256

    card, host = _meshes(dev)
    states = _felts((4096, 12), 21, dev)
    before = ps.permute_kernel_launches
    got = sharded_poseidon_throughput(card)(gl.GF(states))
    assert ps.permute_kernel_launches == before + 4
    assert torch.equal(got.v.cpu(), sharded_poseidon_throughput(host)(gl.GF(states.cpu())).v)
    blocks, n_active = sha256.pad_messages([bytes([i]) * (5 + 11 * i) for i in range(8)])
    assert torch.equal(sharded_sha256(card)(blocks.to(dev), n_active.to(dev)).cpu(),
                       sharded_sha256(host)(blocks, n_active))


def test_sharded_lde_leaves_fold_and_ntt_on_card_match_cpu(dev):
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.parallel import prover as shp

    card, host = _meshes(dev)
    cols = _felts((13, 256), 22, dev)
    outs = []
    for mesh, c in ((card, cols), (host, cols.cpu())):
        coeffs, blocks = shp.sharded_trace_lde(mesh, 2, 7)(gl.GF(c))
        rows = shp.columns_to_rows(mesh, blocks, 13)
        before = ps.sponge_kernel_launches
        leaves = shp.sharded_leaf_hashes(mesh)(rows)
        if mesh is card:
            assert ps.sponge_kernel_launches == before + 4
        outs.append([coeffs.v, mesh.gather([r.v for r in rows], dim=1), leaves.v])
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)
    e0, e1 = _felts((1024,), 23, dev), _felts((1024,), 24, dev)
    (beta,) = _ext_points(1, 25)
    folded = []
    for mesh, d in ((card, dev), (host, torch.device("cpu"))):
        blocks = [GF2(gl.GF(a), gl.GF(b)) for a, b in zip(mesh.split(e0.to(d)), mesh.split(e1.to(d)))]
        before = fri.fri_fold_kernel_launches
        out = shp.sharded_fold_fn(mesh)(blocks, beta, 7)
        assert fri.fri_fold_kernel_launches == before + (4 if mesh is card else 0)
        folded.append(torch.cat([mesh.gather([o.c0.v for o in out]), mesh.gather([o.c1.v for o in out])]))
        x = e0.to(d)
        ntt = shp.sharded_ntt_fn(mesh, 10)([gl.GF(b) for b in mesh.split(x)])
        folded.append(mesh.gather([o.v for o in ntt]))
    assert torch.equal(folded[0].cpu(), folded[2]) and torch.equal(folded[1].cpu(), folded[3])


def test_sharded_prove_on_card_equals_cpu_and_dryrun(dev):
    """prove(mesh=) of a 2-block Sha256Air (the quotient's halo exchange,
    sharded DEEP and folds) on four card shards gives the CPU's single
    proof, with one sponge launch per shard for each column-major tree;
    the dry run passes on the card."""
    from tendermintx_tpu_torch.graft_entry import dryrun_multichip
    from tendermintx_tpu_torch.stark.prover import StarkConfig, prove
    from tendermintx_tpu_torch.stark.serialize import stark_proof_to_dict
    from tendermintx_tpu_torch.stark.sha256_air import Sha256Air, schedule_messages, sha256_batch_trace
    from tendermintx_tpu_torch.stark.verifier import verify

    card, _ = _meshes(dev)
    blocks, chain_flags, _ = schedule_messages([b"ab", b"x" * 40])
    trace, publics = sha256_batch_trace(blocks, chain_flags)
    air = Sha256Air(len(blocks))
    cfg = StarkConfig(rate_bits=2, n_queries=8, final_poly_len=8, proof_of_work_bits=4)
    before = ps.sponge_kernel_launches
    proof = prove(air, trace.to(dev), publics, cfg, mesh=card)
    assert ps.sponge_kernel_launches == before + 4 * 2  # trace and quotient trees
    assert stark_proof_to_dict(proof) == stark_proof_to_dict(prove(air, trace, publics, cfg))
    assert verify(air, proof, cfg)
    dryrun_multichip(4, [dev] * 4)


def test_device_challenger_on_card_matches_host(dev):
    """The device transcript samples what the host challenger samples,
    its sponge through the permutation kernel."""
    from tendermintx_tpu_torch.stark.challenger import Challenger, DeviceChallenger

    host = Challenger()
    host.observe_elements([3, 1, 4, 1, 5])
    dc = DeviceChallenger(host, dev)
    rows = _felts((16, 4), 26, dev)
    before = ps.permute_kernel_launches
    got = dc.observe_rows_sample(gl.GF(rows), 3)
    assert ps.permute_kernel_launches > before
    host.observe_elements(int(v) for v in gl.to_int_array(rows).reshape(-1))
    assert [int(v) for v in gl.to_int_array(got)] == [host.sample() for _ in range(3)]
    more = dc.sample_many(9)
    assert [int(v) for v in gl.to_int_array(more)] == [host.sample() for _ in range(9)]


def test_hash_bundle_on_card_equals_cpu(dev, tmp_path):
    """The N=4 skip hash bundle proven on the card is the CPU's, byte for
    byte, and every Poseidon entry is launched by the card's prove."""
    import json

    from tendermintx_tpu_torch.circuits.hashing import prove_skip_hashes, verify_skip_hashes
    from tendermintx_tpu_torch.inputs.fetcher import InputDataFetcher, InputDataMode
    from tendermintx_tpu_torch.inputs.testchain import TestChain
    from tendermintx_tpu_torch.stark.prover import StarkConfig

    chain = TestChain(n_validators=4, chain_id="hash-chain")
    for _ in range(4):
        chain.extend()
    chain.write_fixtures(str(tmp_path))
    f = InputDataFetcher(fixture_path=str(tmp_path), mode=InputDataMode.FIXTURE)
    trusted, target = chain.headers[1].hash(), chain.headers[5].hash()
    inputs = f.get_skip_inputs(1, trusted, 5, max_validators=8)
    cfg = StarkConfig(rate_bits=2, n_queries=4, final_poly_len=8, proof_of_work_bits=4)
    before = (ps.permute_kernel_launches, ps.sponge_kernel_launches, ps.layer_kernel_launches)
    card = prove_skip_hashes(inputs, cfg, device=dev)
    after = (ps.permute_kernel_launches, ps.sponge_kernel_launches, ps.layer_kernel_launches)
    assert all(a > b for a, b in zip(after, before))
    cpu = prove_skip_hashes(inputs, cfg, device="cpu")
    assert json.dumps(card.to_dict(), sort_keys=True) == json.dumps(cpu.to_dict(), sort_keys=True)
    assert verify_skip_hashes(card, "hash-chain", trusted, target, 5, cfg) is not None


def test_toy_dryrun_on_card(dev):
    from tendermintx_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(4, [dev] * 4, shape="toy")


# ---------------------------------------------------------------------------
# The witness programs' kernels: csrc/sha.cu, csrc/ed25519.cu
# ---------------------------------------------------------------------------


def _witness_counts():
    from tendermintx_tpu_torch.ops import ed25519, sha256, sha512

    return (sha256.sha256_kernel_launches, sha512.sha512_kernel_launches, sha512.sha512_challenge_kernel_launches,
            ed25519.straus_kernel_launches, ed25519.bind_kernel_launches)


def _sha_words(kind: str, lanes: int, n_blocks: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32 if kind == "sha256" else 2**64, size=(lanes, n_blocks, 16), dtype=np.uint64)
    return torch.from_numpy(u.view(np.int64)).to(dev)


@pytest.mark.parametrize("kind", ["sha256", "sha512"])
@pytest.mark.parametrize("lanes", [1, 7, 64, 128, 129])
@pytest.mark.parametrize("n_blocks", [0, 1, 2, 3])
def test_sha_kernels_match_plain(dev, kind, lanes, n_blocks):
    """Ragged lane counts, n_active -1, 0, 1, n_blocks and above."""
    from tendermintx_tpu_torch.ops import sha256, sha512

    mod = sha256 if kind == "sha256" else sha512
    words = _sha_words(kind, lanes, n_blocks, 100 * lanes + n_blocks, dev)
    cycle = torch.tensor([-1, 0, 1, n_blocks, n_blocks + 3], device=dev)
    n_active = cycle[torch.arange(lanes, device=dev) % 5].contiguous()
    before = _witness_counts()
    got = getattr(mod, f"{kind}_blocks")(words, n_active)
    assert torch.equal(got, getattr(mod, f"{kind}_blocks_plain")(words, n_active))
    launched = [a - b for a, b in zip(_witness_counts(), before)]
    assert launched == ([1, 0, 0, 0, 0] if kind == "sha256" else [0, 1, 0, 0, 0])


def test_sha_kernels_match_hashlib(dev):
    import hashlib

    from tendermintx_tpu_torch.ops import sha256, sha512

    msgs = [bytes(range(n % 256)) * (1 + n // 256) for n in (0, 1, 55, 56, 64, 111, 112, 200, 250)]
    assert sha256.sha256_many(msgs, device=dev) == [hashlib.sha256(m).digest() for m in msgs]
    assert sha512.sha512_many(msgs, device=dev) == [hashlib.sha512(m).digest() for m in msgs]


@pytest.fixture(scope="module")
def witness_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    import chip_smoke

    return chip_smoke._witness_cases(torch.device("cuda", 0))


def test_straus_kernel_matches_plain_on_both_outcomes(dev, witness_cases):
    from tendermintx_tpu_torch.ops import ed25519 as ed

    ladder, _ = witness_cases
    before = _witness_counts()
    got = ed.straus_verify(*ladder)
    assert [a - b for a, b in zip(_witness_counts(), before)] == [0, 0, 0, 1, 0]
    want = ed.straus_verify_plain(*ladder)
    assert torch.equal(got, want)
    assert got.any() and not got.all()


def test_bind_kernel_matches_plain_on_both_outcomes(dev, witness_cases):
    from tendermintx_tpu_torch.ops import ed25519 as ed

    _, bind = witness_cases
    before = _witness_counts()
    got = ed.bind_witness(*bind)
    assert [a - b for a, b in zip(_witness_counts(), before)] == [0, 0, 0, 0, 1]
    want = ed.bind_witness_plain(*bind)
    assert torch.equal(got, want)
    assert got.any() and not got.all()


@pytest.mark.parametrize("lanes", [1, 7, 8, 9, 31, 33, 128, 129])
def test_ed25519_kernels_match_plain_at_ragged_lanes(dev, witness_cases, lanes):
    """The check lanes repeated to 1-129 lanes: the ladder's and the
    binding's blocks of 4 lanes (a quad of thread pairs each), the last
    one partial."""
    from tendermintx_tpu_torch.ops import ed25519 as ed

    ladder, bind = witness_cases
    pick = lambda args: tuple(a[torch.arange(lanes, device=dev) % a.shape[0]].contiguous() for a in args)
    lad, bnd = pick(ladder), pick(bind)
    assert torch.equal(ed.straus_verify_cuda(*lad), ed.straus_verify_plain(*lad))
    assert torch.equal(ed.bind_witness_cuda(*bnd), ed.bind_witness_plain(*bnd))


def test_verify_bound_on_card_equals_cpu(dev):
    """verify_bound (the SHA-512 challenge, binding and ladder kernels)
    and the batch entry points on the card against the CPU's plain
    programs."""
    import chip_smoke
    from tendermintx_tpu_torch.inputs.conversion import get_validator_data_from_block, signature_lanes
    from tendermintx_tpu_torch.inputs.testchain import TestChain
    from tendermintx_tpu_torch.ops import ed25519 as ed

    chain = TestChain(n_validators=5, chain_id="witness-chain")
    h = chain.extend()
    pks, msgs, sigs = (list(x) for x in signature_lanes(
        get_validator_data_from_block(chain.val_set, chain.commits[h], chain.chain_id, 8)))
    msgs[2] = chip_smoke._flip(msgs[2], 10)
    before = _witness_counts()
    card = ed.verify_batch_bound(pks, msgs, sigs, device=dev)
    assert [a - b for a, b in zip(_witness_counts(), before)] == [0, 0, 1, 1, 1]
    assert card.tolist() == ed.verify_batch_bound(pks, msgs, sigs, device="cpu").tolist()
    assert card.tolist() == [ed.verify_ints(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert ed.verify_batch(pks, msgs, sigs, device=dev).tolist() == card.tolist()


def test_witness_kernels_refuse_instead_of_falling_back(dev, witness_cases):
    from tendermintx_tpu_torch.ops import ed25519 as ed
    from tendermintx_tpu_torch.ops import sha256, sha512

    words = _sha_words("sha256", 4, 2, 1, dev)
    n_active = torch.full((4,), 2, dtype=torch.int64, device=dev)
    ladder, bind = witness_cases
    before = _witness_counts()
    for mod, kind in ((sha256, "sha256"), (sha512, "sha512")):
        fn = getattr(mod, f"{kind}_blocks_cuda")
        with pytest.raises(ValueError):
            fn(words.transpose(0, 1).contiguous().transpose(0, 1), n_active)  # not contiguous
        with pytest.raises(ValueError):
            fn(words.to(torch.int32), n_active)
        with pytest.raises(ValueError):
            fn(words, n_active.to(torch.int32))
        with pytest.raises(TypeError):
            fn(words.cpu(), n_active.cpu())
    strided = (ladder[0].transpose(1, 2).contiguous().transpose(1, 2), *ladder[1:])
    with pytest.raises(ValueError):
        ed.straus_verify_cuda(*strided)
    with pytest.raises(ValueError):
        ed.straus_verify_cuda(*ladder[:3], ladder[3].to(torch.int32), *ladder[4:])
    with pytest.raises(ValueError):
        ed.bind_witness_cuda(*bind[:6], bind[6].to(torch.int64), *bind[7:])
    with pytest.raises(ValueError):
        ed.bind_witness_cuda(*bind[:3], bind[3][:, :200].contiguous(), *bind[4:])
    assert _witness_counts() == before


def _challenge_inputs(lanes: int, width: int, lens: list[int], seed: int, dev):
    rng = np.random.default_rng(seed)
    r, pk, m = (torch.from_numpy(rng.integers(0, 256, size=(lanes, n), dtype=np.uint8)).to(dev)
                for n in (32, 32, width))
    return r, pk, m, torch.tensor([lens[i % len(lens)] for i in range(lanes)], dtype=torch.int64, device=dev)


@pytest.mark.parametrize("lanes", [1, 7, 33, 129])
@pytest.mark.parametrize("where", ["inside", "outside"])
def test_challenge_kernel_matches_twin(dev, lanes, where):
    """Ragged lane counts (blocks of 32), msg_len at the edges 0, 1, 47,
    48, W - 1 and W of the witness's 124-byte rows, or outside [0, W]
    (clamped alike); one launch, exact against the twin and hashlib."""
    import hashlib

    from tendermintx_tpu_torch.ops import sha512

    W = 124
    cap = 128 * sha512.challenge_blocks(W) - 81
    lens = [0, 1, 47, 48, W - 1, W] if where == "inside" else [-(1 << 40), -65, -64, -1, W + 1, cap, cap + 1, 1 << 40]
    r, pk, m, msg_len = _challenge_inputs(lanes, W, lens, lanes, dev)
    before = _witness_counts()
    got = sha512.sha512_challenge(r, pk, m, msg_len)
    assert [a - b for a, b in zip(_witness_counts(), before)] == [0, 0, 1, 0, 0]
    assert torch.equal(got, sha512.sha512_challenge_plain(r, pk, m, msg_len))
    data = torch.cat([r, pk, m], 1).cpu().numpy().tobytes()
    for i, n in enumerate(msg_len.tolist()):
        row = data[i * (64 + W):(i + 1) * (64 + W)] + bytes(cap - W)
        want = hashlib.sha512(row[:min(max(n, -64), cap) + 64]).digest()
        assert bytes(got[i].cpu().numpy()) == want


@pytest.mark.parametrize("width", [0, 1, 300, 1000])
def test_challenge_kernel_at_other_widths(dev, width):
    """Message rows of 0, 1, 300 (three blocks: a schedule slot reused) and
    1,000 bytes (shared memory past 48 KB), lengths over the whole range."""
    from tendermintx_tpu_torch.ops import sha512

    cap = 128 * sha512.challenge_blocks(width) - 81
    lens = sorted({-1, 0, 1, width // 2, width, width + 1, cap, 500})
    r, pk, m, msg_len = _challenge_inputs(70, width, lens, width, dev)
    assert torch.equal(sha512.sha512_challenge_cuda(r, pk, m, msg_len),
                       sha512.sha512_challenge_plain(r, pk, m, msg_len))


def test_challenge_kernel_refuses_instead_of_falling_back(dev):
    from tendermintx_tpu_torch.ops import sha512

    r, pk, m, msg_len = _challenge_inputs(4, 124, [100], 1, dev)
    before = _witness_counts()
    for bad in ((r.to(torch.int64), pk, m, msg_len), (r, pk[:, :31].contiguous(), m, msg_len),
                (r, pk, m.t().contiguous().t(), msg_len), (r, pk, m, msg_len.to(torch.int32)),
                (r, pk, m, msg_len[:3]), (r, pk, torch.zeros((4, 5000), dtype=torch.uint8, device=dev), msg_len),
                (r, pk, m.cpu(), msg_len)):
        with pytest.raises(ValueError):
            sha512.sha512_challenge_cuda(*bad)
    with pytest.raises(TypeError):
        sha512.sha512_challenge_cuda(r.cpu(), pk.cpu(), m.cpu(), msg_len.cpu())
    assert _witness_counts() == before


def _gadget_counts():
    from tendermintx_tpu_torch.circuits import gadgets
    from tendermintx_tpu_torch.ops import sha256

    return (sha256.sha256_kernel_launches, gadgets.validator_root_kernel_launches,
            gadgets.header_proofs_kernel_launches)


def test_sha256_tree_and_proof_kernels_match_twins(dev):
    """chip_smoke.py's cases: validator trees of 1, 5, 100 and 128 lanes at
    n_enabled 0, 1, odd, even and B; header proofs of 1, 5 and 33 with
    leaves of one and two blocks and both path bits; each launch exact
    against its twin on the card."""
    import chip_smoke

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    before = _gadget_counts()
    cases = chip_smoke._sha256_gadget_cases(gen, dev)
    trees = sum(len(c["n_enabled"]) for c in cases["sha256_validator_root"])
    assert [a - b for a, b in zip(_gadget_counts(), before)] == [0, trees, 3]


def test_sha256_gadgets_on_card_equal_cpu(dev):
    """The dispatchers on card tensors (one launch each) against the CPU's
    twins, and the roots against hashlib's CometBFT tree."""
    import hashlib

    from tendermintx_tpu_torch.circuits import gadgets as g

    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(100, 47), dtype=np.uint8)
    data[:, 0] = 0
    lens = rng.integers(1, 48, size=100).astype(np.int64)
    cpu = [torch.from_numpy(data), torch.from_numpy(lens)]
    card = [t.to(dev) for t in cpu]
    leaves = [hashlib.sha256(bytes(data[i, : lens[i]])).digest() for i in range(100)]

    def cometbft(xs):
        if len(xs) == 1:
            return xs[0]
        k = 1 << ((len(xs) - 1).bit_length() - 1)
        return hashlib.sha256(b"\x01" + cometbft(xs[:k]) + cometbft(xs[k:])).digest()

    for n in (1, 37, 64, 100):
        before = _gadget_counts()
        got = g.validator_root(*card, torch.tensor(n, device=dev))
        assert [a - b for a, b in zip(_gadget_counts(), before)] == [0, 1, 0]
        assert torch.equal(got.cpu(), g.validator_root(*cpu, n))
        assert bytes(got.cpu().numpy()) == cometbft(leaves[:n])
    pdata = rng.integers(0, 256, size=(5, 73), dtype=np.uint8)
    plens = np.array([119, 55, 1, 73, 64], dtype=np.int64)
    aunts = rng.integers(0, 256, size=(5, 4, 32), dtype=np.uint8)
    bits = np.array([[0, 0, 0, 0], [1, 1, 1, 1], [1, 0, 1, 0], [0, 2, 1, 1], [1, 1, 0, 0]], dtype=np.int64)
    cpu = [torch.from_numpy(a) for a in (pdata, plens, aunts, bits)]
    before = _gadget_counts()
    got = g.header_proof_root(*(t.to(dev) for t in cpu))
    assert [a - b for a, b in zip(_gadget_counts(), before)] == [0, 0, 1]
    assert torch.equal(got.cpu(), g.header_proof_root(*cpu))


def test_sha256_gadget_kernels_refuse_instead_of_falling_back(dev):
    from tendermintx_tpu_torch.circuits import gadgets

    u8 = lambda *shape: torch.zeros(shape, dtype=torch.uint8, device=dev)
    i64 = lambda *shape: torch.ones(shape, dtype=torch.int64, device=dev)
    n = torch.tensor(3, device=dev)
    before = _gadget_counts()
    for args in ((u8(0, 47), i64(0), n), (u8(1025, 47), i64(1025), n),  # lanes past one block
                 (u8(47, 8).t(), i64(8), n), (u8(8, 47), i64(8).to(torch.int32), n),
                 (u8(8, 47), i64(7), n), (u8(8, 47), i64(8), i64(2)), (u8(8, 47), i64(8), n.to(torch.int32))):
        with pytest.raises(ValueError):
            gadgets.validator_root_cuda(*args)
    with pytest.raises(TypeError):
        gadgets.validator_root_cuda(u8(8, 47).cpu(), i64(8).cpu(), n.cpu())
    proofs = (u8(5, 73), i64(5), u8(5, 4, 32), i64(5, 4))
    for k, bad in ((0, u8(73, 5).t()), (1, i64(4)), (2, u8(5, 3, 32)), (3, i64(5, 4).to(torch.int32))):
        with pytest.raises(ValueError):
            gadgets.header_proofs_cuda(*proofs[:k], bad, *proofs[k + 1:])
    with pytest.raises(TypeError):
        gadgets.header_proofs_cuda(*(t.cpu() for t in proofs))
    assert _gadget_counts() == before


# ---------------------------------------------------------------------------
# The recursion wrap's programs: csrc/logup.cu's EvalAir entries,
# csrc/poseidon.cu's round states and grinding
# ---------------------------------------------------------------------------


def _eval_inputs(n: int, seed: int, dev):
    """(trace (8, n), static rows (8, n), gamma, delta): random field values,
    addresses below n, a count row and three 0/1 gate rows."""
    from tendermintx_tpu_torch.ops.ext import GF2

    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n, size=(4, n)), rng.integers(0, 2**32, size=(1, n)),
                           rng.integers(0, 2, size=(3, n))])
    g = _felts((len(EDGES) + 4,), seed + 1, dev)[len(EDGES):]
    ext = lambda k: GF2(gl.GF(g[k : k + 1]), gl.GF(g[k + 1 : k + 2]))
    return gl.GF(_felts((8, n), seed, dev)), torch.from_numpy(rows).to(dev), ext(0), ext(2)


def _eval_counts():
    from tendermintx_tpu_torch.stark import evalair as ev

    return ev.eval_aux_kernel_launches


def _eval_check(trace, rows, gamma, delta):
    """eval_aux_cuda against eval_aux_plain, exact on the whole (10, n)
    output, twice back to back on the stream: one launch each, the same
    rows, and the look-back's counters and status words left at 0."""
    from tendermintx_tpu_torch.stark import evalair as ev

    want = ev.eval_aux_plain(trace, rows, gamma, delta).v
    before = _eval_counts()
    got = ev.eval_aux_cuda(trace, rows, gamma, delta)
    again = ev.eval_aux_cuda(trace, rows, gamma, delta)
    assert _eval_counts() == before + 2
    assert torch.equal(got.v, want) and torch.equal(again.v, want)
    tiles, _ = ev._lookback_scratch(trace.device, -(-int(want.shape[-1]) // ev.EVAL_TILE))
    assert not bool(tiles.any())
    return got


# ragged row counts about a block's tile (512 rows) and a chunk (128),
# tiles past one and two look-back windows of 32, and the wrap's 2^17 rows
@pytest.mark.parametrize("n", [1, 7, 255, 257, 5000, 33_000, 1 << 17])
def test_eval_kernels_match_plain(dev, n):
    _eval_check(*_eval_inputs(n, 500 + n, dev))


def test_eval_kernels_read_a_strided_trace_and_a_zero_denominator(dev):
    """The trace as rows of a wider tensor (row stride n + 5), and gamma
    equal to one cell's a + delta v0 + delta^2 v1, that cell copied to
    another term of the same thread's next row: both terms are 0, as in
    the plain twin, and the thread's other terms exact."""
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.stark import evalair as ev

    n, k, k2 = 1000, 1, 3
    r = 333 // ev.EVAL_TILE * ev.EVAL_TILE + 333 % ev.EVAL_THREADS  # a thread's first row
    r2 = r + ev.EVAL_THREADS  # its next
    assert r2 < n and r2 // ev.EVAL_TILE == r // ev.EVAL_TILE
    trace, rows, _, delta = _eval_inputs(n, 77, dev)
    wide = _felts((8, n + 5), 78, dev)
    wide[:, :n] = trace.v
    wide[2 * k2 : 2 * k2 + 2, r2] = wide[2 * k : 2 * k + 2, r]
    rows[k2, r2] = rows[k, r]
    trace = gl.GF(wide[:, :n])
    assert not trace.v.is_contiguous()
    d = gl.tensor_to_u64(torch.cat([delta.c0.v, delta.c1.v])).tolist()
    d2 = ((d[0] * d[0] + 7 * d[1] * d[1]) % P, 2 * d[0] * d[1] % P)
    v0, v1 = gl.tensor_to_u64(trace.v[2 * k : 2 * k + 2, r]).tolist()
    a = int(rows[k, r])
    g = [(a + d[0] * v0 + d2[0] * v1) % P, (d[1] * v0 + d2[1] * v1) % P]
    gamma = GF2(gl.GF(gl.tensor_from_u64(np.array(g[:1], dtype=np.uint64), dev)),
                gl.GF(gl.tensor_from_u64(np.array(g[1:], dtype=np.uint64), dev)))
    got = _eval_check(trace, rows, gamma, delta)
    for kk, rr in ((k, r), (k2, r2)):
        assert int(got.v[2 * kk, rr]) == 0 and int(got.v[2 * kk + 1, rr]) == 0


def test_eval_kernels_refuse_instead_of_falling_back(dev):
    from tendermintx_tpu_torch.stark import evalair as ev

    n = 64
    trace, rows, gamma, delta = _eval_inputs(n, 9, dev)
    before = _eval_counts()
    for bad in (dict(trace=gl.GF(trace.v.cpu())), dict(trace=gl.GF(trace.v.to(torch.int32))),
                dict(rows=rows.cpu()), dict(gamma=type(gamma)(gl.GF(gamma.c0.v.cpu()), gamma.c1)),
                dict(delta=type(delta)(delta.c0, gl.GF(delta.c1.v.to(torch.int32))))):
        args = dict(trace=trace, rows=rows, gamma=gamma, delta=delta) | bad
        with pytest.raises(TypeError):
            ev.eval_aux_cuda(args["trace"], args["rows"], args["gamma"], args["delta"])
    for bad in (dict(trace=gl.GF(trace.v[:7])), dict(trace=gl.GF(trace.v.t().contiguous().t())),
                dict(rows=rows[:, :-1]), dict(rows=rows.t().contiguous().t()),
                dict(trace=gl.GF(trace.v[:, :0]))):
        args = dict(trace=trace, rows=rows) | bad
        with pytest.raises(ValueError):
            ev.eval_aux_cuda(args["trace"], args["rows"], gamma, delta)
    assert _eval_counts() == before


# ragged state counts about a warp (32 states), a block (128) and the
# wrap's 2^15
@pytest.mark.parametrize("n", [1, 3, 7, 33, 129, 4099, 1 << 15, (1 << 15) + 5])
def test_expand_kernel_matches_plain(dev, n):
    """expand_perm_states on card states: one launch, exactly the plain
    round pieces' 106 columns; the last full round on w29 gives the
    permutation."""
    from tendermintx_tpu_torch.stark import recursion as rec

    s = _felts((n, ps.WIDTH), 600 + n, dev)
    before = ps.expand_kernel_launches
    got = rec.expand_perm_states(gl.GF(s))
    assert ps.expand_kernel_launches == before + 1
    assert torch.equal(got.v, ps.expand_plain(s))
    rc, mds_t = ps.plain_params(dev)
    assert torch.equal(ps.full_round_plain(got.v[94:].t().contiguous(), rc[29], mds_t), ps.permute_cuda(s))


def test_expand_kernel_refuses_instead_of_falling_back(dev):
    s = _felts((64, ps.WIDTH), 5, dev)
    before = ps.expand_kernel_launches
    with pytest.raises(TypeError):
        ps.expand_cuda(s.cpu())
    with pytest.raises(TypeError):
        ps.expand_cuda(s.to(torch.int32))
    for bad in (s[:, :11].contiguous(), s.reshape(-1), s.t().contiguous().t()):
        with pytest.raises(ValueError):
            ps.expand_cuda(bad)
    assert ps.expand_kernel_launches == before


@pytest.mark.parametrize("pow_bits", [1, 4, 8, 12, 16, 32])
def test_grind_kernel_matches_plain(dev, pow_bits):
    """One launch a span, the span's first hit or None as grind_plain's:
    a 2^18 span, ragged spans, a start past 0."""
    for seed in (1, 12345, P - 1, 2**32):
        for start, span in ((0, 1 << 18), (0, 37), (1000, 129), (5, 1)):
            before = ps.grind_kernel_launches
            got = ps.grind_cuda(seed, pow_bits, start, span, dev)
            assert ps.grind_kernel_launches == before + 1
            assert got == ps.grind_plain(seed, pow_bits, start, span, dev)


def test_grind_kernel_hits_in_the_first_and_the_last_chunk_or_none(dev):
    """Spans about the host loop's 12-bit nonce, one launch each: its hit
    in the span's first chunk (the span starting 3 before it), in the last
    chunk, ragged (the span ending at it) and whole (40 chunks ending at
    it), and a span that stops just short of it (None), as grind_plain's."""
    chunk = ps.GRIND_CHUNK
    for seed in (3, 77, P - 1):
        nonce = fri.grind(seed, 12)
        k = min((nonce + 1) // chunk, 40)
        cases = [(max(nonce - 3, 0), 10_000, nonce), (0, nonce + 1, nonce),
                 (nonce + 1 - k * chunk, k * chunk, nonce)] + ([(0, nonce, None)] if nonce else [])
        for start, span, want in cases:
            before = ps.grind_kernel_launches
            assert ps.grind_cuda(seed, 12, start, span, dev) == want == ps.grind_plain(seed, 12, start, span, dev)
            assert ps.grind_kernel_launches == before + 1


def test_grind_on_card_past_2_18_in_one_launch(dev):
    """A 20-bit search whose nonce lies past 2^18 candidates (several
    waves of resident threads): one launch of the default span, the nonce
    grind_plain finds over the same span, accepted by check_grind."""
    for seed in range(5, 37):
        before = ps.grind_kernel_launches
        nonce = fri.grind(seed, 20, dev)
        if nonce >= 1 << 18:
            break
    assert nonce >= 1 << 18 and ps.grind_kernel_launches == before + 1
    assert ps.grind_plain(seed, 20, 0, fri.GRIND_SPAN, dev) == nonce and fri.check_grind(seed, nonce, 20)


def test_grind_on_card_past_the_first_batch(dev, monkeypatch):
    """grind on the card with spans of 64: the host loop's nonce, one
    launch a span searched."""
    monkeypatch.setattr(fri, "GRIND_SPAN", 64)
    nonces = []
    for seed in (3, 77, P - 1, 2**40):
        before = ps.grind_kernel_launches
        nonce = fri.grind(seed, 9, dev)
        assert nonce == fri.grind(seed, 9) and fri.check_grind(seed, nonce, 9)
        assert ps.grind_kernel_launches - before == nonce // 64 + 1
        nonces.append(nonce)
    assert max(nonces) >= 64


def test_grind_kernel_refuses_instead_of_falling_back(dev):
    before = ps.grind_kernel_launches
    for args in ((P, 4, 0, 8), (1, 0, 0, 8), (1, 33, 0, 8), (1, 4, -1, 8), (1, 4, 0, 0), (1, 4, P - 4, 5)):
        with pytest.raises(ValueError):
            ps.grind_cuda(*args, dev)
    with pytest.raises(TypeError):
        ps.grind_cuda(1, 4, 0, 8, "cpu")
    assert ps.grind_kernel_launches == before


class MixAir(Air):
    """The reference's tiny multiplicative-mix AIR (tests/test_recursion.py)."""

    n_cols = 4
    n_public = 2
    constraint_degree = 3
    frame_offsets = [0, 1]

    def eval_transition(self, frame, alg):
        a, b, c, d = frame.local
        return [frame.next[0] - (a * b + c), frame.next[1] - b, frame.next[2] - (c + d), frame.next[3] - d]

    def eval_first(self, frame, alg):
        return [frame.local[0] - frame.public[0], frame.local[1] - frame.public[1]]


def _wrap_counts():
    from tendermintx_tpu_torch.stark import evalair as ev

    return (ev.eval_aux_kernel_launches, ps.expand_kernel_launches, ps.grind_kernel_launches)


def test_toy_wrap_on_card_equals_cpu(dev):
    """The toy two-statement batch of tests/test_torch_recursion.py wrapped
    on the card and on the CPU: the same bytes; the card's wrap runs the
    eval aux kernel once, the round-state kernel once and one grinding
    launch a span searched; the CPU's none."""
    import json

    from tendermintx_tpu_torch.stark import recursion as rec
    from tendermintx_tpu_torch.stark.batch import prove_batch
    from tendermintx_tpu_torch.stark.prover import StarkConfig
    from tendermintx_tpu_torch.stark.serialize import wrapped_batch_to_dict

    cfg = StarkConfig(rate_bits=2, n_queries=4, final_poly_len=8, proof_of_work_bits=4, cap_bits=3)
    wrap_cfg = StarkConfig(rate_bits=3, n_queries=4, final_poly_len=8, proof_of_work_bits=2, cap_bits=2)

    def mix_cols(n, p0, p1):
        cols, (a, b, c, d) = [[p0], [p1], [3], [5]], (p0, p1, 3, 5)
        for _ in range(n - 1):
            a, b, c, d = (a * b + c) % P, b, (c + d) % P, d
            for col, v in zip(cols, (a, b, c, d)):
                col.append(v)
        return np.array(cols, dtype=object)

    airs = [MixAir(), MixAir()]
    cols, publics = [mix_cols(64, 2, 3), mix_cols(128, 4, 9)], [[2, 3], [4, 9]]
    base = prove_batch(airs, [gl.GF.from_ints(c) for c in cols], publics, cfg, transcript_seed=[11, 22])
    before = _wrap_counts()
    card = rec.wrap_batch(airs, base, cfg, transcript_seed=[11, 22], wrap_config=wrap_cfg, device=dev)
    grinds = card.wrapper.fri_proof.pow_nonce // fri.GRIND_SPAN + 1
    assert tuple(a - b for a, b in zip(_wrap_counts(), before)) == (1, 1, grinds)
    launched = _wrap_counts()
    host = rec.wrap_batch(airs, base, cfg, transcript_seed=[11, 22], wrap_config=wrap_cfg, device="cpu")
    assert _wrap_counts() == launched
    assert json.dumps(wrapped_batch_to_dict(card)) == json.dumps(wrapped_batch_to_dict(host))
    assert rec.verify_wrapped_batch(airs, card, cfg, transcript_seed=[11, 22], wrap_config=wrap_cfg)


def n4_wrapped_sha256(tmp_path, device) -> str:
    """The SHA-256 of the N=4 skip composite 1 -> 5 of _chain's chain,
    proven at chip_smoke.py's parity configs (base rate 3, 6 queries, final
    64, PoW 4; wrap rate 3, 6 queries, final 32, PoW 2) and wrapped, both on
    `device`."""
    import hashlib

    from tendermintx_tpu_torch.circuits.composite import prove_skip_composite, wrap_composite
    from tendermintx_tpu_torch.stark.prover import StarkConfig

    chain, f = _chain(tmp_path, n_validators=4, heights=5)
    trusted = chain.headers[1].hash()
    inputs = f.get_skip_inputs(1, trusted, 5, max_validators=4)
    cfg = StarkConfig(rate_bits=3, n_queries=6, final_poly_len=64, proof_of_work_bits=4)
    wrap_cfg = StarkConfig(rate_bits=3, n_queries=6, final_poly_len=32, proof_of_work_bits=2)
    proof = prove_skip_composite(1, trusted, 5, inputs, cfg, device=device)
    return hashlib.sha256(wrap_composite(proof, cfg, wrap_cfg, device=device).to_bytes()).hexdigest()


# n4_wrapped_sha256(tmp_path, "cpu"): the proof and the wrap on the CPU
# (plain twins throughout), computed once on a CPU host (about 12 minutes
# on 4 torch threads), not in this file
N4_CPU_WRAPPED_SHA256 = "cfddfced42cd4aa47bb976ece225106114ec88de9c9c5f269686620ecc32a1ab"


def test_n4_wrap_on_card_equals_cpu(dev, tmp_path):
    """The N=4 composite proven and wrapped on the card has the bytes of
    the CPU's, as a frozen hash: N4_CPU_WRAPPED_SHA256 is a copy of the
    CPU path's own output, so a deliberate change to the proof's or the
    wrap's bytes fails here on the card as a card fault would. The live
    check is chip_smoke.py's parity phase, which proves and wraps an N=4
    skip on the card and on the CPU in the same run and compares the
    bytes. After such a change, regenerate the constant on a CPU host
    (from the repo's root, with tests/ on sys.path, print
    n4_wrapped_sha256(pathlib.Path(tempfile.mkdtemp()), "cpu")) and check
    that the parity phase still passes on the card."""
    before = _wrap_counts()
    assert n4_wrapped_sha256(tmp_path, dev) == N4_CPU_WRAPPED_SHA256
    got = tuple(a - b for a, b in zip(_wrap_counts(), before))
    assert got[:2] == (1, 1) and got[2] >= 2  # the prove's grind and the wrap's
