"""The port's NTT/LDE and Merkle commitments against the JAX package and
the Python-int oracles, and the NTT kernel's schedule (its plain twin)
against the plain transforms; the card's kernel is tested in
tests/test_torch_cuda.py. Tolerance: exact equality."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops import merkle as jmerkle
from tendermintx_tpu.ops import ntt as jntt
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import prover as jprover
from tendermintx_tpu_torch.ops import merkle, ntt
from tendermintx_tpu_torch.ops import poseidon as ps
from tendermintx_tpu_torch.ops.goldilocks import GF, MULTIPLICATIVE_GENERATOR, P
from tendermintx_tpu_torch.parallel import prover as shp
from tendermintx_tpu_torch.parallel.sharding import LaneMesh
from tendermintx_tpu_torch.stark import prover as pr

SHIFT = 11  # a coset shift other than the default generator 7


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**63, size=shape).astype(object) * 2) % P


def test_tables_equal_reference():
    for log_n in (0, 1, 5, 18, 32):
        assert ntt.primitive_root_of_unity(log_n) == jntt.primitive_root_of_unity(log_n)
    for log_n in (1, 4, 9):
        assert np.array_equal(ntt.bit_reverse_perm(log_n), jntt._bit_reverse_perm(log_n))
        for inverse in (False, True):
            for mine, (lo, hi) in zip(ntt.stage_twiddles(log_n, inverse), jntt._stage_twiddles(log_n, inverse)):
                ref = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
                assert np.array_equal(mine, ref)


@pytest.mark.parametrize("n", [1, 2, 8, 64, 256])
def test_ntt_matches_oracle_and_jax(n):
    x = _rand((3, n), n)
    got = ntt.ntt(GF.from_ints(x)).to_ints()
    assert [int(v) for v in got[0]] == jntt.ntt_ints([int(v) for v in x[0]])
    want = jax.jit(jntt.ntt)(JGF.from_ints(x)).to_ints()
    assert got.tolist() == want.tolist()
    back = ntt.intt(ntt.ntt(GF.from_ints(x))).to_ints()
    assert back.tolist() == x.tolist()


def test_coset_lde_matches_jax_and_evaluates_on_coset():
    n, rate_bits = 32, 3
    x = _rand((2, n), 5)
    got = ntt.coset_lde(GF.from_ints(x), rate_bits).to_ints()
    want = jax.jit(lambda g: jntt.coset_lde(g, rate_bits))(JGF.from_ints(x)).to_ints()
    assert got.tolist() == want.tolist()
    w = ntt.primitive_root_of_unity((n << rate_bits).bit_length() - 1)
    for i in (0, 3, 255):
        pt = MULTIPLICATIVE_GENERATOR * pow(w, i, P) % P
        assert int(got[1][i]) == ntt.eval_poly_ints([int(v) for v in x[1]], pt)


@pytest.mark.parametrize("n", [1, 2, 8, 1 << 10])
@pytest.mark.parametrize("batch, rate_bits", [(1, 1), (3, 3), (5, 4)])
def test_entries_and_prover_wrappers_match_jax(n, batch, rate_bits):
    """ntt / intt / coset_lde and the prover's trace_lde / coset_intt (the
    CPU path: the plain versions) against the JAX package's transforms and
    its jitted prover wrappers, at a non-default shift."""
    x = _rand((batch, n), 1000 * n + batch)
    gx, jx = GF.from_ints(x), JGF.from_ints(x)
    assert ntt.ntt(gx).to_ints().tolist() == jax.jit(jntt.ntt)(jx).to_ints().tolist()
    assert ntt.intt(gx).to_ints().tolist() == jax.jit(jntt.intt)(jx).to_ints().tolist()
    want = jax.jit(lambda g: jntt.coset_lde(g, rate_bits, SHIFT))(jx).to_ints()
    assert ntt.coset_lde(gx, rate_bits, SHIFT).to_ints().tolist() == want.tolist()
    coeffs, lde = pr.trace_lde(gx, rate_bits, SHIFT)
    jc, jl = jprover._trace_lde_fn(rate_bits, SHIFT)(jx)
    assert coeffs.to_ints().tolist() == jc.to_ints().tolist()
    assert lde.to_ints().tolist() == jl.to_ints().tolist()
    y = _rand((2, n), 7 * n + batch)
    got = pr.coset_intt(GF.from_ints(y), SHIFT).to_ints()
    j0, j1 = jprover._coset_intt_fn(SHIFT)(JGF.from_ints(y[:1]), JGF.from_ints(y[1:]))
    assert got.tolist() == [j0.to_ints()[0].tolist(), j1.to_ints()[0].tolist()]


def _felts(shape, seed) -> torch.Tensor:
    return GF.from_ints(_rand(shape, seed)).v


@pytest.mark.parametrize("log_n", [0, 1, 2, 3, 5, 8])
@pytest.mark.parametrize("passes", [1, 2, 3, None])
def test_kernel_schedule_twin_matches_plain(log_n, passes):
    """The kernel's passes (the coset split of the first pass, its lines
    and contiguous runs, the register rounds and their twiddles, the twist
    between passes, the folded n^-1 and power tables) as torch ops equal
    the plain versions, cut into `passes` passes (None: the kernel's own
    plan) at every rate."""
    x = _felts((3, 1 << log_n), 31 * log_n + (passes or 0))
    g = GF(x)

    def max_k(rate):
        log_N = log_n + rate
        return ntt.MAX_K if passes is None else max(rate, 1, -(-log_N // passes))

    assert torch.equal(ntt.schedule_twin("ntt", x, max_k=max_k(0)), ntt.ntt_plain(g).v)
    assert torch.equal(ntt.schedule_twin("intt", x, max_k=max_k(0)), ntt.intt_plain(g).v)
    pw = ntt.power_tensor(pow(SHIFT, P - 2, P), 1 << log_n, torch.device("cpu"))
    assert torch.equal(ntt.schedule_twin("intt", x, powers=pw, max_k=max_k(0)), (ntt.intt_plain(g) * GF(pw)).v)
    for rate_bits in (1, 3, 4):
        assert torch.equal(ntt.schedule_twin("coset_lde", x, rate_bits, SHIFT, max_k=max_k(rate_bits)),
                           ntt.coset_lde_plain(g, rate_bits, SHIFT).v)


@pytest.mark.parametrize("log_n, rate_bits", [(12, 3), (13, 4)])
def test_kernel_schedule_twin_at_the_main_path_plan(log_n, rate_bits):
    """The kernel's own plans at these sizes (ntt_plan(15, 3) = (8, 7) and
    ntt_plan(17, 4) = (9, 8): a coset split of 2^5 points into 8 and 16
    cosets) against the plain LDE and inverse. The N=128 paths' plans are
    held against the JAX package in tests/test_torch_ntt_plans.py."""
    assert ntt.ntt_plan(18, 3) == (9, 9) and ntt.ntt_plan(21, 4) == (7, 7, 7) and ntt.ntt_plan(19, 3) == (7, 6, 6)
    assert ntt.ntt_plan(15, 3) == (8, 7) and ntt.ntt_plan(17, 4) == (9, 8) and ntt.ntt_plan(9) == (9,)
    x = _felts((2, 1 << log_n), log_n)
    assert torch.equal(ntt.schedule_twin("coset_lde", x, rate_bits, SHIFT),
                       ntt.coset_lde_plain(GF(x), rate_bits, SHIFT).v)
    big = _felts((1, 1 << (log_n + rate_bits)), log_n + 1)
    assert torch.equal(ntt.schedule_twin("intt", big), ntt.intt_plain(GF(big)).v)


def test_twiddle_tables():
    for log_n in (1, 4, 9):
        for inverse in (False, True):
            table = ntt.twiddle_table(log_n, inverse, torch.device("cpu")).numpy().view(np.uint64)
            assert table.tolist() == ntt.stage_twiddles(log_n, inverse)[-1].tolist()


def test_cpu_tensors_take_the_plain_path():
    """On the CPU each entry is its plain version and launches nothing;
    the one-device mesh's LDE row blocks are the LDE itself (no copy)."""
    counts = lambda: (ntt.ntt_kernel_launches, ntt.intt_kernel_launches, ntt.lde_kernel_launches)
    before = counts()
    x = GF(_felts((3, 16), 5))
    assert torch.equal(ntt.ntt(x).v, ntt.ntt_plain(x).v)
    assert torch.equal(ntt.intt(x).v, ntt.intt_plain(x).v)
    assert torch.equal(ntt.coset_lde(x, 2, SHIFT).v, ntt.coset_lde_plain(x, 2, SHIFT).v)
    mesh = LaneMesh([torch.device("cpu")])
    coeffs, blocks = shp.sharded_trace_lde(mesh, 2, SHIFT)(x)
    (rows,) = shp.columns_to_rows(mesh, blocks, 3)
    assert rows.v.data_ptr() == blocks[0].v.data_ptr()
    assert counts() == before
    with pytest.raises(ValueError):
        ntt.ntt(GF(_felts((2, 12), 6)))


@pytest.mark.parametrize("width", [2, 7, 16, 21])
def test_merkle_caps_and_paths_match_jax(width):
    rows = _rand((64, width), width)
    tree = merkle.MerkleTree.build(GF.from_ints(rows))
    jtree = jmerkle.MerkleTree.build(JGF.from_ints(rows))
    cols_tree = merkle.MerkleTree.from_leaves(ps.hash_no_pad_cols(GF.from_ints(rows.T.copy())))
    assert tree.root == jtree.root == cols_tree.root
    for cap_bits in (0, 2, 4):
        assert tree.cap(cap_bits) == jtree.cap(cap_bits) == cols_tree.cap(cap_bits)
    idx = [0, 5, 17, 63]
    g, uniq, n_inner = tree.sibling_gather(idx, 2)
    jg, juniq, jn = jtree.sibling_gather(idx, 2)
    assert (uniq, n_inner) == (juniq, jn)
    assert merkle.MerkleTree.decode_paths(g.to_ints(), uniq, n_inner) == \
        jmerkle.MerkleTree.decode_paths(jg.to_ints(), juniq, jn)
    cap = tree.cap(2)
    for i in idx:
        path = tree.open_many([i])[i][: merkle.cap_levels(64, 2)]
        row = [int(v) for v in rows[i]]
        assert merkle.verify_opening(cap, i, row, path, merkle.cap_levels(64, 2))
        assert jmerkle.verify_opening(cap, i, row, path, jmerkle.cap_levels(64, 2))
        bad = list(row)
        bad[0] = (bad[0] + 1) % P
        assert not merkle.verify_opening(cap, i, bad, path)
        assert not merkle.verify_opening(cap, i ^ 1, row, path)


def test_pad_row_width_matches():
    rows = _rand((4, 11), 1)
    got = merkle.pad_row_width(GF.from_ints(rows)).to_ints()
    want = jmerkle.pad_row_width(JGF.from_ints(rows)).to_ints()
    assert got.tolist() == want.tolist()
    assert merkle.pad_row_ints([1, 2, 3]) == jmerkle.pad_row_ints([1, 2, 3])
