"""The port's NTT/LDE and Merkle commitments against the JAX package and
the Python-int oracles. Tolerance: exact equality."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops import merkle as jmerkle
from tendermintx_tpu.ops import ntt as jntt
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu_torch.ops import merkle, ntt
from tendermintx_tpu_torch.ops import poseidon as ps
from tendermintx_tpu_torch.ops.goldilocks import GF, MULTIPLICATIVE_GENERATOR, P


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
