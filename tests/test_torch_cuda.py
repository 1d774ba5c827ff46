"""The hand-written CUDA Poseidon kernels (the permutation, the column
sponge, the Merkle tree layer) against their plain torch versions on the
card, at small shapes and with the edge values 0, 1, p-1, 2^32-1, 2^32 and
2^63 mod p. Exact equality: integer field arithmetic has no tolerance.

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
    tree = MerkleTree.build_cols(gl.GF(_felts((9, 16), 7, dev)))
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
