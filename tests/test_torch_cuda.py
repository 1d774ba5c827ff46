"""The hand-written CUDA Poseidon kernel against its plain torch version on
the card, at small shapes and with the edge values 0, 1, p-1, 2^32-1, 2^32 and
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
