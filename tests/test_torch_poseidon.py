"""The port's Poseidon against the JAX package: the constant tables, the
plain batched permutation (against JAX ``permute``, whose CPU dispatch is
its XLA path, and the host oracle), the sponge and the compression. The
CUDA kernel itself is checked on the card (chip_smoke.py and
tests/test_torch_cuda.py). Tolerance: exact equality (integer field arithmetic)."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops import poseidon as jps
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu_torch.ops import poseidon as ps
from tendermintx_tpu_torch.ops.goldilocks import GF, P

EDGE_STATES = [[0] * 12, [1] * 12, [P - 1] * 12, [2**32 - 1] * 12, [2**32] * 12, [2**63 % P] * 12]


def _states(b: int, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    out = [[int(v) % P for v in rng.integers(0, 2**63, 12) * 2] for _ in range(b)]
    out[: min(b, len(EDGE_STATES))] = EDGE_STATES[:b]
    return out


def _ints(g) -> list:
    return g.to_ints().tolist()


def test_constant_tables_equal_reference():
    assert ps.round_constants() == jps.round_constants()
    assert ps.mds_matrix() == jps.mds_matrix()
    assert all(0 < v < 128 for row in ps.mds_matrix() for v in row)


@pytest.mark.parametrize("b", [1, 7, 4096, 5000])
def test_permute_plain_matches_jax_and_oracle(b):
    states = _states(b, seed=b)
    arr = np.array(states, dtype=object)
    got = _ints(ps.permute(GF.from_ints(arr)))
    want = [[int(v) for v in row] for row in jax.jit(jps.permute)(JGF.from_ints(arr)).to_ints()]
    assert got == want
    assert got[:8] == [jps.permute_ints(s) for s in states[:8]]
    assert got[:8] == [ps.permute_ints(s) for s in states[:8]]


def test_permute_plain_across_cpu_blocks_matches_oracle():
    """A CPU batch larger than one block of rows is permuted block by
    block: rows on both sides of each block edge equal the host oracle."""
    n = 2 * ps._CPU_BLOCK + 3
    rng = np.random.default_rng(31)
    u = rng.integers(0, 2**63, size=(n, 12), dtype=np.uint64) * np.uint64(2)
    u[u >= np.uint64(P)] -= np.uint64(P)
    got = ps.permute_plain(torch.from_numpy(u.view(np.int64))).numpy().view(np.uint64)
    edge = ps._CPU_BLOCK
    for i in (0, edge - 1, edge, 2 * edge - 1, 2 * edge, n - 1):
        assert got[i].tolist() == ps.permute_ints(u[i].tolist()), i


def test_host_oracle_python_path_matches_native():
    for s in _states(4, seed=9):
        assert ps._permute_ints_py(s) == ps.permute_ints(s)


@pytest.mark.parametrize("L", [4, 8, 11, 16, 20])
def test_hash_no_pad_matches(L):
    rng = np.random.default_rng(L)
    rows = np.array([[int(v) % P for v in rng.integers(0, 2**63, L)] for _ in range(5)], dtype=object)
    got = _ints(ps.hash_no_pad(GF.from_ints(rows)))
    assert got == [[int(v) for v in r] for r in jax.jit(jps.hash_no_pad)(JGF.from_ints(rows)).to_ints()]
    assert got == [jps.hash_ints([int(v) for v in r]) for r in rows]


def test_hash_no_pad_cols_and_two_to_one():
    rng = np.random.default_rng(3)
    rows = np.array([[int(v) % P for v in rng.integers(0, 2**63, 16)] for _ in range(32)], dtype=object)
    cols = GF.from_ints(rows.T.copy())
    got = _ints(ps.hash_no_pad_cols(cols))
    assert got == [[int(v) for v in r] for r in jps.hash_no_pad_cols(JGF.from_ints(rows.T.copy())).to_ints()]
    left, right = rows[:, :4], rows[:, 4:8]
    got = _ints(ps.two_to_one(GF.from_ints(left), GF.from_ints(right)))
    assert got == [jps.two_to_one_ints([int(v) for v in l], [int(v) for v in r]) for l, r in zip(left, right)]


def test_permute_rejects_non_cpu_non_cuda():
    with pytest.raises(ValueError):
        ps.permute_tensor(torch.zeros((1, 12), dtype=torch.int64, device="meta"))


@pytest.mark.slow  # Pallas interpret mode executes the TPU kernel op by op
def test_plain_matches_pallas_kernel_interpret():
    """The port's plain version against the TPU kernel it replaces,
    run in interpret mode as tests/test_poseidon.py runs it."""
    from tendermintx_tpu.ops.poseidon_pallas import BLOCK, permute_lanes

    states = _states(BLOCK, seed=512)
    arr = np.array(states, dtype=object)
    lanes = permute_lanes(JGF.from_ints(arr.T.copy()), interpret=True)
    want = [[int(v) for v in row] for row in lanes.to_ints().T]
    assert _ints(ps.permute(GF.from_ints(arr))) == want
