"""The port's Poseidon against the JAX package: the constant tables (and
the kernels' copy of them in csrc/poseidon_params.cuh), the plain batched
permutation (against JAX ``permute``, whose CPU dispatch is its XLA path,
and the host oracle), the sponge, the ragged column sponge and the tree
layer (the 2-to-1 compression). The CUDA kernels themselves are checked on the card
(chip_smoke.py and tests/test_torch_cuda.py). Tolerance: exact equality
(integer field arithmetic)."""

import os
import re

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops import merkle as jmk
from tendermintx_tpu.ops import poseidon as jps
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu_torch.ops import merkle as mk
from tendermintx_tpu_torch.ops import poseidon as ps
from tendermintx_tpu_torch.ops.cuda_build import CSRC_DIR
from tendermintx_tpu_torch.ops.goldilocks import GF, P

EDGE_STATES = [[0] * 12, [1] * 12, [P - 1] * 12, [2**32 - 1] * 12, [2**32] * 12, [2**63 % P] * 12]


def _states(b: int, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    out = [[int(v) % P for v in rng.integers(0, 2**63, 12) * 2] for _ in range(b)]
    out[: min(b, len(EDGE_STATES))] = EDGE_STATES[:b]
    return out


def _ints(g) -> list:
    return g.to_ints().tolist()


def _felt_matrix(rows: int, cols: int, seed: int) -> np.ndarray:
    """(rows, cols) canonical felts as Python ints, the edge values first."""
    rng = np.random.default_rng(seed)
    out = np.array([[int(v) % P for v in rng.integers(0, 2**63, cols) * 2] for _ in range(rows)], dtype=object)
    edges = [0, 1, P - 1, 2**32 - 1, 2**32, 2**63 % P, P - 2**32]
    flat = out.reshape(-1)
    k = min(len(edges), flat.size)
    flat[:k] = edges[:k]
    return out


def test_constant_tables_equal_reference():
    assert ps.round_constants() == jps.round_constants()
    assert ps.mds_matrix() == jps.mds_matrix()
    assert all(0 < v < 128 for row in ps.mds_matrix() for v in row)


def test_kernel_params_header_equals_tables():
    """The constexpr tables the CUDA kernels compile (csrc/poseidon_params.cuh)
    are round_constants() and mds_matrix(), entry for entry."""
    with open(os.path.join(CSRC_DIR, "poseidon_params.cuh")) as f:
        text = f.read()
    rc_block = text[text.index("#define TMX_POSEIDON_RC_INIT") : text.index("#define TMX_POSEIDON_MDS_INIT")]
    mds_block = text[text.index("#define TMX_POSEIDON_MDS_INIT") : text.index("namespace tmx_poseidon")]
    rc = [int(v, 16) for v in re.findall(r"0x([0-9A-Fa-f]+)ULL", rc_block)]
    mds = [int(v) for v in re.findall(r"\b(\d+)\b", mds_block.split("\\", 1)[1])]
    assert rc == [v for row in ps.round_constants() for v in row]
    assert mds == [v for row in ps.mds_matrix() for v in row]
    dims = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert (int(dims["WIDTH"]), int(dims["HALF_FULL_ROUNDS"]), int(dims["PARTIAL_ROUNDS"])) == (
        ps.WIDTH, ps.FULL_ROUNDS // 2, ps.PARTIAL_ROUNDS)


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
    # the (2 * 32, 4) layer of digests left[0], right[0], left[1], ...
    got = _ints(ps.merkle_layer(GF.from_ints(rows[:, :8].reshape(64, 4))))
    assert got == [jps.two_to_one_ints([int(v) for v in l], [int(v) for v in r]) for l, r in zip(left, right)]


@pytest.mark.parametrize("L", [1, 7, 9, 13, 170])
def test_hash_no_pad_cols_ragged_matches_jax_and_oracle(L):
    """Any width L >= 1: the plain column sponge zero-fills the last chunk,
    equal to the JAX sponge on zero-padded columns and to hash_ints of the
    zero-padded rows."""
    rows = _felt_matrix(16, L, seed=100 + L)
    got = _ints(ps.hash_no_pad_cols(GF.from_ints(rows.T.copy())))
    padded = np.concatenate([rows, np.zeros((16, (-L) % ps.RATE), dtype=object)], axis=1)
    want = jps.hash_no_pad_cols(JGF.from_ints(padded.T.copy())).to_ints()
    assert got == [[int(v) for v in r] for r in want]
    assert got == [jps.hash_ints([int(v) for v in r]) for r in padded]


def test_build_cols_ragged_width_matches_jax_caps():
    """A tree over the column sponge's leaves at a width that is not a
    RATE multiple (no padding copy) gives the JAX build_cols tree's caps
    and root."""
    cols = _felt_matrix(13, 32, seed=77)
    tree = mk.MerkleTree.from_leaves(ps.hash_no_pad_cols(GF.from_ints(cols)))
    jtree = jmk.MerkleTree.build_cols(JGF.from_ints(cols))
    for cap_bits in (0, 2, 5):
        assert tree.cap(cap_bits) == jtree.cap(cap_bits)
    assert tree.root == jtree.root


def test_merkle_layer_plain_matches_oracle_and_jax_root():
    d = _felt_matrix(16, 4, seed=5)
    got = _ints(ps.merkle_layer(GF.from_ints(d)))
    assert got == [ps.two_to_one_ints([int(v) for v in d[2 * i]], [int(v) for v in d[2 * i + 1]])
                   for i in range(8)]
    assert got == [jps.two_to_one_ints([int(v) for v in d[2 * i]], [int(v) for v in d[2 * i + 1]])
                   for i in range(8)]
    rows = _felt_matrix(64, 10, seed=6)
    tree = mk.MerkleTree.build(GF.from_ints(rows))
    assert len(tree.dev_layers) == 7
    assert tree.root == jmk.MerkleTree.build(JGF.from_ints(rows)).root


@pytest.mark.parametrize(
    "entry, shape",
    [
        ("hash_no_pad_cols", (0, 4)),
        ("hash_no_pad_cols", (4,)),
        ("merkle_layer", (3, 4)),
        ("merkle_layer", (1, 4)),
        ("merkle_layer", (4, 5)),
    ],
)
def test_entries_reject_shapes_the_kernels_do_not_take(entry, shape):
    with pytest.raises(ValueError):
        getattr(ps, entry)(GF(torch.zeros(shape, dtype=torch.int64)))


def test_permute_rejects_non_cpu_non_cuda():
    with pytest.raises(ValueError):
        ps.permute_tensor(torch.zeros((1, 12), dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("entry", ["hash_no_pad_cols", "merkle_layer"])
def test_entries_reject_non_cpu_non_cuda(entry):
    shape = {"hash_no_pad_cols": (8, 2), "merkle_layer": (2, 4)}[entry]
    with pytest.raises(ValueError):
        getattr(ps, entry)(GF(torch.zeros(shape, dtype=torch.int64, device="meta")))


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
