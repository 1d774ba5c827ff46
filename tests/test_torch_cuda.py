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
    e0, e1, beta = _felts((1024,), 23, dev), _felts((1024,), 24, dev), _felts((2,), 25, dev)
    invx = gl.tensor_from_u64(fri._inv_x_table(10, 7), dev)
    folded = []
    for mesh, d in ((card, dev), (host, torch.device("cpu"))):
        blocks = [GF2(gl.GF(a), gl.GF(b)) for a, b in zip(mesh.split(e0.to(d)), mesh.split(e1.to(d)))]
        out = shp.sharded_fold_fn(mesh)(blocks, gl.GF(invx.to(d)), GF2(gl.GF(beta[:1].to(d)), gl.GF(beta[1:].to(d))))
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
