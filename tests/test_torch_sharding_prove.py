"""A whole STARK proven over the port's lane mesh: Sha256Air, whose frame
offsets up to 16 exercise the quotient's halo exchange, proven with
``mesh=`` on CPU device lists must serialize byte-identically to the JAX
package's single-chip proof (its tests/test_sharding.py holds that equal
to the JAX mesh proof), and both verifiers must accept it."""

import json

import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig
from tendermintx_tpu.stark.prover import prove as j_prove
from tendermintx_tpu.stark.serialize import stark_proof_from_dict as j_from_dict
from tendermintx_tpu.stark.serialize import stark_proof_to_dict as j_to_dict
from tendermintx_tpu.stark.sha256_air import Sha256Air as JSha256Air
from tendermintx_tpu.stark.verifier import verify as j_verify
from tendermintx_tpu_torch.parallel.sharding import LaneMesh
from tendermintx_tpu_torch.stark.prover import StarkConfig, prove
from tendermintx_tpu_torch.stark.serialize import stark_proof_to_dict
from tendermintx_tpu_torch.stark.sha256_air import Sha256Air, schedule_messages, sha256_batch_trace
from tendermintx_tpu_torch.stark.verifier import verify

CFG = StarkConfig(rate_bits=2, n_queries=12, final_poly_len=8)
JCFG = JStarkConfig(rate_bits=2, n_queries=12, final_poly_len=8)
MSGS = [bytes([i]) * (20 + i) for i in range(6)] + [b"x" * 90]  # 8 segments


@pytest.fixture(scope="module")
def statement():
    blocks, chain_flags, _ = schedule_messages(MSGS)
    trace, publics = sha256_batch_trace(blocks, chain_flags)
    return Sha256Air(len(blocks)), trace, publics


@pytest.fixture(scope="module")
def jax_proof(statement):
    air, trace, publics = statement
    jproof = j_prove(JSha256Air(air.n_blocks), JGF.from_ints(trace.to_ints()), publics, JCFG)
    return json.dumps(j_to_dict(jproof), sort_keys=True)


@pytest.mark.parametrize("n_shards", [8, 2])
def test_sharded_prove_byte_identical_to_jax(statement, jax_proof, n_shards):
    air, trace, publics = statement
    proof = prove(air, trace, publics, CFG, mesh=LaneMesh([torch.device("cpu")] * n_shards))
    got = json.dumps(stark_proof_to_dict(proof), sort_keys=True)
    assert got == jax_proof
    assert verify(air, proof, CFG)
    assert j_verify(JSha256Air(air.n_blocks), j_from_dict(json.loads(got)), JCFG)


def test_unsharded_prove_byte_identical_to_jax(statement, jax_proof):
    air, trace, publics = statement
    assert json.dumps(stark_proof_to_dict(prove(air, trace, publics, CFG)), sort_keys=True) == jax_proof
