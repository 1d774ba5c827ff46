"""The port's PoseidonChainAir against the JAX package's: the trace and the
chain output are equal, a small proof is byte-identical with and without
``mesh=``, and each package's verifier accepts the other's proof and
rejects a wrong output. Exact equality: integer field arithmetic."""

import json

import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.stark import poseidon_air as jpa
from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig
from tendermintx_tpu.stark.prover import prove as j_prove
from tendermintx_tpu.stark.serialize import stark_proof_from_dict as j_from_dict
from tendermintx_tpu.stark.serialize import stark_proof_to_dict as j_to_dict
from tendermintx_tpu.stark.verifier import verify as j_verify
from tendermintx_tpu_torch.ops.goldilocks import P
from tendermintx_tpu_torch.parallel.sharding import LaneMesh
from tendermintx_tpu_torch.stark.poseidon_air import (
    PoseidonChainAir,
    poseidon_chain_output,
    poseidon_chain_trace,
)
from tendermintx_tpu_torch.stark.prover import StarkConfig, prove
from tendermintx_tpu_torch.stark.serialize import stark_proof_from_dict, stark_proof_to_dict
from tendermintx_tpu_torch.stark.verifier import verify

CFG = StarkConfig(rate_bits=3, n_queries=8, final_poly_len=8)
JCFG = JStarkConfig(rate_bits=3, n_queries=8, final_poly_len=8)
INPUT = [7 * i + 3 for i in range(12)]
N_PERMS = 4  # 128 rows


def _dump(d) -> str:
    return json.dumps(d, sort_keys=True)


@pytest.fixture(scope="module")
def proofs():
    trace, publics = poseidon_chain_trace(INPUT, N_PERMS)
    jtrace, jpublics = jpa.poseidon_chain_trace(INPUT, N_PERMS)
    single = prove(PoseidonChainAir(), trace, publics, CFG)
    jproof = j_prove(jpa.PoseidonChainAir(), jtrace, jpublics, JCFG)
    return trace, publics, jtrace, jpublics, single, jproof


def test_trace_and_output_equal_jax(proofs):
    trace, publics, jtrace, jpublics, _, _ = proofs
    assert publics == jpublics
    assert trace.to_ints().tolist() == jtrace.to_ints().tolist()
    assert publics[12:] == poseidon_chain_output(INPUT, N_PERMS) == jpa.poseidon_chain_output(INPUT, N_PERMS)


@pytest.mark.parametrize("n_shards", [0, 8, 2])
def test_proof_byte_identical_to_jax(proofs, n_shards):
    trace, publics, _, _, single, jproof = proofs
    proof = single if not n_shards else prove(
        PoseidonChainAir(), trace, publics, CFG, mesh=LaneMesh([torch.device("cpu")] * n_shards)
    )
    assert _dump(stark_proof_to_dict(proof)) == _dump(j_to_dict(jproof))


def test_each_package_verifies_the_others_proof(proofs):
    *_, single, jproof = proofs
    assert verify(PoseidonChainAir(), stark_proof_from_dict(j_to_dict(jproof)), CFG)
    assert j_verify(jpa.PoseidonChainAir(), j_from_dict(stark_proof_to_dict(single)), JCFG)


def test_wrong_output_rejected_by_both():
    trace, publics = poseidon_chain_trace(INPUT, 2)
    bad = list(publics)
    bad[12] = (bad[12] + 1) % P
    proof = prove(PoseidonChainAir(), trace, bad, CFG)
    assert not verify(PoseidonChainAir(), proof, CFG)
    assert not j_verify(jpa.PoseidonChainAir(), j_from_dict(stark_proof_to_dict(proof)), JCFG)
