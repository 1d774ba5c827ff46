"""The port's composite skip and step provers end to end on the CPU (their
plain versions), held against the JAX package: N=4 skip and step composites
from a synthetic chain, proven by the port, must be accepted by both
packages' verifiers and rejected when their statement is changed. The port
reads its inputs through its own copy of the input modules, which must give
the reference's skip inputs. Exact equality: the wire bytes are integers."""

import copy
import dataclasses
import gzip
import json

import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.circuits import composite as jcomp
from tendermintx_tpu.inputs import fetcher as jfetcher
from tendermintx_tpu.inputs import testchain as jtestchain
from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig
from tendermintx_tpu_torch.circuits.composite import (
    DEFAULT_COMPOSITE_CONFIG,
    MAX_ED_LANES,
    CompositeProof,
    prove_skip_composite,
    prove_step_composite,
    verify_skip_composite,
    verify_step_composite,
)
from tendermintx_tpu_torch.inputs import fetcher as tfetcher
from tendermintx_tpu_torch.inputs import testchain as ttestchain
from tendermintx_tpu_torch.stark.prover import StarkConfig

CHAIN_ID = "composite-chain"
SKIP_MAX = 100
# small enough for the CPU tier: 2*8 + 4 = 20 conjectured bits, so every
# verifier call passes min_security_bits explicitly
CFG = StarkConfig(rate_bits=2, n_queries=8, final_poly_len=16, proof_of_work_bits=4)
JCFG = JStarkConfig(rate_bits=2, n_queries=8, final_poly_len=16, proof_of_work_bits=4)
MIN_BITS = 20


def _chain(fixture_dir: str, testchain=ttestchain, fetcher=tfetcher):
    """A 4-validator test chain written as fixtures, and a fetcher over
    them, through one package's input modules."""
    chain = testchain.TestChain(n_validators=4, chain_id=CHAIN_ID)
    for _ in range(6):
        chain.extend()
    chain.write_fixtures(fixture_dir)
    return chain, fetcher.InputDataFetcher(fixture_path=fixture_dir, mode=fetcher.InputDataMode.FIXTURE)


def _inputs(fixture_dir: str, testchain=ttestchain, fetcher=tfetcher):
    """(trusted hash, target hash, SkipInputs 1 -> 5)."""
    chain, f = _chain(fixture_dir, testchain, fetcher)
    trusted = chain.headers[1].hash()
    return trusted, chain.headers[5].hash(), f.get_skip_inputs(1, trusted, 5, max_validators=8)


def _step_inputs(fixture_dir: str, testchain=ttestchain, fetcher=tfetcher):
    """(prev hash, StepInputs 3 -> 4)."""
    chain, f = _chain(fixture_dir, testchain, fetcher)
    prev = chain.headers[3].hash()
    return prev, f.get_step_inputs(3, prev, max_validators=8)


def _jax_inputs(fixture_dir: str):
    return _inputs(fixture_dir, jtestchain, jfetcher)


@pytest.fixture(scope="module")
def proven(tmp_path_factory):
    trusted, target, inputs = _inputs(str(tmp_path_factory.mktemp("chain")))
    proof = prove_skip_composite(1, trusted, 5, inputs, CFG, device="cpu")
    return trusted, target, inputs, proof


def test_port_inputs_equal_jax_inputs(tmp_path):
    """The port's copies of the input modules build the same chain and
    fetch the same skip inputs as the reference's, field for field."""
    port = _inputs(str(tmp_path / "port"))
    ref = _jax_inputs(str(tmp_path / "jax"))
    assert port[:2] == ref[:2]
    assert type(port[2]).__module__ == "tendermintx_tpu_torch.inputs.fetcher"
    assert dataclasses.asdict(port[2]) == dataclasses.asdict(ref[2])


@pytest.fixture(scope="module")
def step_proven(tmp_path_factory):
    prev, inputs = _step_inputs(str(tmp_path_factory.mktemp("step-chain")))
    return prev, inputs, prove_step_composite(3, prev, inputs, CFG, device="cpu")


def test_prove_requires_a_device(proven):
    trusted, _, inputs, _ = proven
    with pytest.raises(TypeError):
        prove_skip_composite(1, trusted, 5, inputs, CFG)


def test_port_verifier_accepts_and_rejects(proven):
    trusted, target, _, proof = proven
    p2 = CompositeProof.from_bytes(proof.to_bytes())
    assert verify_skip_composite(p2, CHAIN_ID, SKIP_MAX, CFG, MIN_BITS) == (1, trusted, 5, target)
    bad = copy.deepcopy(p2)
    bad.abi_output = bytes(32)
    assert verify_skip_composite(bad, CHAIN_ID, SKIP_MAX, CFG, MIN_BITS) is None
    assert verify_skip_composite(p2, "other-chain", SKIP_MAX, CFG, MIN_BITS) is None
    # the default floor refuses the small test config
    assert verify_skip_composite(p2, CHAIN_ID, SKIP_MAX, CFG) is None
    assert DEFAULT_COMPOSITE_CONFIG.fri.security_bits == 100 and MAX_ED_LANES == 512


def test_jax_verifier_accepts_port_proof(proven):
    trusted, target, _, proof = proven
    jproof = jcomp.CompositeProof.from_dict(proof.to_dict())
    assert jproof.to_dict() == proof.to_dict()
    out = jcomp.verify_skip_composite(jproof, CHAIN_ID, SKIP_MAX, JCFG, min_security_bits=MIN_BITS)
    assert out == (1, trusted, 5, target)
    bad = copy.deepcopy(jproof)
    bad.abi_output = bytes(32)
    assert jcomp.verify_skip_composite(bad, CHAIN_ID, SKIP_MAX, JCFG, min_security_bits=MIN_BITS) is None


def test_step_composite_accepted_by_both_verifiers(step_proven):
    prev, inputs, proof = step_proven
    p2 = CompositeProof.from_bytes(proof.to_bytes())
    assert p2.kind == "step" and not p2.is_wrapped
    want = (3, prev, inputs.next_header)
    assert verify_step_composite(p2, CHAIN_ID, CFG, MIN_BITS) == want
    jproof = jcomp.CompositeProof.from_dict(proof.to_dict())
    assert jproof.to_dict() == proof.to_dict()
    assert jcomp.verify_step_composite(jproof, CHAIN_ID, JCFG, min_security_bits=MIN_BITS) == want
    # a step proof is not a skip proof
    assert verify_skip_composite(p2, CHAIN_ID, SKIP_MAX, CFG, MIN_BITS) is None


@pytest.mark.parametrize("change", ["abi_output", "abi_inputs", "chain"])
def test_changed_step_statement_rejected(step_proven, change):
    prev, _, proof = step_proven
    bad = copy.deepcopy(proof)
    chain_id = CHAIN_ID
    if change == "abi_output":
        bad.abi_output = bytes(32)
    elif change == "abi_inputs":
        bad.abi_inputs = (4).to_bytes(8, "big") + prev
    else:
        chain_id = "other-chain"
    assert verify_step_composite(bad, chain_id, CFG, MIN_BITS) is None
    jbad = jcomp.CompositeProof.from_dict(bad.to_dict())
    assert jcomp.verify_step_composite(jbad, chain_id, JCFG, min_security_bits=MIN_BITS) is None


@pytest.mark.parametrize("n_wrap_statements", [1, 3])
def test_wrapped_proofs_refused(proven, n_wrap_statements):
    """A wrapped dict is parsed now; one whose wrap batch does not have
    exactly 2 statements is refused at the boundary."""
    d = copy.deepcopy(proven[3].to_dict())
    batch = d["batch"]
    stmts = [dict(sd, openings=[]) for sd in batch["statements"]]
    d["batch"] = {
        "wrapped": True,
        "statements": stmts,
        "layer_caps": batch["fri"]["layer_caps"],
        "final_poly": batch["fri"]["final_poly"],
        "pow_nonce": batch["fri"]["pow_nonce"],
        "wrapper": {"statements": stmts[:1] * n_wrap_statements, "fri": batch["fri"]},
    }
    with pytest.raises(ValueError, match="exactly 2 statements"):
        CompositeProof.from_dict(d)


@pytest.mark.slow  # the JAX prover compiles the Ed25519 statement's large XLA graphs
def test_port_proof_byte_identical_to_jax(proven, tmp_path):
    """Same canonical JSON; to_bytes then differs only in the reference's
    gzip header timestamp, which the port fixes at 0."""
    proof = proven[3]
    trusted, _, jinputs = _jax_inputs(str(tmp_path))
    jproof = jcomp.prove_skip_composite(1, trusted, 5, jinputs, JCFG)
    assert json.dumps(jproof.to_dict()) == json.dumps(proof.to_dict())
    assert gzip.decompress(jproof.to_bytes()) == gzip.decompress(proof.to_bytes())


@pytest.mark.slow  # the JAX prover compiles the Ed25519 statement's large XLA graphs
def test_port_step_proof_byte_identical_to_jax(step_proven, tmp_path):
    prev, _, proof = step_proven
    jprev, jinputs = _step_inputs(str(tmp_path), jtestchain, jfetcher)
    assert jprev == prev
    jproof = jcomp.prove_step_composite(3, prev, jinputs, JCFG)
    assert json.dumps(jproof.to_dict()) == json.dumps(proof.to_dict())
