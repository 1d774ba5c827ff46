"""The port's recursion-wrapped composites end to end on the CPU (slow tier,
as the reference marks its counterpart): N=4 skip and step composites
proven and wrapped by the port must be accepted by both packages'
verifiers after a wire round trip, and rejected when tampered. The EvalAir
tape has ~2^17 rows whatever N is, so even N=4 is a large wrap."""

import copy
import json

import pytest
import torch

torch.set_num_threads(2)

pytestmark = pytest.mark.slow

from tendermintx_tpu.circuits import composite as jcomp
from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig
from tendermintx_tpu_torch.circuits.composite import (
    CompositeProof,
    prove_skip_composite,
    prove_step_composite,
    verify_skip_composite,
    verify_step_composite,
    wrap_composite,
)
from tendermintx_tpu_torch.inputs.fetcher import InputDataFetcher, InputDataMode
from tendermintx_tpu_torch.inputs.testchain import TestChain
from tendermintx_tpu_torch.ops.goldilocks import P
from tendermintx_tpu_torch.stark.prover import StarkConfig

CHAIN_ID = "test-chain-wrap"
SKIP_MAX = 100
# the reference's reduced-security configs (tests/test_composite_wrapped.py)
CFG = StarkConfig(rate_bits=3, n_queries=6, final_poly_len=64, proof_of_work_bits=4)
WRAP_CFG = StarkConfig(rate_bits=3, n_queries=6, final_poly_len=32, proof_of_work_bits=2)
JCFG = JStarkConfig(rate_bits=3, n_queries=6, final_poly_len=64, proof_of_work_bits=4)
JWRAP_CFG = JStarkConfig(rate_bits=3, n_queries=6, final_poly_len=32, proof_of_work_bits=2)
# both the base and the wrap config must clear the floor
MIN_BITS = min(CFG.fri.security_bits, WRAP_CFG.fri.security_bits)
ARGS = dict(config=CFG, min_security_bits=MIN_BITS, wrap_config=WRAP_CFG)
JARGS = dict(config=JCFG, min_security_bits=MIN_BITS, wrap_config=JWRAP_CFG)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    c = TestChain(n_validators=4, chain_id=CHAIN_ID)
    for _ in range(6):
        c.extend()
    tmp = str(tmp_path_factory.mktemp("wrapped-chain"))
    c.write_fixtures(tmp)
    return c, InputDataFetcher(fixture_path=tmp, mode=InputDataMode.FIXTURE)


@pytest.fixture(scope="module")
def wrapped_skip(chain):
    c, f = chain
    trusted, target = c.headers[1].hash(), c.headers[5].hash()
    inputs = f.get_skip_inputs(1, trusted, 5, max_validators=8)
    base = prove_skip_composite(1, trusted, 5, inputs, CFG, device="cpu")
    wrapped = wrap_composite(base, CFG, WRAP_CFG, device="cpu")
    return base, wrapped, (1, trusted, 5, target)


def test_wrapped_skip_accepted_by_both_verifiers(wrapped_skip):
    base, wrapped, want = wrapped_skip
    assert wrapped.is_wrapped and not base.is_wrapped
    assert verify_skip_composite(wrapped, CHAIN_ID, SKIP_MAX, **ARGS) == want
    blob = wrapped.to_bytes()
    assert len(blob) < len(base.to_bytes())
    p2 = CompositeProof.from_bytes(blob)
    assert p2.is_wrapped and p2.to_dict() == wrapped.to_dict()
    d = p2.to_dict()
    assert all(not s["openings"] for s in d["batch"]["statements"])
    assert verify_skip_composite(p2, CHAIN_ID, SKIP_MAX, **ARGS) == want
    jproof = jcomp.CompositeProof.from_dict(json.loads(json.dumps(d)))
    assert jproof.is_wrapped and jproof.to_dict() == d
    assert jcomp.verify_skip_composite(jproof, CHAIN_ID, SKIP_MAX, **JARGS) == want
    # the wrap config must clear the floor too
    assert verify_skip_composite(p2, CHAIN_ID, SKIP_MAX, CFG, MIN_BITS + 1, WRAP_CFG) is None


def _abi_output(p):
    p.abi_output = bytes(32)


def _trace_cap(p):
    p.batch.statements[0].trace_cap[0][0] ^= 1


def _wrapper_publics(p):
    p.batch.wrapper.statements[0].public_inputs[3] ^= 1


def _ood_value(p):
    v = p.batch.statements[1].ood_trace[0][0]
    p.batch.statements[1].ood_trace[0][0] = ((v[0] + 1) % P, v[1])


@pytest.mark.parametrize("tamper", [_abi_output, _trace_cap, _wrapper_publics, _ood_value])
def test_wrapped_skip_tamper_rejected(wrapped_skip, tamper):
    _, wrapped, _ = wrapped_skip
    bad = copy.deepcopy(wrapped)
    tamper(bad)
    assert verify_skip_composite(bad, CHAIN_ID, SKIP_MAX, **ARGS) is None


def test_wrapped_skip_wrong_chain_rejected(wrapped_skip):
    assert verify_skip_composite(wrapped_skip[1], "other", SKIP_MAX, **ARGS) is None


def test_wrapped_step_composite(chain):
    c, f = chain
    prev = c.headers[3].hash()
    inputs = f.get_step_inputs(3, prev, max_validators=8)
    base = prove_step_composite(3, prev, inputs, CFG, device="cpu")
    wrapped = wrap_composite(base, CFG, WRAP_CFG, device="cpu")
    with pytest.raises(ValueError):
        wrap_composite(wrapped, CFG, WRAP_CFG, device="cpu")
    p2 = CompositeProof.from_bytes(wrapped.to_bytes())
    want = (3, prev, inputs.next_header)
    assert verify_step_composite(p2, CHAIN_ID, **ARGS) == want
    jproof = jcomp.CompositeProof.from_dict(p2.to_dict())
    assert jcomp.verify_step_composite(jproof, CHAIN_ID, **JARGS) == want
    bad = copy.deepcopy(p2)
    bad.batch.wrapper.statements[0].trace_cap[0][0] ^= 1
    assert verify_step_composite(bad, CHAIN_ID, **ARGS) is None
    assert jcomp.verify_step_composite(
        jcomp.CompositeProof.from_dict(bad.to_dict()), CHAIN_ID, **JARGS
    ) is None
