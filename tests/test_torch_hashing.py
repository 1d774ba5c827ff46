"""The port's standalone hash-plan proof (tendermintx_tpu_torch/circuits/
hashing.py: HashBundle, prove/verify_{skip,step}_hashes) against the JAX
package's, on the CPU (plain versions).

Fast tier: the N=4 skip 1 -> 5 and step 3 -> 4 hash statements (trace and
publics) equal the reference's exactly; bundles proven by the port at a
small config verify, give the chain's facts, and are rejected on every
change of statement that tests/test_hashing.py checks; HashBundle
round-trips through JSON and rejects malformed dicts cleanly. Slow tier:
the same bundles are byte-identical to the reference's prove_*_hashes, and
each package verifies the other's (the JAX prove of a 4,096-row Sha256Air
compiles for minutes on the CPU). Exact equality: the wire is integers.
"""

import copy
import json

import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.circuits import hashing as jhz
from tendermintx_tpu.inputs import fetcher as jfetcher
from tendermintx_tpu.inputs import testchain as jtestchain
from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig
from tendermintx_tpu_torch.circuits import hashing as hz
from tendermintx_tpu_torch.inputs import fetcher as tfetcher
from tendermintx_tpu_torch.inputs import testchain as ttestchain
from tendermintx_tpu_torch.stark.prover import StarkConfig

CHAIN_ID = "hash-chain"
# small enough for the CPU tier (the Sha256Air's degree 4 needs rate 2)
CFG = StarkConfig(rate_bits=2, n_queries=4, final_poly_len=8, proof_of_work_bits=4)
JCFG = JStarkConfig(rate_bits=2, n_queries=4, final_poly_len=8, proof_of_work_bits=4)
DESER_EXC = (ValueError, KeyError, TypeError, AttributeError, IndexError)


def _chain(fixture_dir: str, testchain=ttestchain, fetcher=tfetcher):
    """A 4-validator chain of 5 blocks written as fixtures, and a fetcher
    over them, through one package's input modules."""
    chain = testchain.TestChain(n_validators=4, chain_id=CHAIN_ID)
    for _ in range(4):
        chain.extend()
    chain.write_fixtures(fixture_dir)
    return chain, fetcher.InputDataFetcher(fixture_path=fixture_dir, mode=fetcher.InputDataMode.FIXTURE)


def _skip_inputs(f, chain):
    return f.get_skip_inputs(1, chain.headers[1].hash(), 5, max_validators=8)


def _step_inputs(f, chain):
    return f.get_step_inputs(3, chain.headers[3].hash(), max_validators=8)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """(port chain, port fetcher, reference chain, reference fetcher)."""
    return (
        *_chain(str(tmp_path_factory.mktemp("port"))),
        *_chain(str(tmp_path_factory.mktemp("ref")), jtestchain, jfetcher),
    )


@pytest.fixture(scope="module")
def skip_bundle(chains):
    chain, f = chains[:2]
    return hz.prove_skip_hashes(_skip_inputs(f, chain), CFG, device="cpu")


@pytest.fixture(scope="module")
def step_bundle(chains):
    chain, f = chains[:2]
    return hz.prove_step_hashes(_step_inputs(f, chain), CFG, device="cpu")


@pytest.mark.parametrize("kind", ["skip", "step"])
def test_hash_statement_matches_reference(chains, kind):
    """The port's Sha256Air statement of the N=4 hash layer: the same
    trace, publics and counts as the reference's."""
    chain, f, jchain, jf = chains
    assert chain.headers[5].hash() == jchain.headers[5].hash()
    if kind == "skip":
        port = hz.skip_hash_statement(_skip_inputs(f, chain), device="cpu")
        ref = jhz.skip_hash_statement(_skip_inputs(jf, jchain))
    else:
        port = hz.step_hash_statement(_step_inputs(f, chain), device="cpu")
        ref = jhz.step_hash_statement(_step_inputs(jf, jchain))
    (air, trace, publics), (jair, jtrace, jpublics) = port[:3], ref[:3]
    assert air.n_blocks == jair.n_blocks == 64
    assert trace.v.shape == (170, 64 * 64)
    assert (trace.to_ints() == jtrace.to_ints()).all()
    assert [int(v) for v in publics] == [int(v) for v in jpublics]
    assert port[3:] == ref[3:]


def test_prove_requires_a_device(chains):
    chain, f = chains[:2]
    with pytest.raises(TypeError):
        hz.prove_skip_hashes(_skip_inputs(f, chain), CFG)
    with pytest.raises(TypeError):
        hz.prove_step_hashes(_step_inputs(f, chain), CFG)
    assert hz.DEFAULT_HASH_CONFIG == StarkConfig(rate_bits=2, n_queries=28, final_poly_len=64)


def test_hash_bundle_round_trips(skip_bundle, step_bundle):
    for bundle, kind, nbt in ((skip_bundle, "skip", 4), (step_bundle, "step", 0)):
        d = bundle.to_dict()
        assert d["kind"] == f"{kind}-hashes" and d["nb"] == 4 and d["nb_trusted"] == nbt
        assert d["n_segments"] * hz.SEGMENT_ROWS == bundle.proof.n_rows
        back = hz.HashBundle.from_dict(json.loads(json.dumps(d)))
        assert (back.kind, back.n_segments, back.nb, back.nb_trusted) == (kind, 64, 4, nbt)
        assert json.dumps(back.to_dict(), sort_keys=True) == json.dumps(d, sort_keys=True)


def test_skip_hash_bundle_facts_and_rejections(chains, skip_bundle):
    """tests/test_hashing.py::test_skip_hash_bundle_end_to_end on the
    port's bundle, read back from its dict."""
    chain = chains[0]
    trusted, target = chain.headers[1].hash(), chain.headers[5].hash()
    bundle = hz.HashBundle.from_dict(skip_bundle.to_dict())
    facts = hz.verify_skip_hashes(bundle, CHAIN_ID, trusted, target, 5, CFG)
    assert facts is not None
    want = [v.simple_encode() for v in chain.val_set]
    assert facts.target_encodings == want
    assert facts.trusted_encodings == want
    assert facts.target_validators_hash == chain.vhash
    assert facts.trusted_validators_hash == chain.vhash
    # statement tampering: wrong target header / height / chain id / trusted header
    assert hz.verify_skip_hashes(bundle, CHAIN_ID, trusted, bytes(32), 5, CFG) is None
    assert hz.verify_skip_hashes(bundle, CHAIN_ID, trusted, target, 6, CFG) is None
    assert hz.verify_skip_hashes(bundle, "other-chain", trusted, target, 5, CFG) is None
    assert hz.verify_skip_hashes(bundle, CHAIN_ID, bytes(32), target, 5, CFG) is None
    # proof tampering: claim a different validator leaf byte
    bad = copy.deepcopy(bundle)
    bad.proof.public_inputs[0] ^= 1
    assert hz.verify_skip_hashes(bad, CHAIN_ID, trusted, target, 5, CFG) is None
    # the other statement kind, and the default config, refuse it
    assert hz.verify_step_hashes(bundle, CHAIN_ID, trusted, target, 5, CFG) is None
    assert hz.verify_skip_hashes(bundle, CHAIN_ID, trusted, target, 5) is None


def test_step_hash_bundle_facts_and_rejections(chains, step_bundle):
    """tests/test_hashing.py::test_step_hash_bundle_end_to_end on the
    port's bundle."""
    chain = chains[0]
    prev, nxt = chain.headers[3].hash(), chain.headers[4].hash()
    facts = hz.verify_step_hashes(step_bundle, CHAIN_ID, prev, nxt, 4, CFG)
    assert facts is not None
    assert facts.encodings == [v.simple_encode() for v in chain.val_set]
    assert facts.validators_hash == chain.vhash
    # header-chain link: a wrong prev header fails (the LAST_BLOCK_ID
    # binding), a wrong next header too
    assert hz.verify_step_hashes(step_bundle, CHAIN_ID, bytes(32), nxt, 4, CFG) is None
    assert hz.verify_step_hashes(step_bundle, CHAIN_ID, prev, bytes(32), 4, CFG) is None
    assert hz.verify_step_hashes(step_bundle, CHAIN_ID, prev, nxt, 5, CFG) is None
    assert hz.verify_skip_hashes(step_bundle, CHAIN_ID, prev, nxt, 4, CFG) is None


def test_hash_bundle_from_dict_rejects_malformed(chains, skip_bundle):
    """A malformed bundle dict raises one of the boundary exceptions; a
    well-formed one that lies about its shape verifies to None."""
    chain = chains[0]
    trusted, target = chain.headers[1].hash(), chain.headers[5].hash()
    good = skip_bundle.to_dict()
    proof = good["proof"]
    for bad in (
        {**good, "kind": "skip"},
        {**good, "kind": 5},
        {**good, "n_segments": "x"},
        {**good, "nb": None},
        {k: v for k, v in good.items() if k != "nb_trusted"},
        {k: v for k, v in good.items() if k != "proof"},
        {**good, "proof": {k: v for k, v in proof.items() if k != "trace_cap"}},
        {**good, "proof": {**proof, "public_inputs": "zz"}},
        {**good, "proof": []},
    ):
        with pytest.raises(DESER_EXC):
            hz.HashBundle.from_dict(bad)
    for lie in ({"n_segments": 32}, {"n_segments": 0}, {"nb": 3}, {"nb_trusted": 5}, {"kind": "step-hashes"}):
        bundle = hz.HashBundle.from_dict({**good, **lie})
        assert hz.verify_skip_hashes(bundle, CHAIN_ID, trusted, target, 5, CFG) is None


@pytest.fixture(scope="module")
def reference_bundles(chains):
    """The reference's skip and step bundles of the same inputs at the
    same config (slow: two cold JAX proves of a 4,096-row Sha256Air)."""
    jchain, jf = chains[2:]
    return (
        jhz.prove_skip_hashes(_skip_inputs(jf, jchain), JCFG),
        jhz.prove_step_hashes(_step_inputs(jf, jchain), JCFG),
    )


@pytest.mark.slow
def test_bundles_byte_identical_to_reference(chains, skip_bundle, step_bundle, reference_bundles):
    """The port's bundles and the reference's, as sorted JSON, are the same
    bytes, and each package's verifier accepts the other's."""
    chain = chains[0]
    jskip, jstep = reference_bundles
    for port, ref in ((skip_bundle, jskip), (step_bundle, jstep)):
        assert json.dumps(port.to_dict(), sort_keys=True) == json.dumps(ref.to_dict(), sort_keys=True)
    trusted, target = chain.headers[1].hash(), chain.headers[5].hash()
    prev, nxt = chain.headers[3].hash(), chain.headers[4].hash()
    port_skip = hz.verify_skip_hashes(hz.HashBundle.from_dict(jskip.to_dict()), CHAIN_ID, trusted, target, 5, CFG)
    ref_skip = jhz.verify_skip_hashes(jhz.HashBundle.from_dict(skip_bundle.to_dict()), CHAIN_ID, trusted, target, 5, JCFG)
    assert port_skip is not None and ref_skip is not None
    assert port_skip.target_encodings == ref_skip.target_encodings
    port_step = hz.verify_step_hashes(hz.HashBundle.from_dict(jstep.to_dict()), CHAIN_ID, prev, nxt, 4, CFG)
    ref_step = jhz.verify_step_hashes(jhz.HashBundle.from_dict(step_bundle.to_dict()), CHAIN_ID, prev, nxt, 4, JCFG)
    assert port_step is not None and ref_step is not None
    assert port_step.validators_hash == ref_step.validators_hash == chain.vhash
