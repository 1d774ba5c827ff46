"""Composite proofs over the port's lane mesh: an N=2 skip composite
proven with ``mesh=`` on eight CPU shards must serialize byte-identically
to the port's single-device proof (tests/test_torch_composite.py holds
that equal to the JAX package's) and verify; a toy recursion wrap with
``mesh=`` must equal the one without. The comparison with the JAX
package's own mesh prover is slow (minutes of XLA compiles). Exact
equality: the wire bytes are integers."""

import json

import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu_torch.circuits.composite import prove_skip_composite, verify_skip_composite
from tendermintx_tpu_torch.inputs.fetcher import InputDataFetcher, InputDataMode
from tendermintx_tpu_torch.inputs.testchain import TestChain
from tendermintx_tpu_torch.ops.goldilocks import GF
from tendermintx_tpu_torch.parallel.sharding import LaneMesh
from tendermintx_tpu_torch.stark import recursion as rec
from tendermintx_tpu_torch.stark.batch import prove_batch
from tendermintx_tpu_torch.stark.prover import StarkConfig
from tendermintx_tpu_torch.stark.serialize import wrapped_batch_to_dict

import test_torch_recursion as toy

CHAIN_ID = "mesh-chain"
# the reduced config of the JAX package's mesh composite test
# (tests/test_sharding.py), 72 conjectured bits: the verifier floor is
# passed explicitly
CFG = StarkConfig(rate_bits=2, n_queries=28, final_poly_len=64)
MESH8 = LaneMesh([torch.device("cpu")] * 8)


def _skip_inputs(fixture_dir: str, testchain=TestChain, fetcher_cls=InputDataFetcher, mode=InputDataMode):
    chain = testchain(n_validators=2, chain_id=CHAIN_ID)
    for _ in range(4):
        chain.extend()
    chain.write_fixtures(fixture_dir)
    f = fetcher_cls(fixture_path=fixture_dir, mode=mode.FIXTURE)
    trusted = chain.headers[1].hash()
    return chain, trusted, f.get_skip_inputs(1, trusted, 4, max_validators=2)


@pytest.fixture(scope="module")
def composites(tmp_path_factory):
    chain, trusted, inputs = _skip_inputs(str(tmp_path_factory.mktemp("mesh-chain")))
    single = prove_skip_composite(1, trusted, 4, inputs, CFG, device="cpu")
    sharded = prove_skip_composite(1, trusted, 4, inputs, CFG, mesh=MESH8)
    return chain, trusted, single, sharded


def test_sharded_composite_byte_identical_to_single(composites):
    _, _, single, sharded = composites
    assert sharded.to_bytes() == single.to_bytes()


def test_sharded_composite_verifies(composites):
    chain, trusted, _, sharded = composites
    out = verify_skip_composite(sharded, CHAIN_ID, 100, config=CFG, min_security_bits=0)
    assert out == (1, trusted, 4, chain.headers[4].hash())


def test_mesh_and_device_must_agree(composites):
    chain, trusted, single, _ = composites
    with pytest.raises(ValueError):
        rec.wrap_batch([], single.batch, CFG, device="meta", mesh=MESH8)


def test_toy_wrap_with_mesh_equals_unsharded():
    cols, publics = toy._toy_inputs()
    airs = [toy.MixAir(), toy.MixAir()]
    base = prove_batch(airs, [GF.from_ints(c) for c in cols], publics, toy.CFG, transcript_seed=toy.SEED)
    kw = dict(transcript_seed=toy.SEED, wrap_config=toy.WRAP_CFG)
    plain = rec.wrap_batch(airs, base, toy.CFG, device="cpu", **kw)
    sharded = rec.wrap_batch(airs, base, toy.CFG, mesh=MESH8, **kw)
    dump = lambda w: json.dumps(wrapped_batch_to_dict(w), sort_keys=True)
    assert dump(sharded) == dump(plain)
    assert toy._verify(sharded)


@pytest.mark.slow
def test_sharded_composite_byte_identical_to_jax_mesh(composites, tmp_path):
    """The JAX package's prove_skip_composite(mesh=) on its 8-device
    virtual CPU mesh gives the port's mesh proof's bytes."""
    import jax

    from tendermintx_tpu.circuits.composite import prove_skip_composite as j_prove
    from tendermintx_tpu.inputs.fetcher import InputDataFetcher as JFetcher
    from tendermintx_tpu.inputs.fetcher import InputDataMode as JMode
    from tendermintx_tpu.inputs.testchain import TestChain as JTestChain
    from tendermintx_tpu.parallel.sharding import make_lane_mesh as j_make_lane_mesh
    from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig

    _, trusted, _, sharded = composites
    _, jtrusted, jinputs = _skip_inputs(str(tmp_path), JTestChain, JFetcher, JMode)
    assert jtrusted == trusted
    jcfg = JStarkConfig(rate_bits=2, n_queries=28, final_poly_len=64)
    assert len(jax.devices()) >= 8
    jproof = j_prove(1, jtrusted, 4, jinputs, config=jcfg, mesh=j_make_lane_mesh(8))
    assert json.dumps(jproof.to_dict(), sort_keys=True) == json.dumps(sharded.to_dict(), sort_keys=True)
