"""The port's entry points (tendermintx_tpu_torch/graft_entry.py) against
the repository root's __graft_entry__.py: entry() on the CPU gives the JAX
entry()'s (valid, header) run through jax.jit, and the multi-device dry
run passes on eight CPU shards in each of its shapes (the toy and full
shapes of the reference's GRAFT_DRYRUN_TOY / GRAFT_DRYRUN_FULL), each
sharded proof equal to its single-device proof; the toy statement's proof
equals the reference's. Exact equality: booleans and bytes. The full shape
and the reference's toy prove (a cold JAX compile of ~3 min on the CPU)
are slow."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax

import __graft_entry__ as jentry
from tendermintx_tpu_torch import graft_entry


def test_entry_matches_jax_entry():
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args[1:3])
    valid, header = fn(*args)
    jfn, jargs = jentry.entry()
    jvalid, jheader = jax.jit(jfn)(*jargs)
    assert bool(valid) and bool(jvalid)
    assert np.array_equal(header.numpy(), np.asarray(jheader))


def test_dryrun_multichip_on_eight_cpu_shards():
    graft_entry.dryrun_multichip(8, devices=[torch.device("cpu")] * 8)


def test_dryrun_toy_shape_through_the_cli_on_eight_cpu_shards(capsys):
    assert graft_entry.main(["--device", "cpu", "--mesh", "8", "--shape", "toy"]) == 0
    out = capsys.readouterr().out
    assert "entry() skip_verify valid: True" in out
    assert "dryrun_multichip(8, shape='toy') OK" in out


def test_dryrun_rejects_an_unknown_shape():
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(8, devices=[torch.device("cpu")] * 8, shape="huge")
    with pytest.raises(SystemExit):
        graft_entry.main(["--device", "cpu", "--mesh", "8", "--shape", "huge"])


@pytest.mark.slow
def test_dryrun_full_shape_on_eight_cpu_shards():
    graft_entry.dryrun_multichip(8, devices=[torch.device("cpu")] * 8, shape="full")


@pytest.mark.slow
def test_toy_proof_matches_reference_prove():
    """The toy statement (MixAir, 256 rows) and its proof equal the
    reference's _dryrun_air(256) proven by the JAX package."""
    from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig
    from tendermintx_tpu.stark.prover import prove as jprove
    from tendermintx_tpu.stark.serialize import stark_proof_to_dict as jto_dict
    from tendermintx_tpu_torch.stark.prover import prove
    from tendermintx_tpu_torch.stark.serialize import stark_proof_to_dict

    air, trace, publics, cfg = graft_entry.dryrun_statement("toy", "cpu")
    jair, jtrace, jpublics = jentry._dryrun_air(n_rows=256)
    assert publics == jpublics and (trace.to_ints() == jtrace.to_ints()).all()
    jcfg = JStarkConfig(rate_bits=cfg.rate_bits, n_queries=cfg.n_queries, final_poly_len=cfg.final_poly_len)
    assert jcfg == JStarkConfig(rate_bits=2, n_queries=4, final_poly_len=4)
    got = stark_proof_to_dict(prove(air, trace, publics, cfg))
    want = jto_dict(jprove(jair, jtrace, jpublics, jcfg))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_entry_points_refuse_without_cuda():
    with pytest.raises(RuntimeError):
        graft_entry.entry()
    with pytest.raises(RuntimeError):
        graft_entry.dryrun_multichip(4)
