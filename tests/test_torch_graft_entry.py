"""The port's entry points (tendermintx_tpu_torch/graft_entry.py) against
the repository root's __graft_entry__.py: entry() on the CPU gives the JAX
entry()'s (valid, header) run through jax.jit, and the multi-device dry
run passes on eight CPU shards. Exact equality: booleans and bytes."""

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


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_entry_points_refuse_without_cuda():
    with pytest.raises(RuntimeError):
        graft_entry.entry()
    with pytest.raises(RuntimeError):
        graft_entry.dryrun_multichip(4)
