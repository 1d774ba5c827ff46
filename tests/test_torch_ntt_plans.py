"""The NTT kernel's plain twin (ops/ntt.py::schedule_twin: csrc/ntt.cu's
coset split, lines, register rounds, twists and index arithmetic as torch
ops) at every pass plan the N=128 paths run, against the plain
transforms and the JAX package's jitted prover wrappers (`_trace_lde_fn`,
`_coset_intt_fn`) and `ntt`. One row each (the plans do not depend on
the row count); the card's kernel is held against the plain versions at
these shapes in tests/test_torch_cuda.py. Tolerance: exact equality."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops import ntt as jntt
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import prover as jprover
from tendermintx_tpu_torch.ops import ntt
from tendermintx_tpu_torch.ops.goldilocks import GF, P

SHIFT = 7  # DEFAULT_COMPOSITE_CONFIG's and default_wrap_config()'s shift


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**63, size=shape).astype(object) * 2 + rng.integers(0, 2, size=shape)) % P


@pytest.mark.parametrize(
    "log_n, rate_bits, plans, against_jax",
    [
        (15, 3, ((8, 7), (9, 9)), True),  # Ed25519 / SHA-512 trace and aux, the step's SHA-256
        (16, 3, ((8, 8), (7, 6, 6)), True),  # the skip's SHA-256 plan
        (17, 4, ((9, 8), (7, 7, 7)), True),  # EvalAir
        (15, 4, ((8, 7), (7, 6, 6)), False),  # WrapAir: a 2^3-point first pass over 16 cosets
        (16, 2, ((8, 8), (9, 9)), False),  # the skip hash bundle
        (15, 2, ((8, 7), (9, 8)), False),  # the step hash bundle
    ],
)
def test_twin_trace_lde_at_n128_plans(log_n, rate_bits, plans, against_jax):
    """The trace's iNTT and coset LDE (stark/prover.py::trace_lde's two
    transforms) at the N=128 plans."""
    assert (ntt.ntt_plan(log_n), ntt.ntt_plan(log_n + rate_bits, rate_bits)) == plans
    x = _rand((1, 1 << log_n), log_n + rate_bits)
    gx = GF.from_ints(x)
    coeffs = ntt.schedule_twin("intt", gx.v)
    lde = ntt.schedule_twin("coset_lde", coeffs, rate_bits, SHIFT)
    assert torch.equal(coeffs, ntt.intt_plain(gx).v)
    assert torch.equal(lde, ntt.coset_lde_plain(GF(coeffs), rate_bits, SHIFT).v)
    if against_jax:
        jc, jl = jprover._trace_lde_fn(rate_bits, SHIFT)(JGF.from_ints(x))
        assert GF(coeffs).to_ints().tolist() == jc.to_ints().tolist()
        assert GF(lde).to_ints().tolist() == jl.to_ints().tolist()


@pytest.mark.parametrize("log_n, plan, against_jax", [(18, (9, 9), False), (19, (7, 6, 6), True),
                                                       (21, (7, 7, 7), False), (17, (9, 8), False)])
def test_twin_coset_intt_at_n128_plans(log_n, plan, against_jax):
    """The quotient's coset iNTT (two rows, shift^-i folded into the last
    pass) at the N=128 plans: Ed25519 / SHA-512, SHA-256 / WrapAir,
    EvalAir and the hash bundles."""
    assert ntt.ntt_plan(log_n) == plan
    y = _rand((2, 1 << log_n), log_n)
    pw = ntt.power_tensor(pow(SHIFT, P - 2, P), 1 << log_n, torch.device("cpu"))
    got = ntt.schedule_twin("intt", GF.from_ints(y).v, powers=pw)
    assert torch.equal(got, (ntt.intt_plain(GF.from_ints(y)) * GF(pw)).v)
    if against_jax:
        j0, j1 = jprover._coset_intt_fn(SHIFT)(JGF.from_ints(y[:1]), JGF.from_ints(y[1:]))
        assert GF(got).to_ints().tolist() == [j0.to_ints()[0].tolist(), j1.to_ints()[0].tolist()]


def test_twin_forward_ntt_at_the_four_step_plans():
    """The forward entry: the mesh's four-step NTT at 2^20 (rows of 4
    points, one row of 2^18) and the single-device 2^20 NTT it is held
    against, (7, 7, 6)."""
    assert (ntt.ntt_plan(2), ntt.ntt_plan(18), ntt.ntt_plan(20)) == ((2,), (9, 9), (7, 7, 6))
    for rows, log_n, against_jax in ((1 << 12, 2, False), (1, 18, False), (1, 20, True)):
        x = _rand((rows, 1 << log_n), rows + log_n)
        got = ntt.schedule_twin("ntt", GF.from_ints(x).v)
        assert torch.equal(got, ntt.ntt_plain(GF.from_ints(x)).v)
        if against_jax:
            assert GF(got).to_ints().tolist() == jax.jit(jntt.ntt)(JGF.from_ints(x)).to_ints().tolist()


@pytest.mark.parametrize("rows", [1, 2, 3, 508, 2031])
def test_twin_edge_rows(rows):
    """1- and 2-point rows and the main path's odd row counts, every
    entry, against the plain versions (and the JAX package's NTT)."""
    for log_n in (0, 1, 4):
        x = _rand((rows, 1 << log_n), 7 * rows + log_n)
        gx = GF.from_ints(x)
        assert torch.equal(ntt.schedule_twin("ntt", gx.v), ntt.ntt_plain(gx).v)
        assert torch.equal(ntt.schedule_twin("intt", gx.v), ntt.intt_plain(gx).v)
        for rate in (1, 3, 4):
            assert torch.equal(ntt.schedule_twin("coset_lde", gx.v, rate, SHIFT), ntt.coset_lde_plain(gx, rate, SHIFT).v)
    x = _rand((rows, 4), rows)
    got = GF(ntt.schedule_twin("ntt", GF.from_ints(x).v)).to_ints()
    assert got.tolist() == jax.jit(jntt.ntt)(JGF.from_ints(x)).to_ints().tolist()
