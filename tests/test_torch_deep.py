"""The port's DEEP composition (stark/prover.py::deep_composition_plain, the
CPU path; the card's is csrc/deep.cu, tests/test_torch_cuda.py) against the
JAX package's ``_deep_core``, with and without aux columns, one and two
opening groups (and the SHA AIRs' eight), over one block, two row blocks
of the plain version and a row range split in two as the sharded prover
splits it. Tolerance: exact equality."""

import functools

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.ext import GF2 as JGF2
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import prover as jprover
from tendermintx_tpu_torch.ops.ext import GF2
from tendermintx_tpu_torch.ops.goldilocks import GF, P
from tendermintx_tpu_torch.stark import prover as pr


def _rand(shape, rng):
    return (rng.integers(0, 2**63, size=shape).astype(object) * 2 + rng.integers(0, 2, size=shape)) % P


def _inputs(n_main, n_aux, n_chunks, n_groups, N, seed):
    rng = np.random.default_rng(seed)
    n_total = n_main + n_aux
    return {
        "cols": _rand((n_total, N), rng),
        "chunks": (_rand((n_chunks, N), rng), _rand((n_chunks, N), rng)),
        "betas_t": (_rand((n_groups, n_total), rng), _rand((n_groups, n_total), rng)),
        "betas_q": (_rand((n_chunks,), rng), _rand((n_chunks,), rng)),
        "g0s": (_rand((n_groups,), rng), _rand((n_groups,), rng)),
        "invs": (_rand((n_groups, N), rng), _rand((n_groups, N), rng)),
    }


def _gf2(pair) -> GF2:
    return GF2(GF.from_ints(pair[0]), GF.from_ints(pair[1]))


def _jgf2(pair) -> JGF2:
    return JGF2(JGF.from_ints(pair[0]), JGF.from_ints(pair[1]))


def _port(x, n_main, n_aux, rows=None):
    """deep_composition_plain of the port over rows [r0, r1) (all by default)."""
    r0, r1 = rows or (0, x["cols"].shape[1])
    cols = GF.from_ints(x["cols"])
    cut = lambda g: GF2(GF(g.c0.v[..., r0:r1]), GF(g.c1.v[..., r0:r1]))
    F = pr.deep_composition_plain(
        GF(cols.v[:n_main, r0:r1]), GF(cols.v[n_main:, r0:r1]) if n_aux else None,
        cut(_gf2(x["chunks"])), _gf2(x["betas_t"]), _gf2(x["betas_q"]), _gf2(x["g0s"]), cut(_gf2(x["invs"])),
    )
    return F.c0.v, F.c1.v


def _reference(x) -> tuple[list, list]:
    n_total, N = x["cols"].shape
    n_groups = x["g0s"][0].shape[0]
    core = jax.jit(functools.partial(jprover._deep_core, n_cols=n_total, n_offsets=n_groups, N=N))
    F = core(JGF.from_ints(x["cols"]), _jgf2(x["chunks"]), _jgf2(x["betas_t"]), _jgf2(x["betas_q"]),
             _jgf2(x["g0s"]), _jgf2(x["invs"]))
    c0, c1 = F.to_ints()
    return [int(v) for v in c0], [int(v) for v in c1]


def _ints(t: torch.Tensor) -> list:
    return [int(v) for v in GF(t).to_ints()]


@pytest.mark.parametrize(
    "n_main, n_aux, n_chunks, n_groups",
    [(5, 0, 1, 1), (5, 0, 2, 2), (4, 3, 2, 1), (4, 3, 3, 2), (3, 0, 1, 8)],
    ids=["main-g1", "main-g2", "aux-g1", "aux-g2", "sha-g8"],
)
def test_deep_plain_matches_reference(n_main, n_aux, n_chunks, n_groups):
    N = 64
    x = _inputs(n_main, n_aux, n_chunks, n_groups, N, 17 * n_main + n_aux + n_groups)
    want = _reference(x)
    c0, c1 = _port(x, n_main, n_aux)
    assert (_ints(c0), _ints(c1)) == want
    # a row range split in two, as the sharded prover's row blocks split it
    halves = [_port(x, n_main, n_aux, (a, b)) for a, b in ((0, N // 2), (N // 2, N))]
    assert (_ints(torch.cat([h[0] for h in halves])), _ints(torch.cat([h[1] for h in halves]))) == want


def test_deep_plain_over_two_row_blocks_matches_reference(monkeypatch):
    """The plain version's own row blocking: two blocks of 32 rows."""
    monkeypatch.setattr(pr, "_DEEP_BLOCK_ELEMS", 7 * 32)
    monkeypatch.setattr(pr, "_MIN_BLOCK_ROWS", 32)
    x = _inputs(4, 3, 2, 2, 64, 5)
    c0, c1 = _port(x, 4, 3)
    assert (_ints(c0), _ints(c1)) == _reference(x)


def test_cpu_shard_takes_the_plain_path():
    x = _inputs(3, 2, 1, 2, 16, 9)
    before = pr.deep_kernel_launches
    cols = GF.from_ints(x["cols"])
    F = pr.deep_composition(
        GF(cols.v[:3]), GF(cols.v[3:]), _gf2(x["chunks"]), _gf2(x["betas_t"]), _gf2(x["betas_q"]),
        _gf2(x["g0s"]), _gf2(x["invs"]),
    )
    assert (F.c0.v.tolist(), F.c1.v.tolist()) == tuple(t.tolist() for t in _port(x, 3, 2))
    assert pr.deep_kernel_launches == before
