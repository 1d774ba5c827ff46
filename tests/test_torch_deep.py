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


# ---------------------------------------------------------------------------
# csrc/deep.cu's wide accumulation, modelled on Python ints
# ---------------------------------------------------------------------------

M32 = (1 << 32) - 1


def _mac(w: list[int], b: int, t: int) -> list[int]:
    """csrc/deep.cu: mac, s += b * t over five 32-bit limbs: the chains of
    b0 t0 and b1 t1 (limbs 0-3, carry into limb 4), then of b0 t1 and of
    b1 t0 (limbs 1-2, carries rippled into limbs 3 and 4); a carry out of
    limb 4 is lost, as in the kernel."""
    w = list(w)
    b0, b1, t0, t1 = b & M32, b >> 32, t & M32, t >> 32

    def chain(start: int, parts: list[int]):
        carry = 0
        for i in range(start, 5):
            v = w[i] + (parts[i - start] if i - start < len(parts) else 0) + carry
            w[i], carry = v & M32, v >> 32

    chain(0, [(b0 * t0) & M32, (b0 * t0) >> 32, (b1 * t1) & M32, (b1 * t1) >> 32])
    chain(1, [(b0 * t1) & M32, (b0 * t1) >> 32])
    chain(1, [(b1 * t0) & M32, (b1 * t0) >> 32])
    return w


def _reduce(w: list[int]) -> int:
    """csrc/deep.cu: reduce, the canonical value of the five limbs:
    canon(a0 + a1 2^32) + a2 (2^32 - 1) - a3 - a4 2^32 as canonical field
    adds and subtracts."""
    x = w[0] | (w[1] << 32)
    x = x - P if x >= P else x
    x = (x + w[2] * M32) % P
    x = (x - w[3]) % P
    return (x - (w[4] << 32)) % P


def _limbs(v: int) -> list[int]:
    return [(v >> (32 * i)) & M32 for i in range(5)]


def _value(w: list[int]) -> int:
    return sum(x << (32 * i) for i, x in enumerate(w))


def test_deep_wide_sum_model_equals_the_canonical_sum():
    """Random canonical betas and column values (and the edge values):
    the limb chains sum exactly, and one reduction gives the field sum."""
    rng = np.random.default_rng(11)
    edges = [0, 1, P - 1, P - 2, 2**32 - 1, 2**32, 2**63 % P, P - 2**32]
    for n in (1, 2, 7, 2929):
        b = [int(v) for v in _rand((n,), rng)]
        t = [int(v) for v in _rand((n,), rng)]
        b[: len(edges)] = edges[:n]
        t[-len(edges):] = edges[-n:] if n < len(edges) else edges
        w = [0] * 5
        for bi, ti in zip(b, t):
            w = _mac(w, bi, ti)
        assert _value(w) == sum(bi * ti for bi, ti in zip(b, t))
        assert _reduce(w) == sum(bi * ti for bi, ti in zip(b, t)) % P


def test_deep_wide_sum_model_holds_at_the_column_bound():
    """Every value p - 1 at the most columns deep_cuda accepts: the sum
    (DEEP_MAX_COLUMNS (p-1)^2) stays below 2^160, the last product's chains
    carry nothing out of limb 4, and the reduction is canonical; the bound
    is within what 160 bits hold. Also 2^16 such columns summed one by
    one, and every limb at its largest."""
    cmax = pr.DEEP_MAX_COLUMNS
    top = P - 1
    before = _limbs((cmax - 1) * top * top)
    w = _mac(before, top, top)
    assert _value(w) == cmax * top * top < 1 << 160
    assert _reduce(w) == cmax * top * top % P
    assert ((1 << 160) - 1) // (top * top) >= cmax
    w = [0] * 5
    for _ in range(1 << 16):
        w = _mac(w, top, top)
    assert _value(w) == (1 << 16) * top * top and _reduce(w) == (1 << 16) * top * top % P
    full = [M32] * 5
    assert _reduce(full) == ((1 << 160) - 1) % P
