"""The constraint quotient as a recorded tape (stark/quotient_tape.py):
for every AIR the port proves, the tape's plain executor equals the
DeviceAlgebra evaluation of stark/prover.py::_eval_quotient_core, and for
the small AIRs also the JAX package's _eval_quotient_core, on frames,
publics, periodic and public columns, challenges, zerofier inverses and
alpha powers made from a numpy seed. Exact equality: integer field
arithmetic has no tolerance. The CUDA kernel that runs the same tape is
held against the plain version in tests/test_torch_cuda.py and
chip_smoke.py, on a card."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.ext import GF2 as JGF2
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import evalair as jev
from tendermintx_tpu.stark import poseidon_air as jpa
from tendermintx_tpu.stark.prover import _eval_quotient_core as j_eval_quotient_core
from tendermintx_tpu.stark.sha256_air import Sha256Air as JSha256Air
from tendermintx_tpu_torch.graft_entry import dryrun_air
from tendermintx_tpu_torch.ops.ext import GF2
from tendermintx_tpu_torch.ops.goldilocks import GF, P, tensor_from_u64, to_int_array
from tendermintx_tpu_torch.stark import evalair as ev
from tendermintx_tpu_torch.stark import prover as pr
from tendermintx_tpu_torch.stark import quotient_tape as qtm
from tendermintx_tpu_torch.stark.air import HostAlgebra, HostFelt, Frame, constraint_count
from tendermintx_tpu_torch.stark.ed25519_air import Ed25519Air
from tendermintx_tpu_torch.stark.poseidon_air import PoseidonChainAir
from tendermintx_tpu_torch.stark.prover import StarkConfig
from tendermintx_tpu_torch.stark.recursion import WrapAir, wrap_shape
from tendermintx_tpu_torch.stark.sha256_air import Sha256Air
from tendermintx_tpu_torch.stark.sha512_air import Sha512Air

B = 32  # rows of the frame block

AIRS = {
    "poseidon_chain": PoseidonChainAir,
    "evalair": lambda: ev.EvalAir(ev.build_tape([PoseidonChainAir()])),
    "sha256": lambda: Sha256Air(2),
    "sha512": lambda: Sha512Air(2),
    "ed25519": lambda: Ed25519Air(2),
    "wrap": lambda: WrapAir(
        wrap_shape([Sha256Air(2), Ed25519Air(2), Sha512Air(2)], StarkConfig(), [128, 512, 64])
    ),
    "mix": lambda: dryrun_air(8)[0],
}
SMALL = ("poseidon_chain", "evalair", "sha256", "sha512", "wrap", "mix")


def _felts(rng, shape) -> np.ndarray:
    """Canonical uint64 felts, the edge values 0, 1 and p - 1 first."""
    u = rng.integers(0, 2**63, size=shape, dtype=np.uint64) * np.uint64(2)
    u += rng.integers(0, 2, size=shape, dtype=np.uint64)
    u[u >= np.uint64(P)] -= np.uint64(P)
    flat = u.reshape(-1)
    flat[: min(3, flat.size)] = np.array([0, 1, P - 1], dtype=np.uint64)[: min(3, flat.size)]
    return u


def _raw_inputs(air, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    K = air.n_constraints
    return {
        "stacked": _felts(rng, (len(air.frame_offsets), air.n_cols + air.n_aux_cols, B)),
        "alpha": (_felts(rng, (K,)), _felts(rng, (K,))),
        "pub": _felts(rng, (air.n_public,)),
        "periodic": [_felts(rng, (B,)) for _ in air.periodic_columns()],
        "public_cols": [_felts(rng, (air.n_public_cols, B))[i] for i in range(air.n_public_cols)],
        "zinvs": [_felts(rng, (B,)) for _ in range(4)],
        "chal": _felts(rng, (2 * air.n_challenges,)),
    }


def _port_inputs(raw: dict) -> tuple:
    g = lambda u: GF(tensor_from_u64(u))
    return (
        g(raw["stacked"]),
        GF2(g(raw["alpha"][0]), g(raw["alpha"][1])),
        g(raw["pub"]),
        tuple(g(p) for p in raw["periodic"]),
        tuple(g(p) for p in raw["public_cols"]),
        tuple(g(z) for z in raw["zinvs"]),
        g(raw["chal"]),
    )


def _jax_inputs(raw: dict) -> tuple:
    g = lambda u: JGF.from_ints(u.astype(object))
    return (
        g(raw["stacked"]),
        JGF2(g(raw["alpha"][0]), g(raw["alpha"][1])),
        g(raw["pub"]),
        tuple(g(p) for p in raw["periodic"]),
        tuple(g(p) for p in raw["public_cols"]),
        tuple(g(z) for z in raw["zinvs"]),
        g(raw["chal"]),
    )


def _ints(q: GF2) -> tuple[list[int], list[int]]:
    return [int(v) for v in to_int_array(q.c0.v)], [int(v) for v in to_int_array(q.c1.v)]


@pytest.fixture(scope="module")
def airs():
    return {name: make() for name, make in AIRS.items()}


@pytest.mark.parametrize("name", list(AIRS))
def test_tape_equals_device_algebra(airs, name):
    air = airs[name]
    args = _port_inputs(_raw_inputs(air, seed=len(name)))
    want = pr._eval_quotient_plain(air, *args, B)
    got = qtm.execute_plain(qtm.quotient_tape(air), *args)
    assert _ints(got) == _ints(want)
    # the CPU dispatch of _eval_quotient_core is the plain body, no kernel
    launches = qtm.quotient_kernel_launches
    assert _ints(pr._eval_quotient_core(air, *args, B)) == _ints(want)
    assert qtm.quotient_kernel_launches == launches


@pytest.mark.parametrize("name", SMALL)
def test_poisoned_dead_slots_change_nothing(airs, name):
    """Every slot is overwritten once its value is dead: a slot that the
    allocation frees (or reuses) while its value is still to be read
    would change the result."""
    air = airs[name]
    qt = qtm.quotient_tape(air)
    args = _port_inputs(_raw_inputs(air, seed=7))
    assert qt.n_slots < len(qt.code)
    assert sum(len(f) for f in qt.frees) > 0
    assert _ints(qtm.execute_plain(qt, *args, poison=True)) == _ints(pr._eval_quotient_plain(air, *args, B))


@pytest.mark.parametrize(
    "name, j_air",
    [
        ("poseidon_chain", lambda: jpa.PoseidonChainAir()),
        ("evalair", lambda: jev.EvalAir(jev.build_tape([jpa.PoseidonChainAir()]))),
        ("sha256", lambda: JSha256Air(2)),
    ],
)
def test_tape_equals_jax_quotient(airs, name, j_air):
    air = airs[name]
    raw = _raw_inputs(air, seed=11)
    j_out = j_eval_quotient_core(j_air(), *_jax_inputs(raw), B)
    want = tuple([int(v) for v in c] for c in j_out.to_ints())
    assert _ints(qtm.execute_plain(qtm.quotient_tape(air), *_port_inputs(raw))) == want


def _group_sizes(air) -> list[int]:
    zero = HostFelt((0, 0))
    total = air.n_cols + air.n_aux_cols
    frame = Frame(
        rows=[[zero] * total for _ in air.frame_offsets],
        public=[zero] * air.n_public,
        periodic=[zero] * len(air.periodic_columns()),
        public_cols=[zero] * air.n_public_cols,
        challenges=[zero] * (2 * air.n_challenges),
    )
    alg = HostAlgebra()
    return [
        sum(constraint_count(c) for c in fn(frame, alg))
        for fn in (air.eval_first, air.eval_transition, air.eval_cyclic, air.eval_last)
    ]


@pytest.mark.parametrize("name", list(AIRS))
def test_root_table_follows_the_constraint_order(airs, name):
    """One root per constraint, k = 0 .. n_constraints - 1, grouped first,
    transition, cyclic, last, as _eval_quotient_core stacks them; each
    root's ROOT instruction reads alpha^k once."""
    air = airs[name]
    qt = qtm.quotient_tape(air)
    assert qt.n_roots == air.n_constraints
    sizes = _group_sizes(air)
    want = np.repeat(np.arange(4), sizes)
    assert np.array_equal(qt.root_groups, want)
    ops = qt.code[:, 0] & 0xFF
    roots = qt.code[ops == qtm.ROOT]
    assert sorted(roots[:, 2].tolist()) == list(range(air.n_constraints))
    assert np.array_equal(roots[np.argsort(roots[:, 2]), 3], want)
    assert int((qt.code[:, 0] >> 8).max()) < qt.n_slots


def test_one_tape_per_cache_key(airs):
    a, b = Sha256Air(2), Sha256Air(2)
    assert ev.air_cache_key(a) == ev.air_cache_key(b)
    assert qtm.quotient_tape(a) is qtm.quotient_tape(b)
    assert qtm.quotient_tape(Sha256Air(4)) is not qtm.quotient_tape(a)
    assert qtm.quotient_tape(airs["sha512"]) is qtm.quotient_tape(Sha512Air(2))


def test_rows_per_launch_keep_the_scratch_bound():
    assert qtm.rows_per_launch(6000, 1 << 16) == 1 << 16
    for slots, rows in ((6000, 1 << 18), (100_000, 1 << 16), (10**7, 4096)):
        R = qtm.rows_per_launch(slots, rows)
        assert R % qtm.THREADS == 0 and 0 < R <= rows
        assert slots * R * 8 <= qtm.SCRATCH_BYTES or R == qtm.THREADS


def test_quotient_cuda_takes_only_cuda_tensors(airs):
    air = airs["poseidon_chain"]
    args = _port_inputs(_raw_inputs(air, seed=3))
    launches = qtm.quotient_kernel_launches
    with pytest.raises(TypeError, match="CUDA"):
        qtm.quotient_cuda(air, *args)
    assert qtm.quotient_kernel_launches == launches
    with pytest.raises(ValueError, match="shape"):
        qtm.execute_plain(qtm.quotient_tape(air), GF(args[0].v[:1]), *args[1:])
