"""The constraint quotient as a recorded tape (stark/quotient_tape.py):
for every AIR the port proves, the tape's plain executor, reading the
frame from LDE row blocks and halos as the CUDA kernel does, equals the
DeviceAlgebra evaluation of stark/prover.py::_eval_quotient_plain over the
gathered frame (on one shard and on four CPU shards of a LaneMesh, with
rows whose frame crosses into the halo), and for the small AIRs also the
JAX package's _eval_quotient_core, on LDE columns, publics, periodic and
public columns, challenges, zerofier inverses and alpha powers made from a
numpy seed. Exact equality: integer field arithmetic has no tolerance. The
schedule's slot counts at the N=128 shapes and the kernel's launch sizing
are checked here; the CUDA kernel that runs the same tape is held against
the plain version in tests/test_torch_cuda.py and chip_smoke.py, on a
card."""

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
from tendermintx_tpu_torch.parallel import prover as shp
from tendermintx_tpu_torch.parallel.sharding import LaneMesh
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

# the LDE domain of the parity inputs: N rows at blowup 2, so SHA-256's
# offset 16 reads 32 rows ahead, a whole shard of a four-shard mesh
LOG_N, RATE_BITS = 6, 1
N = 1 << (LOG_N + RATE_BITS)
BLOWUP = 1 << RATE_BITS
CPU = torch.device("cpu")

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
        "lde": _felts(rng, (air.n_cols + air.n_aux_cols, N)),
        "alpha": (_felts(rng, (K,)), _felts(rng, (K,))),
        "pub": _felts(rng, (air.n_public,)),
        "periodic": [_felts(rng, (N,)) for _ in air.periodic_columns()],
        "public_cols": [_felts(rng, (air.n_public_cols, N))[i] for i in range(air.n_public_cols)],
        "zinvs": [_felts(rng, (N,)) for _ in range(4)],
        "chal": _felts(rng, (2 * air.n_challenges,)),
    }


def _gathered(air, raw: dict, r0: int = 0, r1: int = N) -> np.ndarray:
    """The (n_offsets, columns, r1 - r0) frame of global rows [r0, r1),
    gathered from the whole LDE by `% N` indexing."""
    rows = np.arange(r0, r1)
    return np.stack([raw["lde"][:, (rows + k * BLOWUP) % N] for k in air.frame_offsets])


def _vec_inputs(raw: dict) -> tuple:
    """alpha powers, publics, periodic and public columns, zinvs, challenges."""
    g = lambda u: GF(tensor_from_u64(u))
    return (
        GF2(g(raw["alpha"][0]), g(raw["alpha"][1])),
        g(raw["pub"]),
        tuple(g(p) for p in raw["periodic"]),
        tuple(g(p) for p in raw["public_cols"]),
        tuple(g(z) for z in raw["zinvs"]),
        g(raw["chal"]),
    )


def _sliced(vecs: tuple, r0: int, r1: int) -> tuple:
    alpha, pub, periodic, public_cols, zinvs, chal = vecs
    cut = lambda group: tuple(GF(v.v[r0:r1]) for v in group)
    return alpha, pub, cut(periodic), cut(public_cols), cut(zinvs), chal


def _shards(air, raw: dict, mesh: LaneMesh) -> list:
    """The mesh's LdeShards of the whole LDE, as the prover makes them."""
    lde = tensor_from_u64(raw["lde"])
    trace = [GF(b.contiguous()) for b in mesh.split(lde[: air.n_cols], 1)]
    aux = [GF(b.contiguous()) for b in mesh.split(lde[air.n_cols :], 1)] if air.n_aux_cols else None
    return shp.lde_shards_fn(mesh, air, LOG_N, RATE_BITS)(trace, aux)


def _want(air, raw: dict, vecs: tuple, r0: int, r1: int):
    """_eval_quotient_plain over the gathered frame of global rows [r0, r1)."""
    stacked = GF(tensor_from_u64(_gathered(air, raw, r0, r1)))
    return pr._eval_quotient_plain(air, stacked, *_sliced(vecs, r0, r1), r1 - r0)


def _jax_inputs(air, raw: dict) -> tuple:
    g = lambda u: JGF.from_ints(u.astype(object))
    return (
        g(_gathered(air, raw)),
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
    """One shard of N rows: its last rows read the halo, which on one
    device is the shard's own leading rows (a view)."""
    air = airs[name]
    raw = _raw_inputs(air, seed=len(name))
    vecs = _vec_inputs(raw)
    (shard,) = _shards(air, raw, LaneMesh([CPU]))
    want = _want(air, raw, vecs, 0, N)
    got = qtm.execute_plain(qtm.quotient_tape(air), shard, *vecs)
    assert _ints(got) == _ints(want)
    # the CPU dispatch of _eval_quotient_core is the plain body, no kernel
    launches = qtm.quotient_kernel_launches
    stacked = GF(tensor_from_u64(_gathered(air, raw)))
    assert _ints(pr._eval_quotient_core(air, stacked, *vecs, N)) == _ints(want)
    assert qtm.quotient_kernel_launches == launches


@pytest.mark.parametrize("name", list(AIRS))
def test_tape_over_four_shards_reads_the_halo(airs, name):
    """Four CPU shards of a LaneMesh, the halos brought by the prover's
    ppermute: row ranges of an inner shard and of the last one (whose
    halo is shard 0's leading rows) whose frames cross the block's end,
    each shard given its own rows of the row inputs."""
    air = airs[name]
    raw = _raw_inputs(air, seed=40 + len(name))
    vecs = _vec_inputs(raw)
    mesh = LaneMesh([CPU] * 4)
    shards = _shards(air, raw, mesh)
    nb = N // 4
    qt = qtm.quotient_tape(air)
    for d, (r0, r1) in ((1, (nb // 2, nb)), (3, (5, nb))):
        got = qtm.execute_plain(qt, shards[d], *_sliced(vecs, d * nb, (d + 1) * nb), (r0, r1))
        assert _ints(got) == _ints(_want(air, raw, vecs, d * nb + r0, d * nb + r1)), d


@pytest.mark.parametrize("name", SMALL)
def test_poisoned_dead_slots_change_nothing(airs, name):
    """Every slot is overwritten once its value is dead: a slot that the
    allocation frees (or reuses) while its value is still to be read
    would change the result."""
    air = airs[name]
    qt = qtm.quotient_tape(air)
    raw = _raw_inputs(air, seed=7)
    vecs = _vec_inputs(raw)
    (shard,) = _shards(air, raw, LaneMesh([CPU]))
    assert qt.n_slots < len(qt.code)
    assert sum(len(f) for f in qt.frees) > 0
    got = qtm.execute_plain(qt, shard, *vecs, poison=True)
    assert _ints(got) == _ints(_want(air, raw, vecs, 0, N))


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
    j_out = j_eval_quotient_core(j_air(), *_jax_inputs(air, raw), N)
    want = tuple([int(v) for v in c] for c in j_out.to_ints())
    (shard,) = _shards(air, raw, LaneMesh([CPU]))
    assert _ints(qtm.execute_plain(qtm.quotient_tape(air), shard, *_vec_inputs(raw))) == want


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


def test_n128_tapes_fit_shared_memory():
    """The clustered schedule keeps the N=128 paths' widest tapes within
    256 value slots, so the kernel holds every slot in shared memory."""
    for air in (Ed25519Air(128), Sha256Air(1024), Sha512Air(256)):
        qt = qtm.quotient_tape(air)
        assert qt.n_slots <= 256, (type(air).__name__, qt.n_slots)
        shape = qtm.launch_shape(qt.row_words, qt.n_uniform)
        assert shape["blocks_per_sm"] >= 2
        c = qt.counts()
        assert c["reads"]["trace"] > 0 and c["reads"]["slot"] > 0
        assert 0 < c["loads"]["trace"] <= c["reads"]["trace"]
        assert c["bundles"] < c["instructions"] - c["roots"]


def test_chunks_cover_the_tape():
    """Chunks tile the instructions in order, each within TAPE_CHUNK
    instructions and LOAD_CAP loads, never splitting a bundle; their
    roots follow one another in tape order; the load lists hold per-row
    sources only."""
    qt = qtm.quotient_tape(Sha512Air(2))
    ops = qt.code[:, 0] & 7
    widths = np.where(ops == qtm.ROOT, 1, ((qt.code[:, 0] >> 3) & 7) + 1)
    t = q = l = 0
    for i0, ni, l0, nl, q0, nq, _, _ in qt.chunks.tolist():
        assert (i0, l0, q0) == (t, l, q)
        assert 0 < ni <= qtm.TAPE_CHUNK and 0 <= nl <= qtm.LOAD_CAP
        u = i0
        while u < i0 + ni:  # bundle leaders only, whole bundles
            u += int(widths[u])
        assert u == i0 + ni
        assert nq == int((ops[i0 : i0 + ni] == qtm.ROOT).sum())
        t, l, q = t + ni, l + nl, q + nq
    assert (t, l, q) == (len(qt.code), len(qt.loads), qt.n_roots)
    assert set((qt.loads & 7).tolist()) <= {qtm.ROW, qtm.TRACE, qtm.AUX}
    assert np.array_equal(qt.root_order, qt.code[ops == qtm.ROOT, 2])


@pytest.mark.parametrize("name", ["sha256", "ed25519"])
def test_load_addresses_read_the_frame(airs, name):
    """The per-launch address table the kernel reads its loads through:
    for every load word and a row of each shard (inside the block, and
    where the offset reaches into the halo), the 8 bytes at the chosen
    address (block or halo, by whether row + shift stays in the block),
    plus 8 * row, are the frame value the plain twin reads (here on CPU
    tensors, read back through ctypes)."""
    import ctypes

    air = airs[name]
    raw = _raw_inputs(air, seed=9)
    vecs = _vec_inputs(raw)
    qt = qtm.quotient_tape(air)
    loads = torch.from_numpy(qt.loads)
    nb = N // 4
    for d, shard in enumerate(_shards(air, raw, LaneMesh([CPU] * 4))):
        rowvecs = qtm._rowvecs(*_sliced(vecs, d * nb, (d + 1) * nb)[2:5])[: qt.zinv_base]
        table = qtm._load_addresses(qt, loads, shard, rowvecs).tolist()
        for r in (0, nb - 1):
            for j, w in enumerate(qt.loads.tolist()):
                mode, idx = w & 7, w >> 3
                shift = qt.offsets[idx & 15] * BLOWUP if mode != qtm.ROW else 0
                addr = table[j][0 if r + shift < nb else 1] + 8 * r
                got = ctypes.c_int64.from_address(addr).value
                if mode == qtm.ROW:
                    want = int(rowvecs[idx][r])
                else:
                    block, halo = (shard.trace, shard.trace_halo) if mode == qtm.TRACE else (shard.aux, shard.aux_halo)
                    want = int(qtm._frame_rows(block.v, halo.v, idx >> 4, r + shift, r + shift + 1)[0])
                assert got == want, (d, r, j, w)


def test_launch_shape_sizes_rows_and_shared_bytes():
    """Rows a block and shared bytes follow the kernel's layout, keep the
    most rows resident on an SM, and a tape beyond shared memory raises:
    there is no spill tier."""
    for words, uniform in ((37, 3), (70, 40), (109, 78), (292, 80), (800, 2)):
        shape = qtm.launch_shape(words, uniform)
        t = shape["threads"]
        assert t in qtm.THREAD_CHOICES
        assert shape["shared_bytes"] == qtm.shared_bytes(words, uniform, t) <= qtm.SMEM_PER_BLOCK
        assert shape["shared_bytes"] >= 8 * words * t
        for other in qtm.THREAD_CHOICES:
            smem = qtm.shared_bytes(words, uniform, other)
            if smem <= qtm.SMEM_PER_BLOCK:
                fit = min(qtm.SMEM_PER_SM // (smem + qtm.SMEM_RESERVED), qtm.MAX_THREADS_PER_SM // other)
                assert fit * other <= shape["resident_rows"]
    with pytest.raises(ValueError, match="shared memory"):
        qtm.launch_shape(900, 2)


def test_quotient_cuda_takes_only_cuda_tensors(airs):
    air = airs["poseidon_chain"]
    raw = _raw_inputs(air, seed=3)
    vecs = _vec_inputs(raw)
    (shard,) = _shards(air, raw, LaneMesh([CPU]))
    launches = qtm.quotient_kernel_launches
    with pytest.raises(TypeError, match="CUDA"):
        qtm.quotient_cuda(air, shard, *vecs)
    assert qtm.quotient_kernel_launches == launches
    narrow = qtm.LdeShard(GF(shard.trace.v[:1]), None, shard.trace_halo, None, BLOWUP)
    with pytest.raises(ValueError, match="shape"):
        qtm.execute_plain(qtm.quotient_tape(air), narrow, *vecs)
    with pytest.raises(ValueError, match="row range"):
        qtm.execute_plain(qtm.quotient_tape(air), shard, *vecs, (0, N + 1))
    with pytest.raises(ValueError, match="row input"):
        qtm.execute_plain(qtm.quotient_tape(air), shard, *_sliced(vecs, 0, N // 2))
