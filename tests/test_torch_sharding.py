"""The port's lane mesh (tendermintx_tpu_torch/parallel) on a CPU device
list against the JAX package's sharded functions on its 8-device virtual
CPU mesh (tests/conftest.py), and each sharded phase of the prover against
the port's single-device function. Exact equality throughout: integer
field arithmetic has no tolerance."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax

from tendermintx_tpu.circuits.variables import pack_validator_lanes as j_pack_lanes
from tendermintx_tpu.inputs.conversion import get_validator_data_from_block as j_lane_data
from tendermintx_tpu.inputs.testchain import TestChain as JTestChain
from tendermintx_tpu.ops import ntt as jntt
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.parallel import sharding as jsh
from tendermintx_tpu_torch.circuits import gadgets as g
from tendermintx_tpu_torch.circuits.variables import pack_validator_lanes
from tendermintx_tpu_torch.inputs.conversion import get_validator_data_from_block
from tendermintx_tpu_torch.inputs.testchain import TestChain
from tendermintx_tpu_torch.ops import ntt as nttmod
from tendermintx_tpu_torch.ops import poseidon as ps
from tendermintx_tpu_torch.ops.ext import GF2
from tendermintx_tpu_torch.ops.goldilocks import GF, P
from tendermintx_tpu_torch.parallel import prover as shp
from tendermintx_tpu_torch.parallel.sharding import (
    LaneMesh,
    all_to_all,
    chunked_u64_psum,
    make_lane_mesh,
    mesh_device,
    ppermute,
    sharded_lane_checks,
    sharded_poseidon_throughput,
    sharded_sha256,
)
from tendermintx_tpu_torch.stark import fri
from tendermintx_tpu_torch.stark import prover as pr
from tendermintx_tpu_torch.stark.sha256_air import Sha256Air, schedule_messages, sha256_batch_trace

CPU = torch.device("cpu")
MESH8 = LaneMesh([CPU] * 8)
MESH2 = LaneMesh([CPU] * 2)
MESH1 = LaneMesh([CPU])  # the prover's path without mesh=


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "tests need the virtual 8-device mesh"
    return jsh.make_lane_mesh(8)


def _field(rng, shape) -> np.ndarray:
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def _gf(rng, shape) -> GF:
    return GF.from_u64(_field(rng, shape))


def _gf2(rng, shape) -> GF2:
    return GF2(_gf(rng, shape), _gf(rng, shape))


def _eq(a: GF, b: GF):
    assert torch.equal(a.v, b.v)


def _eq2(a: GF2, b: GF2):
    _eq(a.c0, b.c0)
    _eq(a.c1, b.c1)


def _gather2(mesh, blocks) -> GF2:
    return GF2(GF(mesh.gather([b.c0.v for b in blocks])), GF(mesh.gather([b.c1.v for b in blocks])))


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------


def test_make_lane_mesh_needs_cuda_or_an_explicit_list():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_lane_mesh(4)
    mesh = make_lane_mesh(4, [CPU] * 8)
    assert mesh.devices == (CPU,) * 4 == LaneMesh(["cpu"] * 4).devices
    with pytest.raises(ValueError):
        make_lane_mesh(9, [CPU] * 8)
    with pytest.raises(TypeError):
        mesh_device(None, None)
    assert mesh_device("cpu", mesh) == CPU
    assert mesh_device(None, mesh) == CPU


def test_collectives_follow_the_reference_semantics():
    D = 4
    mesh = LaneMesh([CPU] * D)
    shards = [torch.arange(8).reshape(2, 4) + 100 * d for d in range(D)]
    # ppermute: pairs move whole shards, unpaired devices receive zeros
    out = ppermute(mesh, shards, [(0, 1), (1, 2)])
    assert torch.equal(out[1], shards[0]) and torch.equal(out[2], shards[1])
    assert not out[0].any() and not out[3].any()
    # tiled all_to_all: device j gets block j of every source, source-major
    a2a = all_to_all(mesh, shards, split_dim=1, concat_dim=0)
    for j in range(D):
        assert torch.equal(a2a[j], torch.cat([s[:, j : j + 1] for s in shards], dim=0))


@pytest.mark.parametrize("case", ["near_2_60", "every_chunk_carries", "wraps_2_64"])
def test_chunked_psum_is_the_exact_u64_sum(case):
    rng = np.random.default_rng(5)
    n = 16
    if case == "near_2_60":
        vals = [(1 << 56) - int(rng.integers(0, 1 << 20)) for _ in range(n)]
    elif case == "every_chunk_carries":
        vals = [0xFFFF_FFFF_FFFF_FFFF >> 4] * n  # every 16-bit chunk of both limbs full
    else:
        vals = [(1 << 63) - 1 - i for i in range(n)]  # total beyond 2^64
    lo = torch.tensor([v & 0xFFFFFFFF for v in vals])
    hi = torch.tensor([v >> 32 for v in vals])
    for mesh in (MESH8, MESH2):
        parts = [g.u64_sum_masked(l, h, torch.ones_like(l, dtype=torch.bool)) for l, h in
                 zip(mesh.split(lo), mesh.split(hi))]
        s_lo, s_hi = chunked_u64_psum(mesh, [p[0] for p in parts], [p[1] for p in parts])
        assert (int(s_hi) << 32 | int(s_lo)) == sum(vals) % (1 << 64)


def test_sharded_poseidon_matches_jax(jmesh):
    rng = np.random.default_rng(3)
    states = [[int(rng.integers(0, 2**63)) % P for _ in range(12)] for _ in range(64)]
    arr = np.array(states, dtype=object)
    want = jsh.sharded_poseidon_throughput(jmesh)(JGF.from_ints(arr)).to_ints()
    for mesh in (MESH8, MESH2):
        got = sharded_poseidon_throughput(mesh)(GF.from_ints(arr)).to_ints()
        assert got.tolist() == want.tolist()
    assert ps.permute(GF.from_ints(arr)).to_ints().tolist() == want.tolist()


def test_sharded_sha256_matches_single():
    from tendermintx_tpu_torch.ops import sha256

    blocks, n_active = sha256.pad_messages([bytes([i]) * (3 + 9 * i) for i in range(8)])
    assert torch.equal(sharded_sha256(MESH8)(blocks, n_active), sha256.sha256_blocks(blocks, n_active))


# ---------------------------------------------------------------------------
# Lane checks against the JAX package's sharded_lane_checks
# ---------------------------------------------------------------------------


def _lanes(testchain, lane_data, pack):
    chain = testchain(n_validators=13, powers=[7 + i for i in range(13)])
    h = chain.extend(signers=list(range(11)))
    return chain, pack(lane_data(chain.val_set, chain.commits[h], chain.chain_id, 16))


LANE_FIELDS = (
    "table_x", "table_y", "table_t", "bits2", "rx", "ry", "sig_r", "sig_s", "sig_pubkeys",
    "messages", "msg_len", "k_q", "leaf_bytes", "leaf_len", "vp_lo", "vp_hi", "signed", "enabled",
)


@pytest.fixture(scope="module")
def lanes():
    chain, lv = _lanes(TestChain, get_validator_data_from_block, pack_validator_lanes)
    _, jlv = _lanes(JTestChain, j_lane_data, j_pack_lanes)
    return chain, [getattr(lv, f) for f in LANE_FIELDS], [getattr(jlv, f) for f in LANE_FIELDS]


@pytest.fixture(scope="module")
def j_lane_checks(jmesh):
    """The JAX package's sharded lane checks, compiled once for the file."""
    return jax.jit(jsh.sharded_lane_checks(jmesh))


def _power(pair) -> int:
    return int(pair[0]) | (int(pair[1]) << 32)


def _run_both(j_lane_checks, args, jargs):
    want = j_lane_checks(*jargs)
    got = sharded_lane_checks(MESH8)(*args)
    assert bool(got[0]) == bool(want[0])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert _power(got[2]) == _power(want[2]) and _power(got[3]) == _power(want[3])
    return got


def test_sharded_lane_checks_match_jax(j_lane_checks, lanes):
    chain, args, jargs = lanes
    sig_ok, digests, signed, total = _run_both(j_lane_checks, args, jargs)
    assert bool(sig_ok)
    assert torch.equal(digests, g.hash_validator_leaves(args[12], args[13]))
    assert _power(total) == sum(v.voting_power for v in chain.val_set)
    assert _power(signed) == sum(chain.val_set[i].voting_power for i in range(11))
    two = sharded_lane_checks(MESH2)(*args)
    assert bool(two[0]) and torch.equal(two[1], digests) and _power(two[3]) == _power(total)


def test_tampered_signature_fails_in_both(j_lane_checks, lanes):
    _, args, jargs = lanes
    i = LANE_FIELDS.index("sig_s")
    args, jargs = list(args), list(jargs)
    args[i] = args[i].clone()
    args[i][3, 0] ^= 1
    jarr = np.asarray(jargs[i]).copy()
    jarr[3, 0] ^= 1
    jargs[i] = jax.numpy.asarray(jarr)
    sig_ok, *_ = _run_both(j_lane_checks, args, jargs)
    assert not bool(sig_ok)


def test_edge_voting_powers_wrap_as_jax(j_lane_checks, lanes):
    """Powers near 2^60, limbs whose 16-bit chunks all carry, and a total
    beyond 2^64: the chunked psum wraps where the JAX package's does."""
    _, args, jargs = lanes
    vals = [(1 << 60) - 1 - i for i in range(8)] + [0xFFFF_FFFF_FFFF_FFFF - i for i in range(8)]
    lo = np.array([v & 0xFFFFFFFF for v in vals], dtype=np.uint32)
    hi = np.array([v >> 32 for v in vals], dtype=np.uint32)
    k = LANE_FIELDS.index("vp_lo")
    args, jargs = list(args), list(jargs)
    args[k], args[k + 1] = torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64))
    jargs[k], jargs[k + 1] = jax.numpy.asarray(lo), jax.numpy.asarray(hi)
    _, _, _, total = _run_both(j_lane_checks, args, jargs)
    enabled = args[LANE_FIELDS.index("enabled")].tolist()
    assert _power(total) == sum(v for v, e in zip(vals, enabled) if e) % (1 << 64)


# ---------------------------------------------------------------------------
# Sharded prover phases against the port's single-device functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [MESH8, MESH2], ids=["d8", "d2"])
def test_sharded_lde_and_leaves_match_single(mesh):
    rng = np.random.default_rng(7)
    cols = _gf(rng, (13, 64))  # 13 columns: not a multiple of the mesh size
    coeffs, blocks = shp.sharded_trace_lde(mesh, 2, 7)(cols)
    want_c, want_lde = pr.trace_lde(cols, 2, 7)
    _eq(coeffs, want_c)
    rows = shp.columns_to_rows(mesh, blocks, 13)
    assert all(r.v.is_contiguous() and r.shape == (13, 256 // mesh.size) for r in rows)
    _eq(GF(mesh.gather([r.v for r in rows], dim=1)), want_lde)
    _eq(shp.sharded_leaf_hashes(mesh)(rows), ps.hash_no_pad_cols(want_lde))


def _quotient_inputs(air, publics, log_n, rate_bits, shift, rng):
    """Every input of the quotient but the LDE, as _prove_statement makes
    them, with random alpha powers and challenges."""
    n = 1 << log_n
    periodic = tuple(GF.from_u64(pr._periodic_lde(tuple(p), log_n, rate_bits, shift))
                     for p in air.periodic_columns())
    pcols = air.public_columns(list(publics), n)
    public_cols = ()
    if pcols:
        _, pc = pr.trace_lde(GF.from_u64(pr.public_columns_u64(pcols, n)), rate_bits, shift)
        public_cols = tuple(pc[i] for i in range(len(pcols)))
    tz, fz, lz, cz = pr._zerofier_inverses(log_n, rate_bits, shift)
    zinvs = tuple(GF.from_u64(z) for z in (fz, tz, cz, lz))
    pub = GF.from_ints(np.array([v % P for v in publics], dtype=object))
    return _gf2(rng, (air.n_constraints,)), pub, periodic, public_cols, zinvs, _gf(rng, (0,))


def _quotient_mod_n(air, lde: GF, aux, alpha_pows, pub, periodic, public_cols, zinvs, chal, rate_bits):
    """The quotient over the whole LDE domain with the frame gathered by
    `% N` indexing: the reference the halo exchange must reproduce."""
    N = int(lde.shape[1])
    base = torch.arange(N)
    frame = [lde.v.index_select(1, (base + k * (1 << rate_bits)) % N) for k in air.frame_offsets]
    return pr._eval_quotient_core(
        air, GF(torch.stack(frame)), alpha_pows, pub, periodic, public_cols, zinvs, chal, N
    )


def test_sharded_quotient_with_sha256_halo_matches_single():
    """Sha256Air reads rows up to offset 16: at rate 2 a 64-row halo from
    the right neighbour, the last shard's from shard 0."""
    rng = np.random.default_rng(8)
    blocks, chain_flags, _ = schedule_messages([b"ab", b"x" * 40])
    trace, publics = sha256_batch_trace(blocks, chain_flags)
    air = Sha256Air(len(blocks))
    n = int(trace.shape[1])
    log_n, rate_bits, shift = n.bit_length() - 1, 2, 7
    lde = _gf(rng, (air.n_cols, n << rate_bits))
    inputs = _quotient_inputs(air, publics, log_n, rate_bits, shift, rng)
    want = _quotient_mod_n(air, lde, None, *inputs, rate_bits)
    for mesh in (MESH1, MESH8, MESH2):
        rows = [GF(b.contiguous()) for b in mesh.split(lde.v, 1)]
        got = shp.sharded_quotient_fn(mesh, air, log_n, rate_bits)(rows, None, *inputs)
        _eq2(_gather2(mesh, got), want)


def test_sharded_deep_matches_single():
    rng = np.random.default_rng(9)
    N, n_main, n_aux, n_chunks, n_off = 512, 11, 5, 3, 2
    t, a = _gf(rng, (n_main, N)), _gf(rng, (n_aux, N))
    chunks = _gf2(rng, (n_chunks, N))
    args = (_gf2(rng, (n_off, n_main + n_aux)), _gf2(rng, (n_chunks,)), _gf2(rng, (n_off,)), _gf2(rng, (n_off, N)))
    want = pr.deep_composition(t, a, chunks, *args)

    class Shape:
        frame_offsets = [0, 1]

    for mesh in (MESH8, MESH2):
        split = lambda x: [GF(b.contiguous()) for b in mesh.split(x.v, 1)]
        cb = [GF2(c0, c1) for c0, c1 in zip(split(chunks.c0), split(chunks.c1))]
        got = shp.sharded_deep_fn(mesh, Shape, 7, 2)(split(t), split(a), cb, *args)
        _eq2(_gather2(mesh, got), want)


@pytest.mark.parametrize("log_n", [5, 7, 10])
def test_sharded_fold_matches_single(log_n):
    """Layers of 4D and more values, as fri_prove shards them; D=8 takes
    the routing's general case, D=2 its trivial one."""
    rng = np.random.default_rng(log_n)
    N = 1 << log_n
    evals, beta = _gf2(rng, (N,)), _gf2(rng, (1,))
    invx = GF.from_u64(fri._inv_x_table(log_n, 7))
    want = fri._fold_layer(evals, beta, invx)
    for mesh in (MESH8, MESH2):
        if N < 4 * mesh.size:
            continue
        blocks = [GF2(GF(a), GF(b)) for a, b in zip(mesh.split(evals.c0.v), mesh.split(evals.c1.v))]
        _eq2(_gather2(mesh, shp.sharded_fold_fn(mesh)(blocks, invx, beta)), want)


@pytest.mark.parametrize("log_n", [6, 9, 12])
def test_sharded_ntt_matches_jax(log_n):
    rng = np.random.default_rng(11)
    coeffs = np.array([int(rng.integers(0, 2**63)) % P for _ in range(1 << log_n)], dtype=object)
    want = jax.jit(jntt.ntt)(JGF.from_ints(coeffs)).to_ints()
    x = GF.from_ints(coeffs)
    assert nttmod.ntt(x).to_ints().tolist() == want.tolist()
    for mesh in (MESH8, MESH2):
        out = shp.sharded_ntt_fn(mesh, log_n)([GF(b) for b in mesh.split(x.v)])
        assert GF(mesh.gather([o.v for o in out])).to_ints().tolist() == want.tolist()
