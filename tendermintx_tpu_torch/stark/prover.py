"""STARK prover: trace commit -> quotient -> DEEP composition -> FRI.

Counterpart of ``tendermintx_tpu/stark/prover.py`` (the DEEP-ALI pipeline):

  1. Column-wise iNTT + coset LDE of the trace; Poseidon Merkle commit.
  2. Constraint evaluation over the whole LDE domain (vectorised, device).
  3. Quotient Q = sum_k alpha^k C_k / Z_k, split into degree-<n chunks,
     committed.
  4. Out-of-domain values at z * g^k for every frame offset k.
  5. DEEP composition F(x) = sum_g (G(x) - G(z_g)) / (x - z_g), proven
     low-degree by FRI: ``prove`` runs one statement with its own FRI,
     ``stark/batch.py`` several statements with one batch FRI.

Device work runs eagerly; the transcript runs on the host challenger. The
statement phases are the sharded functions of parallel/prover.py: the LDEs
column-sharded, the leaf hashing, quotient and DEEP row-sharded. With
``mesh=`` (a parallel/sharding.LaneMesh) they run over its shards and the
large FRI folds are row-sharded too; without one, over a one-device mesh
of the trace's device, where every collective is the identity. The proof
bytes do not depend on the mesh.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from functools import cache

import numpy as np
import torch

from ..ops import ntt as nttmod
from ..ops.ext import GF2, ext_add, ext_mul
from ..ops.goldilocks import GF, MULTIPLICATIVE_GENERATOR, P, tensor_from_u64, to_int_array
from ..ops.merkle import MerkleTree
from .air import Air, DeviceAlgebra, Frame, public_columns_u64
from .challenger import Challenger
from .fri import FriConfig, FriProof, fri_prove

log = logging.getLogger(__name__)


@dataclass
class StarkConfig:
    rate_bits: int = 3
    n_queries: int = 32
    final_poly_len: int = 32
    proof_of_work_bits: int = 16
    shift: int = MULTIPLICATIVE_GENERATOR
    # Merkle cap height: commitments are the 2^min(cap_bits, depth) digests
    # at that depth; openings stop there
    cap_bits: int = 4

    @property
    def fri(self) -> FriConfig:
        return FriConfig(
            rate_bits=self.rate_bits,
            n_queries=self.n_queries,
            final_poly_len=self.final_poly_len,
            proof_of_work_bits=self.proof_of_work_bits,
            cap_bits=self.cap_bits,
        )


@dataclass
class StarkProof:
    n_rows: int
    public_inputs: list[int]
    trace_cap: list[list[int]]
    quotient_cap: list[list[int]]
    # ood_trace[k][i]: column i at z * g^frame_offsets[k], over [main | aux]
    ood_trace: list[list[tuple[int, int]]]
    ood_quotient: list[tuple[int, int]]
    fri_proof: FriProof
    # index -> (trace_row, trace_path, aux_row, aux_path, quot_row, quot_path)
    openings: dict
    aux_cap: list[list[int]] | None = None


# ---------------------------------------------------------------------------
# Host-side domain tables
# ---------------------------------------------------------------------------


@cache
def _domain_points(log_N: int, shift: int) -> np.ndarray:
    """shift * w_N^i for i < N, as uint64."""
    N = 1 << log_N
    w = nttmod.primitive_root_of_unity(log_N)
    pts = np.empty(N, dtype=np.uint64)
    acc = shift % P
    for i in range(N):
        pts[i] = acc
        acc = acc * w % P
    return pts


def _batch_inverse(vals: list[int]) -> list[int]:
    """Montgomery batch inversion over Python ints."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % P
    inv_all = pow(prefix[n], P - 2, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % P
        inv_all = inv_all * vals[i] % P
    return out


def deep_power_layout(
    n_cols: int, n_aux: int, n_chunks: int, n_offsets: int
) -> tuple[list[int], int, list[int]]:
    """Beta-power exponent layout for the DEEP combination (the reference's
    padded-section layout: every Merkle leaf row occupies whole 8-felt
    absorb chunks). Returns (group base exponents, chunk base exponent,
    combined-row position map)."""
    PT = -(-n_cols // 8) * 8
    PA = -(-n_aux // 8) * 8
    PQ = -(-max(n_chunks, 1) // 4) * 4
    S = PT + PA
    bases = [0] + [S + PQ + (g - 1) * S for g in range(1, n_offsets)]
    pos = [i if i < n_cols else PT + (i - n_cols) for i in range(n_cols + n_aux)]
    return bases, S, pos


def _beta_powers(beta: tuple[int, int], count: int) -> list[tuple[int, int]]:
    out = [(1, 0)]
    for _ in range(count - 1):
        out.append(ext_mul(out[-1], beta))
    return out


def periodic_interpolant(pattern: tuple[int, ...]) -> list[int]:
    """Coefficients of the degree-<p interpolant of a period-p pattern on
    the size-p subgroup (host iNTT)."""
    from .fri import _intt_ints

    return _intt_ints([v % P for v in pattern])


@cache
def _periodic_lde(pattern: tuple[int, ...], log_n: int, rate_bits: int, shift: int) -> np.ndarray:
    """Evaluations of r(x^(n/p)) over the LDE domain as uint64: x^(n/p)
    cycles with period p * 2^rate_bits, so these are the coset-LDE values
    of the interpolant over shift^(n/p) * <w_cycle>, tiled."""
    p = len(pattern)
    if p & (p - 1):
        raise ValueError("periodic pattern length must be a power of two")
    n = 1 << log_n
    coeffs = periodic_interpolant(pattern)
    N = n << rate_bits
    s_pow = pow(shift, n // p, P)
    cg = GF.from_ints(np.array([coeffs], dtype=object))
    ev = nttmod.coset_lde(cg, rate_bits, s_pow).v[0].numpy().view(np.uint64)
    return np.tile(ev, N // (p << rate_bits))


@cache
def _zerofier_inverses(log_n: int, rate_bits: int, shift: int):
    """uint64 per-point zerofier inverses on the LDE domain:
    (transition, first, last, cyclic)."""
    n = 1 << log_n
    N = n << rate_bits
    pts = [int(v) for v in _domain_points(log_n + rate_bits, shift)]
    g_last = pow(nttmod.primitive_root_of_unity(log_n), n - 1, P)
    blow = 1 << rate_bits
    # 1/(x^n - 1) is periodic with period 2^rate_bits
    zh_inv = _batch_inverse([(pow(pts[i], n, P) - 1) % P for i in range(blow)])
    zh_inv_full = [zh_inv[i % blow] for i in range(N)]
    trans = [(pts[i] - g_last) % P * zh_inv_full[i] % P for i in range(N)]
    first = _batch_inverse([(pts[i] - 1) % P for i in range(N)])
    last = _batch_inverse([(pts[i] - g_last) % P for i in range(N)])
    u = lambda v: np.array(v, dtype=np.uint64)
    return u(trans), u(first), u(last), u(zh_inv_full)


def _ext_powers_u64(base: tuple[int, int], count: int) -> tuple[np.ndarray, np.ndarray]:
    """[base^0 .. base^(count-1)] of an ext value as two uint64 arrays."""
    c0 = np.empty(count, dtype=np.uint64)
    c1 = np.empty(count, dtype=np.uint64)
    acc = (1, 0)
    for i in range(count):
        c0[i], c1[i] = acc
        acc = ext_mul(acc, base)
    return c0, c1


def _ext_list_to_gf2(vals: list[tuple[int, int]], device) -> GF2:
    c0 = np.array([v[0] % P for v in vals], dtype=np.uint64)
    c1 = np.array([v[1] % P for v in vals], dtype=np.uint64)
    return GF2(GF(tensor_from_u64(c0, device)), GF(tensor_from_u64(c1, device)))


# ---------------------------------------------------------------------------
# Device phases
# ---------------------------------------------------------------------------


def trace_lde(cols: GF, rate_bits: int, shift: int) -> tuple[GF, GF]:
    """(coefficients, coset LDE) of trace columns (n_cols, n)."""
    coeffs = nttmod.intt(cols)
    return coeffs, nttmod.coset_lde(coeffs, rate_bits, shift)


def coset_intt(evals: GF, shift: int) -> GF:
    """Coefficients of evaluations on the coset shift * <w_n>."""
    n = evals.shape[-1]
    powers = tensor_from_u64(nttmod.power_table(pow(shift, P - 2, P), n), evals.device)
    return nttmod.intt(evals) * GF(powers)


# Quotient row blocks. The reference capped the gathered frame at 2^27
# elements for a 16 GB chip. On an 80 GB H100 the frame block is 2^29
# int64 elements (4 GB). The widest AIR, Ed25519 at 128 lanes, has
# 2 offsets x ~2,930 columns = 5,860 frame values per row, so a block is
# 2^29 / 5,860 ~ 2^16 rows (4 blocks over its 2^18-row LDE). Its eager
# constraint program keeps ~30,000 int64 temporaries per row alive at its
# peak (the 15 mul witnesses' (15, 40) convolutions twice, the LogUp batch
# products, the (K, rows) constraint stack and its alpha products), about
# 5x the frame: ~24 GB per block beside ~8 GB of resident LDEs. Each plain
# field multiply adds a few short-lived temporaries of its output's size on
# top; the whole N=128 prove peaks at 38.7 GB on an 80 GB H100
# (chip_smoke.py), so one block size serves the widest AIR with room left.
_QUOTIENT_BLOCK_ELEMS = 1 << 29
# Blocks never go below this many rows (launch overhead would dominate).
_MIN_BLOCK_ROWS = 4096


def _quotient_blocks(n_offsets: int, n_total: int, N: int) -> int:
    frame_elems = n_offsets * n_total * N
    n_blocks = 1
    while frame_elems // n_blocks > _QUOTIENT_BLOCK_ELEMS and N // n_blocks > _MIN_BLOCK_ROWS:
        n_blocks *= 2
    return n_blocks


def _eval_quotient_core(
    air, stacked: GF, alpha_pows: GF2, pub: GF, periodic, public_cols, zinvs, chal: GF, N: int
) -> GF2:
    """Constraint quotient from a gathered (n_offsets, n_cols + n_aux, N)
    frame block."""
    n_cols = air.n_cols + air.n_aux_cols
    rows = [
        [GF(stacked.v[ki, i]) for i in range(n_cols)]
        for ki in range(len(air.frame_offsets))
    ]
    alg = DeviceAlgebra(N, stacked.device)
    frame = Frame(
        rows=rows,
        public=[pub[i : i + 1] for i in range(pub.shape[0])],
        periodic=list(periodic),
        public_cols=list(public_cols),
        rows_stacked=stacked,
        challenges=[chal[i : i + 1] for i in range(chal.shape[0])],
    )
    groups = [
        (air.eval_first(frame, alg), zinvs[0]),
        (air.eval_transition(frame, alg), zinvs[1]),
        (air.eval_cyclic(frame, alg), zinvs[2]),
        (air.eval_last(frame, alg), zinvs[3]),
    ]

    def to_block(c: GF) -> torch.Tensor:
        return c.v if c.v.ndim == 2 else c.v.expand(N)[None]

    czi_parts = []
    for constraints, zi in groups:
        if not constraints:
            continue
        cstack = GF(torch.cat([to_block(c) for c in constraints], dim=0))
        czi_parts.append(cstack * GF(zi.v[None, :]))
    all_czi = GF.concatenate(czi_parts, axis=0)  # (K, N)
    a0 = GF(alpha_pows.c0.v[:, None])
    a1 = GF(alpha_pows.c1.v[:, None])
    return GF2((a0 * all_czi).sum(axis=0), (a1 * all_czi).sum(axis=0))


# DEEP row blocks. The reference capped the (columns x block) working set at
# 2^25 elements (16 GB chip). Here a block holds up to 2^28 int64 elements
# per (columns x rows) tensor (2 GB): the beta-weighted column product, and
# the pairwise-sum halves it reduces through (another ~1x), so ~3 such
# tensors (~6 GB) are live at once. For Ed25519 at 128 lanes
# (~2,930 columns x 2^18 rows) that is 4 blocks of 2^16 rows.
_DEEP_BLOCK_ELEMS = 1 << 28


def deep_composition(
    trace_lde: GF, aux_lde: GF | None, chunks: GF2, betas_t: GF2, betas_q: GF2,
    g0s: GF2, invs: GF2,
) -> GF2:
    """F = sum_g (G_g(x) - G_g(z_g)) * (x - z_g)^-1 with G_g the beta-weighted
    column combination (plus the quotient chunks in group 0), by row
    blocks (pointwise in x, so blocking is exact)."""
    n_main = int(trace_lde.shape[0])
    n_total = n_main + (int(aux_lde.shape[0]) if aux_lde is not None else 0)
    N = int(trace_lde.shape[1])
    n_offsets = int(g0s.shape[0])
    n_blocks = 1
    while (n_total * N) // n_blocks > _DEEP_BLOCK_ELEMS and N // n_blocks > _MIN_BLOCK_ROWS:
        n_blocks *= 2
    B = N // n_blocks

    def weighted(bt: GF2, cols: GF) -> GF2:
        return GF2((GF(bt.c0.v[:, None]) * cols).sum(axis=0), (GF(bt.c1.v[:, None]) * cols).sum(axis=0))

    parts = []
    for bi in range(n_blocks):
        sl = slice(bi * B, (bi + 1) * B)
        tb = trace_lde[:, sl]
        F = None
        for gi in range(n_offsets):
            G = weighted(betas_t[gi][:n_main], tb)
            if aux_lde is not None:
                G = G + weighted(betas_t[gi][n_main:], aux_lde[:, sl])
            if gi == 0:
                qb = GF2(GF(betas_q.c0.v[:, None]), GF(betas_q.c1.v[:, None]))
                G = G + (qb * chunks[:, sl]).sum(axis=0)
            G = G - GF2(g0s.c0[gi : gi + 1], g0s.c1[gi : gi + 1])
            term = G * invs[gi, sl]
            F = term if F is None else F + term
        parts.append(F)
    return GF2.concatenate(parts, axis=0)


def ood_values(coeffs: GF, points: list[tuple[int, int]]) -> list[list[tuple[int, int]]]:
    """Evaluate every row polynomial of `coeffs` (C, n) at each ext point:
    sum_j c_j * pt^j with the powers built on the host."""
    n = int(coeffs.shape[1])
    out = []
    for pt in points:
        p0, p1 = _ext_powers_u64(pt, n)
        z0 = GF(tensor_from_u64(p0, coeffs.device)[None, :])
        z1 = GF(tensor_from_u64(p1, coeffs.device)[None, :])
        v0 = to_int_array((coeffs * z0).sum(axis=-1).v)
        v1 = to_int_array((coeffs * z1).sum(axis=-1).v)
        out.append([(int(a), int(b)) for a, b in zip(v0, v1)])
    return out


def ood_ext_values(coeffs: GF2, pt: tuple[int, int]) -> list[tuple[int, int]]:
    """Evaluate ext-coefficient row polynomials (K, n) at one ext point."""
    n = int(coeffs.shape[1])
    p0, p1 = _ext_powers_u64(pt, n)
    zp = GF2(
        GF(tensor_from_u64(p0, coeffs.device)[None, :]),
        GF(tensor_from_u64(p1, coeffs.device)[None, :]),
    )
    c0, c1 = (coeffs * zp).sum(axis=-1).to_ints()
    return [(int(a), int(b)) for a, b in zip(c0, c1)]


def deep_inverses(log_N: int, shift: int, zks: list[tuple[int, int]], device) -> GF2:
    """(x - z_g)^-1 over the whole LDE domain for every opening point."""
    pts = GF(tensor_from_u64(_domain_points(log_N, shift), device))[None, :]
    z = _ext_list_to_gf2(zks, device)
    c0 = pts - GF(z.c0.v[:, None])
    c1 = -GF(z.c1.v[:, None]).broadcast_to(c0.shape)
    return GF2(c0, GF(c1.v.contiguous())).inv()


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


@dataclass
class _StmtCtx:
    """What a committed statement needs after FRI query sampling: the
    trees and the LDE row blocks to gather openings from."""

    air: Air
    n: int
    N: int
    trace_tree: MerkleTree
    aux_tree: MerkleTree | None
    quot_tree: MerkleTree
    trace_cap: list
    aux_cap: list | None
    quot_cap: list
    cap_bits: int
    ood_trace: list
    ood_quotient: list
    public_inputs: list[int]
    # the LDEs as contiguous (columns, N/D) row blocks, block i on mesh
    # device i (one block without a mesh)
    trace_rows: list
    aux_rows: list | None
    quot_rows: list
    phases: list


def _prove_statement(
    air: Air,
    trace_cols: GF,
    public_inputs: list[int],
    config: StarkConfig,
    challenger: Challenger,
    shift: int | None = None,
    *,
    mesh=None,
):
    """Steps 1-5 for ONE statement against a caller-owned transcript:
    observe publics, commit trace/aux/quotient, OOD, DEEP. Returns
    (_StmtCtx, F) with F the DEEP codeword over this statement's LDE
    domain; batch.prove_batch folds every statement's F into one FRI.
    mesh: optional LaneMesh; the statement's work is sharded over it,
    what is not sharded runs on its first device (where F is returned).
    Without one the same functions run on a one-device mesh of the
    trace's device, where every collective is the identity."""
    n_cols, n = int(trace_cols.shape[0]), int(trace_cols.shape[1])
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("trace length must be a power of two")
    rate_bits = config.rate_bits
    N = n << rate_bits
    if shift is None:
        shift = config.shift
    if mesh is None:
        from ..parallel.sharding import LaneMesh

        mesh = LaneMesh([trace_cols.device])
    sh = _MeshFns(mesh, air, log_n, rate_bits, shift)
    trace_cols = GF(trace_cols.v.to(mesh.first))
    dev = trace_cols.device

    phases: list[tuple[str, float]] = []
    t0 = [time.perf_counter()]

    def mark(label: str):
        now = time.perf_counter()
        phases.append((label, now - t0[0]))
        log.debug("prove[%s n=%d]: %s %.2fs", type(air).__name__, n, label, now - t0[0])
        t0[0] = now

    challenger.observe_elements(public_inputs)

    # 1. Trace LDE + commit: column-sharded LDE, resharded to row blocks
    #    whose leaves are hashed straight from their column-major layout
    trace_coeffs, t_rows = sh.lde_rows(trace_cols)
    trace_tree = MerkleTree.from_leaves(sh.leaves(t_rows))
    trace_cap = trace_tree.cap(config.cap_bits)
    challenger.observe_cap(trace_cap)
    challenges = [challenger.sample_ext() for _ in range(air.n_challenges)]
    mark("trace-lde+commit")

    # 1b. Phase-2 (auxiliary) commitment
    n_aux = air.n_aux_cols
    aux_tree = aux_cap = a_rows = None
    all_coeffs = trace_coeffs
    if n_aux:
        gammas = [_ext_list_to_gf2([c], dev) for c in challenges]
        aux_cols = air.aux_columns(trace_cols, gammas, list(public_inputs))
        if tuple(aux_cols.shape) != (n_aux, n):
            raise ValueError(f"aux columns have shape {aux_cols.shape}")
        aux_coeffs, a_rows = sh.lde_rows(aux_cols)
        del aux_cols
        aux_tree = MerkleTree.from_leaves(sh.leaves(a_rows))
        aux_cap = aux_tree.cap(config.cap_bits)
        challenger.observe_cap(aux_cap)
        all_coeffs = GF.concatenate([trace_coeffs, aux_coeffs], axis=0)
        del aux_coeffs
        mark("aux-columns+commit")
    del trace_coeffs
    alpha = challenger.sample_ext()
    n_total = n_cols + n_aux

    # 2. Constraint evaluation on the LDE domain
    offsets = list(air.frame_offsets)
    if offsets[0] != 0:
        raise ValueError("frame_offsets must start with 0")
    a0, a1 = _ext_powers_u64(alpha, air.n_constraints)
    alpha_pows = GF2(GF(tensor_from_u64(a0, dev)), GF(tensor_from_u64(a1, dev)))
    pub_gf = GF.from_ints(np.array([v % P for v in public_inputs], dtype=object), dev) \
        if public_inputs else GF.zeros((0,), dev)
    periodic = tuple(
        GF(tensor_from_u64(_periodic_lde(tuple(p), log_n, rate_bits, shift), dev))
        for p in air.periodic_columns()
    )
    pcols = air.public_columns(list(public_inputs), n)
    if pcols:
        arr = public_columns_u64(pcols, n)
        _, pc_lde = trace_lde(GF(tensor_from_u64(arr, dev)), rate_bits, shift)
        public_cols = tuple(pc_lde[i] for i in range(len(pcols)))
    else:
        public_cols = ()
    tz, fz, lz, cz = _zerofier_inverses(log_n, rate_bits, shift)
    zinvs = tuple(GF(tensor_from_u64(z, dev)) for z in (fz, tz, cz, lz))
    chal_gf = GF.from_ints(np.array([c for ch in challenges for c in ch], dtype=object), dev) \
        if challenges else GF.zeros((0,), dev)
    q_blocks = sh.quotient(t_rows, a_rows, alpha_pows, pub_gf, periodic, public_cols, zinvs, chal_gf)
    q_evals = GF2(
        GF(mesh.gather([q.c0.v for q in q_blocks])), GF(mesh.gather([q.c1.v for q in q_blocks]))
    )
    del q_blocks
    del periodic, public_cols, zinvs

    # 3. Quotient -> coefficients -> degree-<n chunks -> LDE -> commit
    qc = coset_intt(GF.stack([q_evals.c0, q_evals.c1], axis=0), shift)
    del q_evals
    n_chunks = air.constraint_degree - 1
    if n_chunks * n > N:
        raise ValueError("rate too low for the constraint degree")
    # rows [c0_0, c1_0, c0_1, c1_1, ...]: chunk j's coefficients
    chunk_stack = GF(
        torch.stack([qc.v[:, j * n : (j + 1) * n] for j in range(n_chunks)]).reshape(2 * n_chunks, n)
    )
    chunk_lde_all = nttmod.coset_lde(chunk_stack, rate_bits, shift)
    q_rows = [GF(b.contiguous()) for b in mesh.split(chunk_lde_all.v, 1)]
    del chunk_lde_all
    quot_tree = MerkleTree.from_leaves(sh.leaves(q_rows))
    quot_cap = quot_tree.cap(config.cap_bits)
    challenger.observe_cap(quot_cap)
    z = challenger.sample_ext()
    mark("quotient+commit")

    # 4. OOD evaluations at z * g^k for every frame offset k
    g_trace = nttmod.primitive_root_of_unity(log_n)
    zk_list = [ext_mul(z, (pow(g_trace, k, P), 0)) for k in offsets]
    ood_trace = ood_values(all_coeffs, zk_list)
    del all_coeffs
    chunk_ext = GF2(chunk_stack[0::2], chunk_stack[1::2])
    ood_quot = ood_ext_values(chunk_ext, z)
    for per_offset in ood_trace:
        for v in per_offset:
            challenger.observe_ext(v)
    for v in ood_quot:
        challenger.observe_ext(v)
    mark("ood")
    beta = challenger.sample_ext()

    # 5. DEEP composition: one group per opening point; group 0 also takes
    #    the quotient chunks. Beta powers follow deep_power_layout.
    bases, chunk_base, pos = deep_power_layout(n_cols, n_aux, n_chunks, len(offsets))
    pows = _beta_powers(beta, max(bases) + chunk_base + n_chunks + 1)
    betas_t = []
    betas_q = []
    g0_list = []
    for gi in range(len(offsets)):
        row_betas = []
        G0 = (0, 0)
        for i in range(n_total):
            b_pow = pows[bases[gi] + pos[i]]
            row_betas.append(b_pow)
            G0 = ext_add(G0, ext_mul(b_pow, ood_trace[gi][i]))
        if gi == 0:
            for j in range(n_chunks):
                b_pow = pows[chunk_base + j]
                betas_q.append(b_pow)
                G0 = ext_add(G0, ext_mul(b_pow, ood_quot[j]))
        betas_t.append(row_betas)
        g0_list.append(G0)
    betas_t_gf2 = GF2.stack([_ext_list_to_gf2(r, dev) for r in betas_t], axis=0)
    invs = deep_inverses(log_n + rate_bits, shift, zk_list, dev)
    F_blocks = sh.deep(
        t_rows, a_rows, [GF2(q[0::2], q[1::2]) for q in q_rows], betas_t_gf2,
        _ext_list_to_gf2(betas_q, dev), _ext_list_to_gf2(g0_list, dev), invs,
    )
    F = GF2(GF(mesh.gather([f.c0.v for f in F_blocks])), GF(mesh.gather([f.c1.v for f in F_blocks])))
    del F_blocks, invs
    mark("deep")

    ctx = _StmtCtx(
        air=air, n=n, N=N,
        trace_tree=trace_tree, aux_tree=aux_tree, quot_tree=quot_tree,
        trace_cap=trace_cap, aux_cap=aux_cap, quot_cap=quot_cap,
        cap_bits=config.cap_bits,
        ood_trace=ood_trace, ood_quotient=ood_quot,
        public_inputs=list(public_inputs),
        trace_rows=t_rows, aux_rows=a_rows, quot_rows=q_rows,
        phases=phases,
    )
    return ctx, F


class _MeshFns:
    """The sharded phase functions of one (AIR shape, mesh) pair; the
    single-device path's mesh has one device."""

    def __init__(self, mesh, air, log_n: int, rate_bits: int, shift: int):
        from ..parallel import prover as shp

        self.mesh = mesh
        self._lde = shp.sharded_trace_lde(mesh, rate_bits, shift)
        self.leaves = shp.sharded_leaf_hashes(mesh)
        self.quotient = shp.sharded_quotient_fn(mesh, air, log_n, rate_bits)
        self.deep = shp.sharded_deep_fn(mesh, air, log_n, rate_bits)

    def lde_rows(self, cols: GF) -> tuple[GF, list]:
        """(coefficients on the first device, contiguous LDE row blocks);
        the column shards are freed once resharded."""
        from ..parallel.prover import columns_to_rows

        coeffs, col_blocks = self._lde(cols)
        return coeffs, columns_to_rows(self.mesh, col_blocks, int(cols.shape[0]))


def _statement_openings(ctx: _StmtCtx, indices) -> dict:
    """Openings at the given leaf indices: gather only the queried rows of
    the LDE row blocks and their sibling paths."""
    qs = sorted(set(int(q) for q in indices))

    def rows_at(blocks: list):
        # leaf q is column q % Nb of row block q // Nb
        nb = int(blocks[0].shape[1])
        out = np.empty((len(qs), int(blocks[0].shape[0])), dtype=object)
        for d, b in enumerate(blocks):
            ks = [k for k, q in enumerate(qs) if q // nb == d]
            if ks:
                sel = torch.tensor([qs[k] % nb for k in ks], device=b.device)
                out[ks] = to_int_array(b.v.index_select(1, sel).t())
        return out

    def paths(tree: MerkleTree):
        g, uniq, n_inner = tree.sibling_gather(qs, ctx.cap_bits)
        return MerkleTree.decode_paths(to_int_array(g.v), uniq, n_inner)

    trace_sel, trace_paths = rows_at(ctx.trace_rows), paths(ctx.trace_tree)
    quot_sel, quot_paths = rows_at(ctx.quot_rows), paths(ctx.quot_tree)
    n_aux = ctx.air.n_aux_cols
    if n_aux:
        aux_sel, aux_paths = rows_at(ctx.aux_rows), paths(ctx.aux_tree)
    openings = {}
    for k_q, q in enumerate(qs):
        openings[q] = (
            [int(v) for v in trace_sel[k_q]],
            trace_paths[q],
            [int(v) for v in aux_sel[k_q]] if n_aux else [],
            aux_paths[q] if n_aux else [],
            [int(v) for v in quot_sel[k_q]],
            quot_paths[q],
        )
    return openings


def prove(
    air: Air,
    trace_cols: GF,
    public_inputs: list[int],
    config: StarkConfig = StarkConfig(),
    transcript_seed: list[int] | None = None,
    *,
    mesh=None,
) -> StarkProof:
    """One statement, its own FRI. trace_cols: (n_cols, n_rows) GF on the
    device the proof runs on (row i = step i); n_rows a power of two >= 4.
    transcript_seed: field elements absorbed before the public inputs (the
    verifier must supply the same seed). mesh: optional
    parallel.sharding.LaneMesh: the LDEs, leaf hashing, quotient, DEEP and
    large FRI folds are sharded over it and the rest runs on its first
    device (the trace is moved there); the proof bytes are those of a
    proof without it."""
    challenger = Challenger()
    if transcript_seed:
        challenger.observe_elements(transcript_seed)
    ctx, F = _prove_statement(air, trace_cols, public_inputs, config, challenger, mesh=mesh)
    t0 = time.perf_counter()
    fri_proof = fri_prove(F, challenger, config.fri, config.shift, mesh=mesh)
    ctx.phases.append(("fri", time.perf_counter() - t0))
    del F
    t0 = time.perf_counter()
    openings = _statement_openings(ctx, fri_proof.query_indices)
    ctx.phases.append(("openings", time.perf_counter() - t0))
    log.info(
        "prove[%s n=%d N=%d cols=%d] %s total=%.2fs",
        type(air).__name__, ctx.n, ctx.N, air.n_cols + air.n_aux_cols,
        " ".join(f"{k}={v:.2f}" for k, v in ctx.phases),
        sum(v for _, v in ctx.phases),
    )
    return StarkProof(
        n_rows=ctx.n,
        public_inputs=list(public_inputs),
        trace_cap=ctx.trace_cap,
        quotient_cap=ctx.quot_cap,
        ood_trace=ctx.ood_trace,
        ood_quotient=ctx.ood_quotient,
        fri_proof=fri_proof,
        openings=openings,
        aux_cap=ctx.aux_cap,
    )
