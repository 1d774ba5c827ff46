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

import ctypes
import logging
import time
from dataclasses import dataclass
from functools import cache

import numpy as np
import torch

from ..ops import ntt as nttmod
from ..ops.ext import GF2, W, ext_add, ext_mul
from ..ops.goldilocks import GF, MULTIPLICATIVE_GENERATOR, P, tensor_from_u64, tensor_to_u64, to_int_array
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
    """Coefficients of evaluations on the coset shift * <w_n>: the inverse
    NTT with shift^-i folded into coefficient i (on a card, in the
    kernel's last pass)."""
    n = evals.shape[-1]
    return nttmod.intt(evals, GF(nttmod.power_tensor(pow(shift, P - 2, P), n, evals.device)))


# Quotient row blocks of a CPU shard (a CUDA shard is one launch of the
# tape kernel, stark/quotient_tape.py, which reads the frame straight from
# the LDE row blocks). The reference capped the gathered frame at 2^27
# elements for a 16 GB chip; here a block is 2^29 int64 elements (4 GB).
# The widest AIR, Ed25519 at 128 lanes, has 2 offsets x ~2,930 columns =
# 5,860 frame values per row, so a block is 2^29 / 5,860 ~ 2^16 rows (4
# blocks over its 2^18-row LDE). The plain DeviceAlgebra program keeps
# ~30,000 int64 temporaries per row alive at its peak (the 15 mul
# witnesses' (15, 40) convolutions twice, the LogUp batch products, the
# (K, rows) constraint stack and its alpha products), about 5x the frame.
_QUOTIENT_BLOCK_ELEMS = 1 << 29
# Blocks never go below this many rows.
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
    CPU frame block: the plain DeviceAlgebra evaluation. On a card the
    quotient never gathers its frame: parallel/prover.py::sharded_quotient_fn
    launches the tape kernel on the LDE row blocks
    (stark/quotient_tape.py::quotient_cuda)."""
    if stacked.device.type != "cpu":
        raise ValueError(
            f"no gathered-frame quotient for device {stacked.device}: a card's quotient is "
            "quotient_tape.quotient_cuda over the LDE row blocks"
        )
    return _eval_quotient_plain(air, stacked, alpha_pows, pub, periodic, public_cols, zinvs, chal, N)


def _eval_quotient_plain(
    air, stacked: GF, alpha_pows: GF2, pub: GF, periodic, public_cols, zinvs, chal: GF, N: int
) -> GF2:
    """The quotient's plain version: the AIR evaluated under DeviceAlgebra
    as int64 torch ops over the block's rows (any device)."""
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


# DEEP row blocks of the plain version. The reference capped the (columns
# x block) working set at 2^25 elements (16 GB chip). Here a block holds up
# to 2^28 int64 elements per (columns x rows) tensor (2 GB): the
# beta-weighted column product, and the pairwise-sum halves it reduces
# through (another ~1x), so ~3 such tensors (~6 GB) are live at once. For
# Ed25519 at 128 lanes (~2,930 columns x 2^18 rows) that is 4 blocks of
# 2^16 rows. A card's DEEP is one kernel launch a shard, with no blocks.
_DEEP_BLOCK_ELEMS = 1 << 28


def deep_composition(
    trace_lde: GF, aux_lde: GF | None, chunks: GF2, betas_t: GF2, betas_q: GF2,
    g0s: GF2, invs: GF2,
) -> GF2:
    """F = sum_g (G_g(x) - G_g(z_g)) * (x - z_g)^-1 with G_g the beta-weighted
    column combination (plus the quotient chunks in group 0), over one
    shard's rows: the plain version for a CPU shard, one launch of the
    DEEP kernel (csrc/deep.cu) for a CUDA shard."""
    t = trace_lde.device.type
    if t == "cpu":
        return deep_composition_plain(trace_lde, aux_lde, chunks, betas_t, betas_q, g0s, invs)
    if t == "cuda":
        return deep_cuda(trace_lde, aux_lde, chunks, betas_t, betas_q, g0s, invs)
    raise ValueError(f"no DEEP composition for device {trace_lde.device}")


def deep_composition_plain(
    trace_lde: GF, aux_lde: GF | None, chunks: GF2, betas_t: GF2, betas_q: GF2,
    g0s: GF2, invs: GF2,
) -> GF2:
    """The DEEP composition as int64 torch ops by row blocks (pointwise in
    x, so blocking is exact), each group's columns read apart (any device)."""
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


# incremented exactly where the DEEP kernel is launched
deep_kernel_launches = 0

# csrc/deep.cu: MAX_GROUPS (opening groups summed in registers) and
# MAX_COLUMNS (trace and aux columns its 160-bit sums take without wrapping:
# each product of canonical values is below (p-1)^2 < 2^128)
DEEP_MAX_GROUPS = 8
DEEP_MAX_COLUMNS = (1 << 32) - 1


class _DeepArgs(ctypes.Structure):
    """csrc/deep.cu's DeepArgs, field for field."""

    _fields_ = [
        ("trace", ctypes.c_void_p), ("trace_ld", ctypes.c_int64), ("n_main", ctypes.c_int64),
        ("aux", ctypes.c_void_p), ("aux_ld", ctypes.c_int64), ("n_aux", ctypes.c_int64),
        ("chunk0", ctypes.c_void_p), ("chunk1", ctypes.c_void_p), ("chunk_ld", ctypes.c_int64),
        ("n_chunks", ctypes.c_int64),
        ("beta_t0", ctypes.c_void_p), ("beta_t1", ctypes.c_void_p),
        ("beta_q0", ctypes.c_void_p), ("beta_q1", ctypes.c_void_p),
        ("g00", ctypes.c_void_p), ("g01", ctypes.c_void_p),
        ("inv0", ctypes.c_void_p), ("inv1", ctypes.c_void_p), ("inv_ld", ctypes.c_int64),
        ("n_groups", ctypes.c_int64), ("rows", ctypes.c_int64),
        ("out", ctypes.c_void_p),
    ]


@cache
def _deep_library():
    from ..ops.cuda_build import load_library

    lib = load_library("deep")
    lib.tmx_deep.restype = ctypes.c_int
    lib.tmx_deep.argtypes = [ctypes.POINTER(_DeepArgs), ctypes.c_void_p]
    return lib


def _deep_operand(t: torch.Tensor, what: str, dev, shape: tuple, *, rows_unit_stride: bool = False) -> int:
    """Checks a DEEP kernel operand; returns its row stride in words."""
    if t.device != dev or t.dtype != torch.int64:
        raise TypeError(f"deep_cuda: {what} must be int64 on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"deep_cuda: {what} has shape {tuple(t.shape)}, {shape} wanted")
    if rows_unit_stride:
        if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
            raise ValueError(f"deep_cuda: {what} must have unit stride along its rows")
        return int(t.stride(0))
    if not t.is_contiguous():
        raise ValueError(f"deep_cuda: {what} must be contiguous")
    return 0


def deep_cuda(
    trace_lde: GF, aux_lde: GF | None, chunks: GF2, betas_t: GF2, betas_q: GF2,
    g0s: GF2, invs: GF2,
) -> GF2:
    """Launch the DEEP kernel once over a CUDA shard's rows. The column
    operands (trace, aux, the chunks' c0 and c1 rows, the inverses) may
    be row views of larger buffers (the chunks are the even and odd rows
    of the quotient's row block) but need unit stride along their rows."""
    global deep_kernel_launches
    dev = trace_lde.device
    if dev.type != "cuda":
        raise TypeError(f"deep_cuda takes a CUDA shard, got {dev}")
    n_main, rows = int(trace_lde.shape[0]), int(trace_lde.shape[1])
    n_aux = int(aux_lde.shape[0]) if aux_lde is not None else 0
    n_chunks = int(chunks.shape[0])
    n_groups = int(g0s.shape[0])
    if not 1 <= n_groups <= DEEP_MAX_GROUPS:
        raise ValueError(f"deep_cuda sums 1 to {DEEP_MAX_GROUPS} opening groups, got {n_groups}")
    if n_main + n_aux > DEEP_MAX_COLUMNS:
        raise ValueError(f"deep_cuda sums at most {DEEP_MAX_COLUMNS} trace and aux columns, got {n_main + n_aux}")
    trace_ld = _deep_operand(trace_lde.v, "the trace block", dev, (n_main, rows), rows_unit_stride=True)
    aux_ld = 0
    if aux_lde is not None:
        aux_ld = _deep_operand(aux_lde.v, "the aux block", dev, (n_aux, rows), rows_unit_stride=True)
    chunk_ld = _deep_operand(chunks.c0.v, "the chunks' c0", dev, (n_chunks, rows), rows_unit_stride=True)
    if _deep_operand(chunks.c1.v, "the chunks' c1", dev, (n_chunks, rows), rows_unit_stride=True) != chunk_ld:
        raise ValueError("deep_cuda: the chunks' c0 and c1 rows must have one row stride")
    inv_ld = _deep_operand(invs.c0.v, "the inverses' c0", dev, (n_groups, rows), rows_unit_stride=True)
    if _deep_operand(invs.c1.v, "the inverses' c1", dev, (n_groups, rows), rows_unit_stride=True) != inv_ld:
        raise ValueError("deep_cuda: the inverses' c0 and c1 rows must have one row stride")
    for what, t, shape in (
        ("betas_t c0", betas_t.c0.v, (n_groups, n_main + n_aux)), ("betas_t c1", betas_t.c1.v, (n_groups, n_main + n_aux)),
        ("betas_q c0", betas_q.c0.v, (n_chunks,)), ("betas_q c1", betas_q.c1.v, (n_chunks,)),
        ("g0s c0", g0s.c0.v, (n_groups,)), ("g0s c1", g0s.c1.v, (n_groups,)),
    ):
        _deep_operand(t, what, dev, shape)
    out = torch.empty((2, rows), dtype=torch.int64, device=dev)
    if rows == 0:
        return GF2(GF(out[0]), GF(out[1]))
    args = _DeepArgs(
        trace=trace_lde.v.data_ptr(), trace_ld=trace_ld, n_main=n_main,
        aux=aux_lde.v.data_ptr() if aux_lde is not None else None, aux_ld=aux_ld, n_aux=n_aux,
        chunk0=chunks.c0.v.data_ptr(), chunk1=chunks.c1.v.data_ptr(), chunk_ld=chunk_ld, n_chunks=n_chunks,
        beta_t0=betas_t.c0.v.data_ptr(), beta_t1=betas_t.c1.v.data_ptr(),
        beta_q0=betas_q.c0.v.data_ptr(), beta_q1=betas_q.c1.v.data_ptr(),
        g00=g0s.c0.v.data_ptr(), g01=g0s.c1.v.data_ptr(),
        inv0=invs.c0.v.data_ptr(), inv1=invs.c1.v.data_ptr(), inv_ld=inv_ld,
        n_groups=n_groups, rows=rows, out=out.data_ptr(),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _deep_library().tmx_deep(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"tmx_deep launch failed: CUDA error {err}")
    deep_kernel_launches += 1
    return GF2(GF(out[0]), GF(out[1]))


# ---------------------------------------------------------------------------
# OOD evaluation and the DEEP inverse tables: plain torch ops for a CPU
# tensor, csrc/ood.cu for a CUDA tensor
# ---------------------------------------------------------------------------

# incremented exactly where each csrc/ood.cu entry is launched, by the
# CUDA kernels it launches (tmx_ood_eval: its slice and sum kernels, 2)
ext_powers_kernel_launches = 0
ood_kernel_launches = 0
deep_inverses_kernel_launches = 0

# csrc/ood.cu: MAX_POINTS (opening points a launch takes; the SHA AIRs
# open at 8), MAX_LENGTH (coefficients a row) and MAX_SLICE (coefficients
# a slice: its sums, Dot, take 2^31 products of canonical values without
# wrapping)
OOD_MAX_POINTS = 8
OOD_MAX_LENGTH = (1 << 32) - 1
OOD_MAX_SLICE = 1 << 30
# csrc/ood.cu: TJ, GROUP_POINTS and MAX_THREADS (coefficients of a row a
# tile, points a block, a block's most threads and rows); _ood_plan sizes a
# launch by them
OOD_TJ = 8
OOD_GROUP_POINTS = 4
OOD_MAX_THREADS = 128


# csrc/ood.cu: INV_BATCH, the (point, x) pairs of a deep_inverses batch
# inversion, at most
DEEP_INV_BATCH = 24

# csrc/ood.cu: POW_THREADS and POW_MAX_RUN (an ext_powers block's threads,
# the most powers a thread); _powers_run aims at about POW_BLOCKS blocks,
# two an SM of an H100
POW_THREADS = 256
POW_MAX_RUN = 8
POW_BLOCKS = 264


def _powers_run(n: int, n_points: int) -> int:
    """Powers a thread of an ext_powers launch: the least of 1, 2, 4 and 8
    whose blocks (a tile of POW_THREADS * run powers of one point) number
    at most POW_BLOCKS, else 8."""
    run = 1
    while run < POW_MAX_RUN and -(-n // (POW_THREADS * run)) * n_points > POW_BLOCKS:
        run *= 2
    return run


def _deep_inv_points(n_points: int) -> int:
    """csrc/ood.cu: inv_points, the domain points a deep_inverses thread
    takes at n_points opening points (a batch inversion of 20-24 pairs)."""
    return DEEP_INV_BATCH // n_points


class _PowersArgs(ctypes.Structure):
    """csrc/ood.cu's PowersArgs, field for field."""

    _fields_ = [
        ("pt0", ctypes.c_uint64 * OOD_MAX_POINTS), ("pt1", ctypes.c_uint64 * OOD_MAX_POINTS),
        ("n_points", ctypes.c_int64), ("n", ctypes.c_int64), ("run", ctypes.c_int64),
        ("out", ctypes.c_void_p),
    ]


class _OodArgs(ctypes.Structure):
    """csrc/ood.cu's OodArgs, field for field."""

    _fields_ = [
        ("a", ctypes.c_void_p), ("a_ld", ctypes.c_int64), ("n_a", ctypes.c_int64),
        ("b", ctypes.c_void_p), ("b_ld", ctypes.c_int64), ("n_b", ctypes.c_int64),
        ("powers", ctypes.c_void_p), ("n_points", ctypes.c_int64), ("n", ctypes.c_int64),
        ("threads", ctypes.c_int64), ("slice", ctypes.c_int64), ("slices", ctypes.c_int64),
        ("partial", ctypes.c_void_p), ("out", ctypes.c_void_p),
    ]


class _InvArgs(ctypes.Structure):
    """csrc/ood.cu's InvArgs, field for field."""

    _fields_ = [
        ("z0", ctypes.c_uint64 * OOD_MAX_POINTS), ("z1", ctypes.c_uint64 * OOD_MAX_POINTS),
        ("wz1", ctypes.c_uint64 * OOD_MAX_POINTS), ("wpow", ctypes.c_uint64 * 32),
        ("wstride", ctypes.c_uint64), ("wistride", ctypes.c_uint64), ("shift", ctypes.c_uint64),
        ("n_points", ctypes.c_int64), ("N", ctypes.c_int64), ("stride", ctypes.c_int64),
        ("out", ctypes.c_void_p),
    ]


@cache
def _ood_library():
    from ..ops.cuda_build import load_library

    lib = load_library("ood")
    for fn, args in (("tmx_ext_powers", _PowersArgs), ("tmx_ood_eval", _OodArgs), ("tmx_deep_inverses", _InvArgs)):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
    lib.tmx_ood_occupancy.restype = ctypes.c_int
    lib.tmx_ood_occupancy.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    return lib


def _ood_launch(fn: str, args, dev):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_ood_library(), fn)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


def _points_array(points: list[tuple[int, int]], what: str):
    """The points' c0 and c1 as csrc/ood.cu's fixed arrays."""
    if not 1 <= len(points) <= OOD_MAX_POINTS:
        raise ValueError(f"{what} takes 1 to {OOD_MAX_POINTS} points, got {len(points)}")
    c0 = (ctypes.c_uint64 * OOD_MAX_POINTS)(*[int(v[0]) % P for v in points])
    c1 = (ctypes.c_uint64 * OOD_MAX_POINTS)(*[int(v[1]) % P for v in points])
    return c0, c1


def ext_powers(points: list[tuple[int, int]], n: int, device) -> GF2:
    """[b^0 .. b^(n-1)] for each ext point b, a (len(points), n) GF2 on
    `device`: host loops for the CPU, one csrc/ood.cu launch on a card."""
    device = torch.device(device)
    if device.type == "cpu":
        return ext_powers_plain(points, n, device)
    if device.type == "cuda":
        return ext_powers_cuda(points, n, device)
    raise ValueError(f"no ext powers for device {device}")


def ext_powers_plain(points: list[tuple[int, int]], n: int, device) -> GF2:
    """The powers built by a host loop of ext multiplies a point, uploaded."""
    rows = [_ext_powers_u64(pt, n) for pt in points]
    return GF2(
        GF(tensor_from_u64(np.stack([r[0] for r in rows]).reshape(len(points), n), device)),
        GF(tensor_from_u64(np.stack([r[1] for r in rows]).reshape(len(points), n), device)),
    )


def ext_powers_cuda(points: list[tuple[int, int]], n: int, device) -> GF2:
    """One launch into one (2, points, n) buffer whose halves are the c0
    and c1 rows (ood_eval_cuda reads them so): a block a tile of
    POW_THREADS * run consecutive powers of one point, its first warp
    squaring the point up to the tile's base (csrc/ood.cu), run from
    _powers_run. No host powers: the kernel takes the points alone."""
    global ext_powers_kernel_launches
    dev = torch.device(device)
    if dev.type != "cuda":
        raise TypeError(f"ext_powers_cuda builds powers on a card, got {dev}")
    pt0, pt1 = _points_array(points, "ext_powers_cuda")
    out = torch.empty((2, len(points), n), dtype=torch.int64, device=dev)
    if n:
        if n > 1 << 32:
            raise ValueError(f"ext_powers_cuda takes at most 2^32 powers, got {n}")
        args = _PowersArgs(pt0=pt0, pt1=pt1, n_points=len(points), n=n, run=_powers_run(n, len(points)),
                           out=out.data_ptr())
        _ood_launch("tmx_ext_powers", args, dev)
        ext_powers_kernel_launches += 1
    return GF2(GF(out[0]), GF(out[1]))


def ood_eval_plain(a: GF, b: GF | None, powers: GF2) -> torch.Tensor:
    """The rows of a at every point and those of b at the first: v[c][k][r]
    = sum_j row_r[j] * powers[k][j] (component c of the powers), the
    (2, points, n_a) values of a, then the (2, n_b) of b at point 0, flat
    in one int64 tensor; one product tensor a point and component (any
    device)."""
    n_points = int(powers.shape[0])
    parts = [(a * GF(comp.v[k][None, :])).sum(axis=-1).v for comp in (powers.c0, powers.c1) for k in range(n_points)]
    if b is not None:
        parts += [(b * GF(comp.v[0][None, :])).sum(axis=-1).v for comp in (powers.c0, powers.c1)]
    return torch.cat(parts)


def _ood_rows_operand(t: torch.Tensor, what: str, dev, n: int) -> int:
    """Checks a coefficient operand of ood_eval; returns its row stride."""
    if t.device != dev or t.dtype != torch.int64:
        raise TypeError(f"ood_eval_cuda: {what} must be int64 on {dev}, got {t.dtype} on {t.device}")
    if t.dim() != 2 or int(t.shape[1]) != n:
        raise ValueError(f"ood_eval_cuda: {what} has shape {tuple(t.shape)}, (rows, {n}) wanted")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"ood_eval_cuda: {what} must have unit stride along its rows")
    return int(t.stride(0))


def _ood_threads(rows: int) -> int:
    """An ood_eval block's threads, one a row: of 32, 64 and 128 the one
    whose row blocks leave the fewest threads idle (the most on a tie)."""
    return min((128, 64, 32), key=lambda t: -(-rows // t) * t - rows)


def _ood_groups(n_points: int) -> tuple[int, int]:
    """(point groups, points a group) of an ood_eval launch: at most
    OOD_GROUP_POINTS a block, a power of two (the kernel's instances), the
    last group's real points fewer where they do not fill it."""
    groups = -(-n_points // OOD_GROUP_POINTS)
    each = -(-n_points // groups)
    return groups, 1 << (each - 1).bit_length()


def _ood_plan(rows: int, n: int, n_points: int, sms: int, blocks_per_sm: int) -> tuple[int, int, int]:
    """(threads a block, slice, slices) of an ood_eval launch: the row
    length cut into slices of a multiple of OOD_TJ coefficients until the
    blocks (row blocks x slices x point groups) make about one wave of
    `blocks_per_sm` resident blocks on each of `sms` SMs (at most 65,535
    slices: the grid's second dimension; at most OOD_MAX_SLICE
    coefficients each)."""
    threads = _ood_threads(rows)
    blocks = -(-rows // threads) * _ood_groups(n_points)[0]
    tiles = -(-n // OOD_TJ)
    want = min(65535, max(-(-tiles // (OOD_MAX_SLICE // OOD_TJ)), -(-sms * blocks_per_sm // blocks)))
    slice_ = -(-tiles // want) * OOD_TJ
    return threads, slice_, -(-n // slice_)


@cache
def _ood_occupancy(dev: torch.device, n_points: int, threads: int) -> tuple[int, int]:
    """(SMs, resident ood_eval blocks an SM) on the card."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = _ood_library().tmx_ood_occupancy(n_points, threads, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"tmx_ood_occupancy failed: CUDA error {err}, {blocks.value} blocks")
    return torch.cuda.get_device_properties(dev).multi_processor_count, blocks.value


def ood_eval_cuda(a: GF, b: GF | None, powers: GF2) -> torch.Tensor:
    """ood_eval_plain's values by one call of csrc/ood.cu's tmx_ood_eval,
    which launches its evaluation and slice-sum kernels (two counted
    launches). The row operands may be row views with unit stride along
    their rows; the powers are (points, n) rows of one (2, points, n)
    buffer, as ext_powers_cuda returns them."""
    global ood_kernel_launches
    dev = a.device
    if dev.type != "cuda":
        raise TypeError(f"ood_eval_cuda takes CUDA rows, got {dev}")
    n_points, n = int(powers.shape[0]), int(powers.shape[1])
    if not 1 <= n_points <= OOD_MAX_POINTS:
        raise ValueError(f"ood_eval_cuda takes 1 to {OOD_MAX_POINTS} points, got {n_points}")
    if not 1 <= n <= OOD_MAX_LENGTH:
        raise ValueError(f"ood_eval_cuda takes rows of 1 to {OOD_MAX_LENGTH} coefficients, got {n}")
    a_ld = _ood_rows_operand(a.v, "the rows", dev, n)
    b_ld = _ood_rows_operand(b.v, "the second rows", dev, n) if b is not None else 0
    pw = powers.c0.v
    if (pw.device != dev or pw.dtype != torch.int64 or powers.c1.v.device != dev
            or tuple(powers.c1.v.shape) != (n_points, n) or not pw.is_contiguous()
            or not powers.c1.v.is_contiguous()
            or powers.c1.v.data_ptr() != pw.data_ptr() + 8 * n_points * n):
        raise ValueError("ood_eval_cuda: the powers must be the two halves of one contiguous (2, points, n) "
                         f"int64 buffer on {dev}")
    n_a = int(a.shape[0])
    n_b = int(b.shape[0]) if b is not None else 0
    n_out = 2 * (n_points * n_a + n_b)
    out = torch.empty((n_out,), dtype=torch.int64, device=dev)
    if n_a + n_b == 0:
        return out
    threads, slice_, slices = _ood_plan(n_a + n_b, n, n_points,
                                        *_ood_occupancy(dev, n_points, _ood_threads(n_a + n_b)))
    partial = torch.empty((slices, n_out), dtype=torch.int64, device=dev)
    args = _OodArgs(
        a=a.v.data_ptr(), a_ld=a_ld, n_a=n_a,
        b=b.v.data_ptr() if b is not None else None, b_ld=b_ld, n_b=n_b,
        powers=pw.data_ptr(), n_points=n_points, n=n, threads=threads, slice=slice_, slices=slices,
        partial=partial.data_ptr(), out=out.data_ptr(),
    )
    _ood_launch("tmx_ood_eval", args, dev)
    ood_kernel_launches += 2
    return out


def _ood_eval(a: GF, b: GF | None, powers: GF2) -> torch.Tensor:
    t = a.device.type
    if t == "cpu":
        return ood_eval_plain(a, b, powers)
    if t == "cuda":
        return ood_eval_cuda(a, b, powers)
    raise ValueError(f"no OOD evaluation for device {a.device}")


def _pairs(vals: np.ndarray) -> list[tuple[int, int]]:
    """(c0, c1) pairs of a (2, rows) uint64 array."""
    return [(int(x), int(y)) for x, y in zip(vals[0], vals[1])]


def ood_values(coeffs: GF, points: list[tuple[int, int]]) -> list[list[tuple[int, int]]]:
    """Evaluate every row polynomial of `coeffs` (C, n) at each ext point:
    sum_j c_j * pt^j. Host powers and torch ops for a CPU tensor (the
    verifier's); ext_powers and ood_eval launches on a card."""
    n, C, K = int(coeffs.shape[1]), int(coeffs.shape[0]), len(points)
    vals = tensor_to_u64(_ood_eval(coeffs, None, ext_powers(points, n, coeffs.device))).reshape(2, K, C)
    return [_pairs(vals[:, k]) for k in range(K)]


def ood_evaluate(
    coeffs: GF, chunk_rows: GF, points: list[tuple[int, int]]
) -> tuple[list[list[tuple[int, int]]], list[tuple[int, int]]]:
    """A statement's OOD values: every row of `coeffs` (trace and aux
    coefficients, (C, n)) at every opening point, and the quotient chunks
    (rows [c0_0, c1_0, c0_1, ...] of `chunk_rows`) at points[0] = z: one
    ext_powers and one ood_eval over both (a launch each on a card), which
    takes the chunk rows at z alone. A chunk's value E0 + X E1 from the
    base evaluations of its c0 row (E0) and c1 row (E1) is (E0.c0 + W
    E1.c1, E0.c1 + E1.c0)."""
    n, C, K = int(coeffs.shape[1]), int(coeffs.shape[0]), len(points)
    vals = tensor_to_u64(_ood_eval(coeffs, chunk_rows, ext_powers(points, n, coeffs.device)))
    trace = vals[: 2 * K * C].reshape(2, K, C)
    e = _pairs(vals[2 * K * C :].reshape(2, -1))  # each chunk row at z
    quot = [((e0[0] + W * e1[1]) % P, (e0[1] + e1[0]) % P) for e0, e1 in zip(e[0::2], e[1::2])]
    return [_pairs(trace[:, k]) for k in range(K)], quot


def deep_inverses(log_N: int, shift: int, zks: list[tuple[int, int]], device) -> GF2:
    """(x - z_g)^-1 over the whole LDE domain for every opening point, a
    (len(zks), N) GF2: torch ops for the CPU, one csrc/ood.cu launch on a
    card."""
    device = torch.device(device)
    if device.type == "cpu":
        return deep_inverses_plain(log_N, shift, zks, device)
    if device.type == "cuda":
        return deep_inverses_cuda(log_N, shift, zks, device)
    raise ValueError(f"no DEEP inverses for device {device}")


def deep_inverses_plain(log_N: int, shift: int, zks: list[tuple[int, int]], device) -> GF2:
    """The inverses as int64 torch ops over the host domain points (any device)."""
    pts = GF(tensor_from_u64(_domain_points(log_N, shift), device))[None, :]
    z = _ext_list_to_gf2(zks, device)
    c0 = pts - GF(z.c0.v[:, None])
    c1 = -GF(z.c1.v[:, None]).broadcast_to(c0.shape)
    return GF2(c0, GF(c1.v.contiguous())).inv()


@cache
def _deep_inv_domain(log_N: int, n_points: int) -> tuple[int, ctypes.Array, int, int]:
    """(stride, w_N^(2^b) for b < 32 as csrc/ood.cu's array, w_N^stride,
    w_N^-stride) of deep_inverses_cuda's launch over a domain of 2^log_N
    points: built once a shape (the host's powers cost more than the
    Ed25519 kernel)."""
    N = 1 << log_N
    stride = -(-N // _deep_inv_points(n_points))
    w = nttmod.primitive_root_of_unity(log_N)
    wpow = []
    for _ in range(32):
        wpow.append(w)
        w = w * w % P
    wstride = pow(wpow[0], stride, P)
    return stride, (ctypes.c_uint64 * 32)(*wpow), wstride, pow(wstride, P - 2, P)


def deep_inverses_cuda(log_N: int, shift: int, zks: list[tuple[int, int]], device) -> GF2:
    """One launch into one (2, points, N) buffer whose halves are the c0
    and c1 rows (unit stride along each row, as
    parallel/prover.py::sharded_deep_fn cuts them): each thread takes the
    domain points i, i + stride, .. (_deep_inv_points of them; x from the
    powers w_N^(2^b), then times w_N^stride) at every opening point and
    divides each pair's conjugate by its norm, (x - z0)^2 - W z1^2 (W z1^2
    passed a point), in one batch inversion."""
    global deep_inverses_kernel_launches
    dev = torch.device(device)
    if dev.type != "cuda":
        raise TypeError(f"deep_inverses_cuda builds the tables on a card, got {dev}")
    if not 0 <= log_N <= 32:
        raise ValueError(f"deep_inverses_cuda takes domains of 2^0 to 2^32 points, got 2^{log_N}")
    z0, z1 = _points_array(zks, "deep_inverses_cuda")
    N = 1 << log_N
    stride, wpow, wstride, wistride = _deep_inv_domain(log_N, len(zks))
    wz1 = (ctypes.c_uint64 * OOD_MAX_POINTS)(*[W * v * v % P for v in z1])
    out = torch.empty((2, len(zks), N), dtype=torch.int64, device=dev)
    args = _InvArgs(z0=z0, z1=z1, wz1=wz1, wpow=wpow, wstride=wstride, wistride=wistride, shift=shift % P,
                    n_points=len(zks), N=N, stride=stride, out=out.data_ptr())
    _ood_launch("tmx_deep_inverses", args, dev)
    deep_inverses_kernel_launches += 1
    return GF2(GF(out[0]), GF(out[1]))


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
    a_pows = ext_powers([alpha], air.n_constraints, dev)
    alpha_pows = GF2(a_pows.c0[0], a_pows.c1[0])
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
    ood_trace, ood_quot = ood_evaluate(all_coeffs, chunk_stack, zk_list)
    del all_coeffs
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
