"""Poseidon permutation over Goldilocks, width 12: transcript and Merkle hash.

Counterpart of ``tendermintx_tpu/ops/poseidon.py``. The parameters (round
constants, the 7-bit-entry MDS matrix) are regenerated here from the same
nothing-up-my-sleeve SHA-256 expansion, so the two packages hash alike.

Three implementations compute the same permutation:

  * ``permute_ints``: the sequential host oracle (native C++ core when it
    builds, pure Python otherwise) for the challenger and verifier;
  * ``permute_plain``: int64 torch ops on (..., 12) tensors, any device;
  * the hand-written CUDA kernels in ``csrc/poseidon.cu``.

The kernels have five entries, each beside its plain version: the
permutation (``permute``), the column-major leaf sponge
(``hash_no_pad_cols``), one Merkle tree layer (``merkle_layer``), the
recursion wrap's round states (``expand_cuda`` / ``expand_plain``) and the
FRI's grinding search over a span of nonces (``grind_cuda`` /
``grind_plain``). Each
dispatcher takes the plain version only for a CPU tensor. For a CUDA tensor
it launches the kernel or raises: there is no probe and no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
from functools import cache

import numpy as np
import torch

from . import goldilocks as gl
from .goldilocks import GF, P

WIDTH = 12
RATE = 8
CAPACITY = 4
DIGEST = 4
FULL_ROUNDS = 8  # 4 + 4
PARTIAL_ROUNDS = 22
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
SBOX = 7

_DOMAIN = b"TendermintX-TPU Poseidon v1"


def _expand(tag: bytes, count: int) -> list[int]:
    """Nothing-up-my-sleeve field elements: SHA-256 in counter mode with
    rejection sampling."""
    out = []
    ctr = 0
    while len(out) < count:
        h = hashlib.sha256(_DOMAIN + b"/" + tag + b"/" + ctr.to_bytes(8, "big")).digest()
        for off in (0, 8, 16, 24):
            v = int.from_bytes(h[off : off + 8], "little")
            if v < P:
                out.append(v)
                if len(out) == count:
                    break
        ctr += 1
    return out


@cache
def round_constants() -> list[list[int]]:
    """N_ROUNDS x WIDTH round constants."""
    flat = _expand(b"rc", N_ROUNDS * WIDTH)
    return [flat[r * WIDTH : (r + 1) * WIDTH] for r in range(N_ROUNDS)]


MDS_CANDIDATE = 0  # first candidate index passing the exhaustive MDS check


def _small_mds_candidate(idx: int) -> list[list[int]]:
    """WIDTH x WIDTH matrix with entries in [1, 127] from the SHA-256
    counter stream (rejection-sampling the low 7 bits of each byte)."""
    out: list[int] = []
    ctr = 0
    tag = b"mds7/%d" % idx
    while len(out) < WIDTH * WIDTH:
        h = hashlib.sha256(_DOMAIN + b"/" + tag + b"/" + ctr.to_bytes(8, "big")).digest()
        for b in h:
            v = b & 0x7F
            if v:
                out.append(v)
                if len(out) == WIDTH * WIDTH:
                    break
        ctr += 1
    return [out[i * WIDTH : (i + 1) * WIDTH] for i in range(WIDTH)]


@cache
def mds_matrix() -> list[list[int]]:
    """WIDTH x WIDTH MDS matrix with 7-bit entries (the reference's
    candidate 0, whose MDS property its tests check exhaustively)."""
    return _small_mds_candidate(MDS_CANDIDATE)


# ---------------------------------------------------------------------------
# Host oracle (challenger / verifier / tests)
# ---------------------------------------------------------------------------


def _sbox_int(x: int) -> int:
    x2 = x * x % P
    x3 = x2 * x % P
    x4 = x2 * x2 % P
    return x3 * x4 % P


def _mds_int(state: list[int]) -> list[int]:
    m = mds_matrix()
    return [sum(m[i][j] * state[j] for j in range(WIDTH)) % P for i in range(WIDTH)]


def _native():
    from ..utils import native

    return native


def permute_ints(state: list[int]) -> list[int]:
    """Sequential permutation of WIDTH Python ints."""
    if len(state) != WIDTH:
        raise ValueError("Poseidon state must have 12 elements")
    out = _native().permute_ints_native([x % P for x in state])
    if out is not None:
        return out
    return _permute_ints_py(state)


def _permute_ints_py(state: list[int]) -> list[int]:
    s = [x % P for x in state]
    rc = round_constants()
    half = FULL_ROUNDS // 2
    r = 0
    for _ in range(half):
        s = [_sbox_int((x + c) % P) for x, c in zip(s, rc[r])]
        s = _mds_int(s)
        r += 1
    for _ in range(PARTIAL_ROUNDS):
        s = [(x + c) % P for x, c in zip(s, rc[r])]
        s[0] = _sbox_int(s[0])
        s = _mds_int(s)
        r += 1
    for _ in range(half):
        s = [_sbox_int((x + c) % P) for x, c in zip(s, rc[r])]
        s = _mds_int(s)
        r += 1
    return s


def hash_ints(inputs: list[int]) -> list[int]:
    """Sponge hash (overwrite mode, no padding) to a DIGEST-element output."""
    out = _native().hash_ints_native([v % P for v in inputs])
    if out is not None:
        return out
    state = [0] * WIDTH
    for i in range(0, len(inputs), RATE):
        for j, v in enumerate(inputs[i : i + RATE]):
            state[j] = v % P
        state = _permute_ints_py(state)
    return state[:DIGEST]


def two_to_one_ints(left: list[int], right: list[int]) -> list[int]:
    out = _native().two_to_one_native(list(left), list(right))
    if out is not None:
        return out
    state = list(left) + list(right) + [0] * (WIDTH - 2 * DIGEST)
    return _permute_ints_py(state)[:DIGEST]


# ---------------------------------------------------------------------------
# Batched permutation: plain torch version
# ---------------------------------------------------------------------------


@cache
def _rc_u64() -> np.ndarray:
    return np.array(round_constants(), dtype=np.uint64)  # (30, 12)


@cache
def _mds_u64() -> np.ndarray:
    return np.array(mds_matrix(), dtype=np.uint64)  # (12, 12)


def _sbox_plain(x: torch.Tensor) -> torch.Tensor:
    x2 = gl.mul(x, x)
    x3 = gl.mul(x2, x)
    x4 = gl.mul(x2, x2)
    return gl.mul(x3, x4)


def _mds_plain(s: torch.Tensor, mds_t: torch.Tensor) -> torch.Tensor:
    """out[:, i] = sum_j M[i, j] s[:, j] for the 7-bit-entry matrix.

    Each element splits into 32-bit halves; a half times a 7-bit entry is
    < 2**39 and a 12-term sum < 2**43, so both contractions are exact as
    float64 matrix products (integers below 2**53) on every device. The
    two sums recombine into four 32-bit limbs and reduce once."""
    lo = (s & 0xFFFFFFFF).to(torch.float64) @ mds_t
    hi = ((s >> 32) & 0xFFFFFFFF).to(torch.float64) @ mds_t
    a = lo.to(torch.int64)
    b = hi.to(torch.int64)
    r1 = (a >> 32).add_(b & 0xFFFFFFFF)
    return gl.reduce_limbs(a.bitwise_and_(0xFFFFFFFF), r1, b.bitwise_right_shift_(32), torch.zeros_like(a))


def plain_params(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(round constants (30, 12) int64, transposed MDS matrix as float64)
    on `device`, the operands of the plain round pieces."""
    rc = gl.tensor_from_u64(_rc_u64(), device)
    mds_t = torch.from_numpy(_mds_u64().astype(np.float64).T.copy()).to(device)
    return rc, mds_t


def full_round_plain(s: torch.Tensor, rc_r: torch.Tensor, mds_t: torch.Tensor) -> torch.Tensor:
    """One full round (constants, S-box on every lane, MDS) of (B, 12) states."""
    return _mds_plain(_sbox_plain(gl.add(s, rc_r)), mds_t)


def partial_round_plain(pre: torch.Tensor, mds_t: torch.Tensor) -> torch.Tensor:
    """The rest of a partial round from its pre-S-box state (constants
    added): S-box on lane 0 only, then MDS."""
    return _mds_plain(torch.cat([_sbox_plain(pre[:, :1]), pre[:, 1:]], dim=1), mds_t)


# CPU states go through the rounds in blocks of this many rows, so each
# round's temporaries stay in cache: 2.3-2.5x faster at 2^20 states than
# one pass, with 8 or 2 threads (measured on a CPU host).
_CPU_BLOCK = 1 << 16


def _permute_rows(s: torch.Tensor) -> torch.Tensor:
    rc, mds_t = plain_params(s.device)
    half = FULL_ROUNDS // 2
    for r in range(N_ROUNDS):
        if half <= r < half + PARTIAL_ROUNDS:
            s = partial_round_plain(gl.add(s, rc[r]), mds_t)
        else:
            s = full_round_plain(s, rc[r], mds_t)
    return s


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Reference permutation of (..., 12) int64 states in torch ops."""
    shape = state.shape
    s = state.reshape(-1, WIDTH)
    if s.device.type == "cpu":
        return torch.cat([_permute_rows(b) for b in s.split(_CPU_BLOCK)]).reshape(shape)
    return _permute_rows(s).reshape(shape)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/poseidon.cu)
# ---------------------------------------------------------------------------

# One count per kernel entry, incremented exactly where it is launched.
permute_kernel_launches = 0
sponge_kernel_launches = 0
layer_kernel_launches = 0
expand_kernel_launches = 0
grind_kernel_launches = 0


@cache
def _library():
    from .cuda_build import load_library

    lib = load_library("poseidon")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for fn, n_ints in (
        (lib.tmx_poseidon_permute, 1),
        (lib.tmx_poseidon_sponge_cols, 2),
        (lib.tmx_poseidon_merkle_layer, 1),
        (lib.tmx_poseidon_expand, 1),
    ):
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr, ptr] + [i64] * n_ints + [ptr]
    lib.tmx_poseidon_grind.restype = ctypes.c_int
    lib.tmx_poseidon_grind.argtypes = [ctypes.c_uint64, i64, i64, i64, ptr, ptr]
    return lib


def _check_cuda_operand(x: torch.Tensor, entry: str, align: int):
    if x.device.type != "cuda" or x.dtype != torch.int64:
        raise TypeError(f"{entry} takes an int64 CUDA tensor")
    if not x.is_contiguous():
        raise ValueError(f"{entry} takes a contiguous tensor")
    if x.data_ptr() % align:
        raise ValueError(f"{entry} takes a {align}-byte aligned tensor")


def _launch(entry: str, x: torch.Tensor, out: torch.Tensor, *ints: int):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_library(), entry)(x.data_ptr(), out.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def permute_cuda(state: torch.Tensor) -> torch.Tensor:
    """Launch the permutation kernel on contiguous (..., 12) int64 CUDA states."""
    global permute_kernel_launches
    _check_cuda_operand(state, "permute_cuda", 16)
    if state.dim() == 0 or state.shape[-1] != WIDTH:
        raise ValueError(f"last dim must be {WIDTH}, got {tuple(state.shape)}")
    out = torch.empty_like(state)
    n = state.numel() // WIDTH
    if n == 0:
        return out
    _launch("tmx_poseidon_permute", state, out, n)
    permute_kernel_launches += 1
    return out


def permute_tensor(state: torch.Tensor) -> torch.Tensor:
    """Dispatch on the tensor's device: plain on CPU, kernel on CUDA."""
    if state.device.type == "cpu":
        return permute_plain(state)
    if state.device.type == "cuda":
        return permute_cuda(state)
    raise ValueError(f"no Poseidon permutation for device {state.device}")


def permute(state: GF) -> GF:
    """Batched permutation: state shape (..., 12)."""
    return GF(permute_tensor(state.v))


# ---------------------------------------------------------------------------
# Sponge and compression
# ---------------------------------------------------------------------------


def hash_no_pad(inputs: GF) -> GF:
    """Batched sponge hash: inputs (..., L) -> contiguous digests (..., 4)."""
    x = inputs.v
    L = x.shape[-1]
    state = torch.zeros(x.shape[:-1] + (WIDTH,), dtype=torch.int64, device=x.device)
    for i in range(0, L, RATE):
        chunk = x[..., i : i + RATE]
        state = torch.cat([chunk, state[..., chunk.shape[-1] :]], dim=-1)
        state = permute_tensor(state)
    return GF(state[..., :DIGEST].contiguous())


def _check_cols(x: torch.Tensor):
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"columns must be (L >= 1, N), got {tuple(x.shape)}")


def hash_no_pad_cols_plain(x: torch.Tensor) -> torch.Tensor:
    """(L, N) columns -> (N, 4) digests of the rows zero-padded to a RATE
    multiple, one transposed (RATE, N) chunk per absorb."""
    _check_cols(x)
    L, N = int(x.shape[0]), int(x.shape[1])
    state = torch.zeros((N, WIDTH), dtype=torch.int64, device=x.device)
    for i in range(0, L, RATE):
        chunk = x[i : i + RATE]
        k = int(chunk.shape[0])
        state[:, :k] = chunk.t()
        state[:, k:RATE] = 0
        state = permute_plain(state)
    return state[:, :DIGEST].contiguous()


def sponge_cols_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the column sponge kernel: contiguous (L, N) int64 CUDA
    columns -> (N, 4) digests, all ceil(L / RATE) absorbs in one launch."""
    global sponge_kernel_launches
    _check_cuda_operand(x, "sponge_cols_cuda", 8)
    _check_cols(x)
    L, N = int(x.shape[0]), int(x.shape[1])
    out = torch.empty((N, DIGEST), dtype=torch.int64, device=x.device)
    if N == 0:
        return out
    _launch("tmx_poseidon_sponge_cols", x, out, L, N)
    sponge_kernel_launches += 1
    return out


def hash_no_pad_cols(cols: GF) -> GF:
    """Column-major sponge: cols (L, N), any L >= 1 -> digests (N, 4), equal
    to ``hash_no_pad`` on the (N, L) rows zero-padded to a RATE multiple
    (``merkle.pad_row_width``), without a transposed or padded copy."""
    x = cols.v
    if x.device.type == "cpu":
        return GF(hash_no_pad_cols_plain(x))
    if x.device.type == "cuda":
        return GF(sponge_cols_cuda(x))
    raise ValueError(f"no Poseidon sponge for device {x.device}")


def _check_layer(d: torch.Tensor):
    n = int(d.shape[0]) if d.dim() == 2 else 0
    if d.dim() != 2 or d.shape[1] != DIGEST or n < 2 or n % 2:
        raise ValueError(f"a tree layer is (n, 4) with n even and >= 2, got {tuple(d.shape)}")


def merkle_layer_plain(d: torch.Tensor) -> torch.Tensor:
    """(n, 4) digests -> (n/2, 4): out[i] is the 2-to-1 compression of
    d[2i] and d[2i+1] (the permutation of [d[2i], d[2i+1], 0, 0, 0, 0],
    first 4 lanes), as ``two_to_one_ints``."""
    _check_layer(d)
    half = int(d.shape[0]) // 2
    zeros = torch.zeros((half, WIDTH - 2 * DIGEST), dtype=torch.int64, device=d.device)
    return permute_plain(torch.cat([d.reshape(half, 2 * DIGEST), zeros], dim=1))[:, :DIGEST].contiguous()


def merkle_layer_cuda(d: torch.Tensor) -> torch.Tensor:
    """Launch the tree layer kernel on contiguous (n, 4) int64 CUDA digests."""
    global layer_kernel_launches
    _check_cuda_operand(d, "merkle_layer_cuda", 16)
    _check_layer(d)
    half = int(d.shape[0]) // 2
    out = torch.empty((half, DIGEST), dtype=torch.int64, device=d.device)
    _launch("tmx_poseidon_merkle_layer", d, out, half)
    layer_kernel_launches += 1
    return out


def merkle_layer(layer: GF) -> GF:
    """One Merkle tree layer: (n, 4) digests -> (n/2, 4) parents."""
    d = layer.v
    if d.device.type == "cpu":
        return GF(merkle_layer_plain(d))
    if d.device.type == "cuda":
        return GF(merkle_layer_cuda(d))
    raise ValueError(f"no Poseidon tree layer for device {d.device}")


# ---------------------------------------------------------------------------
# The recursion wrap's round states (stark/recursion.py: expand_perm_states)
# ---------------------------------------------------------------------------

# S1..S3, p4..p25, w26..w29: the WrapAir columns COL_S..N_PERM_COLS
EXPAND_COLS = 3 * WIDTH + PARTIAL_ROUNDS + 4 * WIDTH


def expand_plain(states: torch.Tensor) -> torch.Tensor:
    """(R, 12) input states -> (106, R) columns: the states after rounds
    0-2, each partial round's lane 0 before its S-box, the states after
    rounds 25-28; the plain round pieces over the rounds (any device)."""
    rc, mds_t = plain_params(states.device)
    s = states
    cols = []
    for r in range(3):  # S1..S3
        s = full_round_plain(s, rc[r], mds_t)
        cols.append(s.t())
    s = full_round_plain(s, rc[3], mds_t)  # S4 (recomputed in-circuit)
    p_vals = []
    for r in range(4, 4 + PARTIAL_ROUNDS):
        pre = gl.add(s, rc[r])
        p_vals.append(pre[:, 0])
        s = partial_round_plain(pre, mds_t)
    cols.append(torch.stack(p_vals))
    cols.append(s.t())  # w26
    for r in range(26, 29):  # w27..w29
        s = full_round_plain(s, rc[r], mds_t)
        cols.append(s.t())
    return torch.cat(cols, dim=0).contiguous()


def expand_cuda(states: torch.Tensor) -> torch.Tensor:
    """Launch the round-state kernel on contiguous (R, 12) int64 CUDA
    states -> (106, R), one thread a state."""
    global expand_kernel_launches
    _check_cuda_operand(states, "expand_cuda", 8)
    if states.dim() != 2 or states.shape[1] != WIDTH:
        raise ValueError(f"expand_cuda takes (R, {WIDTH}) states, got {tuple(states.shape)}")
    n = int(states.shape[0])
    out = torch.empty((EXPAND_COLS, n), dtype=torch.int64, device=states.device)
    if n == 0:
        return out
    _launch("tmx_poseidon_expand", states, out, n)
    expand_kernel_launches += 1
    return out


# ---------------------------------------------------------------------------
# Grinding (stark/fri.py: grind): the smallest hit in a span of nonces
# ---------------------------------------------------------------------------

# candidates a warp of csrc/poseidon.cu's grinding kernel claims at a time
GRIND_CHUNK = 32
# grind_plain takes its span in batches of at most this many candidates
PLAIN_GRIND_BATCH = 1 << 16


def _check_grind(seed: int, pow_bits: int, start: int, span: int):
    if not 0 <= seed < P:
        raise ValueError("the grinding seed must be a canonical field element")
    if not 1 <= pow_bits <= 32:
        raise ValueError("pow_bits must be in 1..32")
    if start < 0 or span < 1 or start + span > P:
        raise ValueError(f"no grinding span of {span} candidates from {start}")


def grind_plain(seed: int, pow_bits: int, start: int, span: int, device) -> int | None:
    """The first nonce in start .. start + span - 1 whose
    permute([seed, nonce, 0, ...])[0] has `pow_bits` low zero bits, or None:
    the span in order in batches of at most PLAIN_GRIND_BATCH, each a (batch,
    12) state tensor through permute_plain, a mask and a nonzero (any
    device)."""
    _check_grind(seed, pow_bits, start, span)
    end = start + span
    for lo in range(start, end, PLAIN_GRIND_BATCH):
        batch = min(PLAIN_GRIND_BATCH, end - lo)
        state = torch.zeros((batch, WIDTH), dtype=torch.int64, device=device)
        state[:, 0] = gl.scalar_tensor(seed, device)
        state[:, 1] = torch.arange(lo, lo + batch, dtype=torch.int64, device=device)
        out = permute_plain(state)
        hits = torch.nonzero((out[:, 0] & ((1 << pow_bits) - 1)) == 0)
        if hits.numel():
            return lo + int(hits[0, 0])
    return None


def grind_cuda(seed: int, pow_bits: int, start: int, span: int, device) -> int | None:
    """grind_plain's search as one launch of the grinding kernel on the
    CUDA `device`: warps claim chunks of GRIND_CHUNK candidates in order and
    stop once a chunk starts at or past the best hit; two scratch words,
    zeroed by the C entry (the chunks claimed, span - the smallest hit),
    read back once (the one sync a span)."""
    global grind_kernel_launches
    dev = torch.device(device)
    if dev.type != "cuda":
        raise TypeError(f"grind_cuda runs on a CUDA device, got {dev}")
    _check_grind(seed, pow_bits, start, span)
    scratch = torch.empty((2,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().tmx_poseidon_grind(seed, pow_bits, start, span, scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tmx_poseidon_grind launch failed: CUDA error {err}")
    grind_kernel_launches += 1
    best = int(scratch[1].item())
    return start + span - best if best else None
