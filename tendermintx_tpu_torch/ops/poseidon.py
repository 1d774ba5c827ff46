"""Poseidon permutation over Goldilocks, width 12: transcript and Merkle hash.

Counterpart of ``tendermintx_tpu/ops/poseidon.py``. The parameters (round
constants, the 7-bit-entry MDS matrix) are regenerated here from the same
nothing-up-my-sleeve SHA-256 expansion, so the two packages hash alike.

Three implementations compute the same permutation:

  * ``permute_ints``: the sequential host oracle (native C++ core when it
    builds, pure Python otherwise) for the challenger and verifier;
  * ``permute_plain``: int64 torch ops on (..., 12) tensors, any device;
  * the hand-written CUDA kernel in ``csrc/poseidon.cu``.

``permute`` takes ``permute_plain`` only for a CPU tensor. For a CUDA tensor
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
# Batched permutation: CUDA kernel (csrc/poseidon.cu)
# ---------------------------------------------------------------------------

# Incremented exactly where the kernel is launched.
permute_kernel_launches = 0


@cache
def _library():
    from .cuda_build import load_library

    lib = load_library("poseidon")
    lib.tmx_poseidon_set_params.restype = ctypes.c_int
    lib.tmx_poseidon_set_params.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tmx_poseidon_permute.restype = ctypes.c_int
    lib.tmx_poseidon_permute.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    return lib


@cache
def _params_on(device_index: int) -> bool:
    """Copy the constants into the kernel's __constant__ memory of one
    device (once per device)."""
    rc = np.ascontiguousarray(_rc_u64())
    mds = np.ascontiguousarray(_mds_u64())
    with torch.cuda.device(device_index):
        err = _library().tmx_poseidon_set_params(rc.ctypes.data, mds.ctypes.data)
    if err != 0:
        raise RuntimeError(f"poseidon parameter upload failed: CUDA error {err}")
    return True


def permute_cuda(state: torch.Tensor) -> torch.Tensor:
    """Launch the Poseidon kernel on (..., 12) int64 CUDA states."""
    global permute_kernel_launches
    if state.device.type != "cuda" or state.dtype != torch.int64:
        raise TypeError("permute_cuda takes an int64 CUDA tensor")
    if state.shape[-1] != WIDTH:
        raise ValueError(f"last dim must be {WIDTH}, got {tuple(state.shape)}")
    s = state.contiguous()
    out = torch.empty_like(s)
    n = s.numel() // WIDTH
    if n == 0:
        return out
    _params_on(s.device.index)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = _library().tmx_poseidon_permute(s.data_ptr(), out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"poseidon kernel launch failed: CUDA error {err}")
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
    """Batched sponge hash: inputs (..., L) -> digest (..., 4)."""
    x = inputs.v
    L = x.shape[-1]
    state = torch.zeros(x.shape[:-1] + (WIDTH,), dtype=torch.int64, device=x.device)
    for i in range(0, L, RATE):
        chunk = x[..., i : i + RATE]
        state = torch.cat([chunk, state[..., chunk.shape[-1] :]], dim=-1)
        state = permute_tensor(state)
    return GF(state[..., :DIGEST])


def hash_no_pad_cols(cols: GF) -> GF:
    """Column-major sponge: cols (L, N) -> digests (N, 4), equal to
    ``hash_no_pad`` on the (N, L) rows without a transposed copy of the
    whole matrix (each absorb transposes one (RATE, N) chunk). L must be a
    positive RATE multiple (ops/merkle.py pads)."""
    x = cols.v
    L, N = int(x.shape[0]), int(x.shape[1])
    if L % RATE or L < RATE:
        raise ValueError(f"column count {L} is not a positive multiple of {RATE}")
    state = torch.zeros((N, WIDTH), dtype=torch.int64, device=x.device)
    for i in range(0, L, RATE):
        state[:, :RATE] = x[i : i + RATE].t()
        state = permute_tensor(state)
    return GF(state[:, :DIGEST])


def two_to_one(left: GF, right: GF) -> GF:
    """Batched 2-to-1 compression: (..., 4), (..., 4) -> (..., 4)."""
    l = left.v
    zeros = torch.zeros(l.shape[:-1] + (WIDTH - 2 * DIGEST,), dtype=torch.int64, device=l.device)
    state = torch.cat([l, right.v, zeros], dim=-1)
    return GF(permute_tensor(state)[..., :DIGEST])
