"""Number-theoretic transform and low-degree extension over Goldilocks.

Counterpart of ``tendermintx_tpu/ops/ntt.py``, on the LAST axis (leading
axes are batch, e.g. trace columns). ``ntt``, ``intt`` and ``coset_lde``
dispatch on the tensor's device: a CPU tensor takes the plain version
(``*_plain``: radix-2 iterative Cooley-Tukey, twiddles precomputed on the
host, butterflies as field ops on tensors); a CUDA tensor launches the
hand kernel ``csrc/ntt.cu`` or raises. ``schedule_plain`` is the kernel's
plain twin: its passes and index arithmetic as torch ops.
"""

from __future__ import annotations

import ctypes
from functools import cache

import numpy as np
import torch

from .goldilocks import GF, MULTIPLICATIVE_GENERATOR, P, tensor_from_u64

# ---------------------------------------------------------------------------
# Host-side root/twiddle tables
# ---------------------------------------------------------------------------


@cache
def primitive_root_of_unity(log_n: int) -> int:
    if not 0 <= log_n <= 32:
        raise ValueError(f"no 2^{log_n}-th root of unity in Goldilocks")
    return pow(MULTIPLICATIVE_GENERATOR, (P - 1) >> log_n, P)


@cache
def bit_reverse_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _powers_u64(base: int, count: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint64)
    acc = 1
    for i in range(count):
        out[i] = acc
        acc = acc * base % P
    return out


@cache
def stage_twiddles(log_n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Per-stage twiddle tables as uint64 arrays; stage s has 2^s entries."""
    n = 1 << log_n
    w = primitive_root_of_unity(log_n)
    if inverse:
        w = pow(w, P - 2, P)
    return tuple(
        _powers_u64(pow(w, n // (2 << s), P), 1 << s) for s in range(log_n)
    )


@cache
def power_table(base: int, count: int) -> np.ndarray:
    """[base^0, ..., base^(count-1)] as a uint64 array."""
    return _powers_u64(base % P, count)


def _gf_const(u64: np.ndarray, device) -> GF:
    return GF(tensor_from_u64(u64, device))


@cache
def power_tensor(base: int, count: int, device) -> torch.Tensor:
    """power_table(base, count) as an int64 tensor on `device`, uploaded
    once per (base, count, device) and kept for the process."""
    return tensor_from_u64(power_table(base, count), device)


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    return log_n


# ---------------------------------------------------------------------------
# Plain versions (any device; the CPU path and the kernel's yardstick)
# ---------------------------------------------------------------------------


def _transform(x: GF, inverse: bool) -> GF:
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x
    dev = x.device
    rev = torch.from_numpy(bit_reverse_perm(log_n)).to(dev)
    v = x.v.index_select(-1, rev)
    batch = tuple(x.shape[:-1])
    for s, table in enumerate(stage_twiddles(log_n, inverse)):
        m = 1 << s
        groups = n // (2 * m)
        tw = _gf_const(table, dev)  # (m,)
        view = GF(v.reshape(*batch, groups, 2, m))
        e = view[..., 0, :]
        o = view[..., 1, :] * tw
        v = torch.stack([(e + o).v, (e - o).v], dim=-2).reshape(*batch, n)
    return GF(v)


def ntt_plain(x: GF) -> GF:
    """Forward NTT on the last axis: coefficients -> evaluations
    [p(w^0), ..., p(w^(n-1))] in natural order."""
    return _transform(x, inverse=False)


def intt_plain(x: GF) -> GF:
    """Inverse NTT on the last axis: evaluations -> coefficients."""
    n = x.shape[-1]
    out = _transform(x, inverse=True)
    if n == 1:
        return out
    return out.cmul(pow(n, P - 2, P))


def coset_lde_plain(coeffs: GF, rate_bits: int, shift: int = MULTIPLICATIVE_GENERATOR) -> GF:
    """Coefficients (deg < n on the last axis) -> evaluations on the coset
    shift * <w_N>, N = n * 2^rate_bits, natural order."""
    n = coeffs.shape[-1]
    N = n << rate_bits
    scaled = coeffs * _gf_const(power_table(shift, n), coeffs.device)
    pad = GF.zeros(tuple(coeffs.shape[:-1]) + (N - n,), coeffs.device)
    return ntt_plain(GF.concatenate([scaled, pad], axis=-1))


# ---------------------------------------------------------------------------
# The kernel's schedule (csrc/ntt.cu), shared with its plain twin
# ---------------------------------------------------------------------------

# csrc/ntt.cu: MAX_STAGES (a pass's tile of 2^10 x 8 words, 73,728 B)
MAX_STAGES = 10


def ntt_plan(log_N: int, max_stages: int = MAX_STAGES) -> tuple[int, ...]:
    """Stages per pass of a 2^log_N-point transform: as few passes as
    max_stages allows, the stages spread evenly (the first passes take
    the extra ones). A 1-point transform is one pass of no stages."""
    if log_N == 0:
        return (0,)
    passes = -(-log_N // max_stages)
    return tuple(log_N // passes + (p < log_N % passes) for p in range(passes))


@cache
def twiddle_table(log_N: int, inverse: bool, device) -> torch.Tensor:
    """w^u for u in [0, max(1, N/2)), w the 2^log_N-th root of unity (its
    inverse for the inverse transform): stage s's twiddle for pair offset
    j is entry j * 2^(log_N-1-s)."""
    w = primitive_root_of_unity(log_N)
    if inverse:
        w = pow(w, P - 2, P)
    return power_tensor(w, max(1, (1 << log_N) >> 1), device)


def _entry_args(kind: str, x: torch.Tensor, rate_bits: int = 0, shift: int = 1, powers=None) -> dict:
    """The kernel's arguments for one entry over rows x (..., n): the
    transform's lengths and direction, and its tables."""
    n = int(x.shape[-1])
    log_n = _log2(n)
    dev = x.device
    if kind == "ntt":
        return dict(log_n=log_n, log_N=log_n, inverse=False, pre=None, post=None, post_scalar=1)
    if kind == "intt":
        return dict(log_n=log_n, log_N=log_n, inverse=True, pre=None, post=powers,
                    post_scalar=pow(n, P - 2, P))
    if kind == "coset_lde":
        if rate_bits < 0:
            raise ValueError("rate_bits must be >= 0")
        return dict(log_n=log_n, log_N=log_n + rate_bits, inverse=False,
                    pre=power_tensor(shift, n, dev), post=None, post_scalar=1)
    raise ValueError(f"no NTT entry {kind!r}")


def _rev(x: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(x)
    for b in range(bits):
        out |= ((x >> b) & 1) << (bits - 1 - b)
    return out


def schedule_plain(
    x: torch.Tensor, log_n: int, log_N: int, inverse: bool, pre, post, post_scalar: int,
    ks: tuple[int, ...],
) -> torch.Tensor:
    """The kernel's plain twin: the passes `ks` of csrc/ntt.cu over rows x
    (R, 2^log_n) into (R, 2^log_N), each pass's lines gathered, its
    stages run and the lines scattered with the kernel's index
    arithmetic, as int64 torch ops on x's device."""
    R = int(x.shape[0])
    N, n_in = 1 << log_N, 1 << log_n
    dev = x.device
    tw = twiddle_table(log_N, inverse, dev)
    dst = torch.empty((R, N), dtype=torch.int64, device=dev)
    s0 = 0
    for pi, k in enumerate(ks):
        first, last = pi == 0, pi == len(ks) - 1
        M, lbits = 1 << k, log_N - k
        l = torch.arange(1 << lbits, device=dev)[:, None]
        mid = torch.arange(M, device=dev)[None, :]
        lo = l & ((1 << s0) - 1)
        at = ((l >> s0) << (s0 + k)) | (mid << s0) | lo  # (lines, M) positions
        if first:
            j = (_rev(mid, k) << lbits) | l
            ok = j < n_in
            jc = torch.where(ok, j, 0)
            v = x[:, jc]
            if pre is not None:
                v = (GF(v) * GF(pre[jc])).v
            v = torch.where(ok, v, 0)
            at = (_rev(l, lbits) << k) | mid
        else:
            v = dst[:, at]
        for t in range(k):
            h, s = 1 << t, s0 + t
            p = torch.arange(M // 2, device=dev)
            jp = p & (h - 1)
            m0 = ((p >> t) << (t + 1)) | jp
            m1 = m0 | h
            w = GF(tw[((jp[None, :] << s0) | lo) << (log_N - 1 - s)])  # (lines, M/2)
            x0, x1 = GF(v[..., m0]), GF(v[..., m1]) * w
            v[..., m0] = (x0 + x1).v
            v[..., m1] = (x0 - x1).v
        if last:
            if post_scalar % P != 1:
                v = GF(v).cmul(post_scalar).v
            if post is not None:
                v = (GF(v) * GF(post[at])).v
        dst[:, at] = v
        s0 += k
    return dst


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/ntt.cu)
# ---------------------------------------------------------------------------

# One count per entry, incremented exactly where it is launched: by the
# pass kernels one call of tmx_ntt launches (the transform's 1-3 passes).
ntt_kernel_launches = 0
intt_kernel_launches = 0
lde_kernel_launches = 0


@cache
def _library():
    from .cuda_build import load_library

    lib = load_library("ntt")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tmx_ntt.restype = ctypes.c_int
    lib.tmx_ntt.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_uint64, i64, i32, i32, ptr, i32, ptr]
    return lib


def _check_cuda(t: torch.Tensor, entry: str, what: str, dev, numel: int | None = None):
    if t.device != dev or t.dtype != torch.int64:
        raise TypeError(f"{entry}: {what} must be int64 on {dev}, got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{entry} takes a contiguous {what}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{entry}: {what} has {t.numel()} entries, {numel} wanted")


def _launch(entry: str, x: torch.Tensor, rate_bits: int = 0, shift: int = 1, powers=None):
    """One transform of the rows of contiguous int64 CUDA x (..., n):
    (output, the pass kernels launched; none for no rows)."""
    if x.device.type != "cuda" or x.dtype != torch.int64:
        raise TypeError(f"{entry}_cuda takes an int64 CUDA tensor, got {x.dtype} on {x.device}")
    if x.dim() == 0:
        raise ValueError(f"{entry}_cuda takes rows on the last axis")
    _check_cuda(x, f"{entry}_cuda", "input", x.device)
    a = _entry_args(entry, x, rate_bits, shift, powers)
    if a["post"] is not None:
        _check_cuda(a["post"], f"{entry}_cuda", "power table", x.device, int(x.shape[-1]))
    rows = x.numel() // int(x.shape[-1])
    out = torch.empty(tuple(x.shape[:-1]) + (1 << a["log_N"],), dtype=torch.int64, device=x.device)
    if rows == 0:
        return out, 0
    ks = ntt_plan(a["log_N"])
    tw = twiddle_table(a["log_N"], a["inverse"], x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().tmx_ntt(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), ptr(a["pre"]), ptr(a["post"]), a["post_scalar"],
            rows, a["log_n"], a["log_N"], (ctypes.c_int * len(ks))(*ks), len(ks), stream,
        )
    if err != 0:
        raise RuntimeError(f"tmx_ntt ({entry}) launch failed: CUDA error {err}")
    return out, len(ks)


def ntt_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the forward NTT kernel on contiguous int64 CUDA rows."""
    global ntt_kernel_launches
    out, launched = _launch("ntt", x)
    ntt_kernel_launches += launched
    return out


def intt_cuda(x: torch.Tensor, powers: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the inverse NTT kernel (n^-1 folded in, and `powers`[i] into
    output i when given) on contiguous int64 CUDA rows."""
    global intt_kernel_launches
    out, launched = _launch("intt", x, powers=powers)
    intt_kernel_launches += launched
    return out


def coset_lde_cuda(x: torch.Tensor, rate_bits: int, shift: int = MULTIPLICATIVE_GENERATOR) -> torch.Tensor:
    """Launch the coset LDE kernel on contiguous int64 CUDA coefficient rows."""
    global lde_kernel_launches
    out, launched = _launch("coset_lde", x, rate_bits, shift)
    lde_kernel_launches += launched
    return out


def schedule_twin(kind: str, x: torch.Tensor, rate_bits: int = 0, shift: int = MULTIPLICATIVE_GENERATOR,
                  powers=None, max_stages: int = MAX_STAGES) -> torch.Tensor:
    """An entry computed by the kernel's plain twin (schedule_plain) with
    the arguments the kernel gets, over rows x (..., n)."""
    a = _entry_args(kind, x, rate_bits, shift, powers)
    rows = x.reshape(-1, int(x.shape[-1]))
    out = schedule_plain(rows, a["log_n"], a["log_N"], a["inverse"], a["pre"], a["post"], a["post_scalar"],
                         ntt_plan(a["log_N"], max_stages))
    return out.reshape(tuple(x.shape[:-1]) + (1 << a["log_N"],))


# ---------------------------------------------------------------------------
# Dispatch: plain on the CPU, the kernel on a card
# ---------------------------------------------------------------------------


def _device_type(x: GF, entry: str) -> str:
    t = x.device.type
    if t not in ("cpu", "cuda"):
        raise ValueError(f"no {entry} for device {x.device}")
    return t


def ntt(x: GF) -> GF:
    """Forward NTT on the last axis: coefficients -> evaluations
    [p(w^0), ..., p(w^(n-1))] in natural order."""
    if _device_type(x, "ntt") == "cpu":
        return ntt_plain(x)
    return GF(ntt_cuda(x.v))


def intt(x: GF, powers: GF | None = None) -> GF:
    """Inverse NTT on the last axis: evaluations -> coefficients, each
    coefficient i times powers[i] when given (the coset iNTT's shift^-i)."""
    if _device_type(x, "intt") == "cpu":
        out = intt_plain(x)
        return out if powers is None else out * powers
    return GF(intt_cuda(x.v, None if powers is None else powers.v))


def coset_lde(coeffs: GF, rate_bits: int, shift: int = MULTIPLICATIVE_GENERATOR) -> GF:
    """Coefficients (deg < n on the last axis) -> evaluations on the coset
    shift * <w_N>, N = n * 2^rate_bits, natural order."""
    if _device_type(coeffs, "coset_lde") == "cpu":
        return coset_lde_plain(coeffs, rate_bits, shift)
    return GF(coset_lde_cuda(coeffs.v, rate_bits, shift))


# ---------------------------------------------------------------------------
# Host oracle (tests / verifier)
# ---------------------------------------------------------------------------


def ntt_ints(coeffs: list[int]) -> list[int]:
    """Recursive NTT on Python ints (natural-order output)."""
    n = len(coeffs)
    if n == 1:
        return list(coeffs)
    w = primitive_root_of_unity(n.bit_length() - 1)
    even = ntt_ints(coeffs[0::2])
    odd = ntt_ints(coeffs[1::2])
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % P
        out[k] = (even[k] + t) % P
        out[k + n // 2] = (even[k] - t) % P
        wk = wk * w % P
    return out


def eval_poly_ints(coeffs: list[int], x: int) -> int:
    """p(x) for p's coefficients, Horner on Python ints."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc
