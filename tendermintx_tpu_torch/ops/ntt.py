"""Number-theoretic transform and low-degree extension over Goldilocks.

Counterpart of ``tendermintx_tpu/ops/ntt.py``, on the LAST axis (leading
axes are batch, e.g. trace columns). ``ntt``, ``intt`` and ``coset_lde``
dispatch on the tensor's device: a CPU tensor takes the plain version
(``*_plain``: radix-2 iterative Cooley-Tukey, twiddles precomputed on the
host, butterflies as field ops on tensors); a CUDA tensor launches the
hand kernel ``csrc/ntt.cu`` or raises. ``ntt_plan`` cuts a transform into
the kernel's passes; ``schedule_plain`` is the kernel's plain twin: its
passes, coset split, register rounds, twists and index arithmetic as
torch ops.
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

# csrc/ntt.cu: MAX_K (stages a pass: a block's tile of 2^13 words holds
# 2^(13-k) lines of a 2^k-point pass, at least 16) and MAX_PASSES
MAX_K = 9
MAX_PASSES = 3


def ntt_plan(log_N: int, rate_bits: int = 0, max_k: int = MAX_K) -> tuple[int, ...]:
    """Stages per pass of a 2^log_N-point transform whose first pass also
    splits 2^rate_bits cosets (the coset LDE; 0 otherwise): as few passes
    as max_k allows, at most MAX_PASSES, the stages spread evenly (the
    first passes take the extra ones) and the first pass at least
    rate_bits. A 1-point transform is one pass of no stages."""
    if not 0 <= rate_bits <= min(max_k, log_N):
        raise ValueError(f"no NTT plan splits 2^{rate_bits} cosets of a 2^{log_N}-point transform")
    passes = max(1, -(-log_N // max_k))
    if passes > MAX_PASSES:
        raise ValueError(f"a 2^{log_N}-point transform needs more than {MAX_PASSES} passes of {max_k} stages")
    ks = [log_N // passes + (p < log_N % passes) for p in range(passes)]
    if ks[0] < rate_bits:
        rest = log_N - rate_bits
        ks = [rate_bits] + [rest // (passes - 1) + (p < rest % (passes - 1)) for p in range(passes - 1)]
    return tuple(ks)


def round_digits(k: int) -> tuple[int, ...]:
    """csrc/ntt.cu: digit(k, r), the register rounds of a pass's 2^k-point
    DFT: each thread holds a radix-2^d sub-transform of each round in
    registers; the tile in shared memory is touched once a round."""
    return {9: (3, 3, 3), 8: (4, 4), 7: (4, 3), 6: (3, 3), 5: (3, 2)}.get(k, (k,))


def _root(log_n: int, inverse: bool) -> int:
    w = primitive_root_of_unity(log_n)
    return pow(w, P - 2, P) if inverse else w


@cache
def twiddle_table(log_N: int, inverse: bool, device) -> torch.Tensor:
    """w^u for u in [0, max(1, N/2)), w the 2^log_N-th root of unity (its
    inverse for the inverse transform); w^(u + N/2) = -w^u."""
    return power_tensor(_root(log_N, inverse), max(1, (1 << log_N) >> 1), device)


@cache
def root16(inverse: bool) -> tuple[int, ...]:
    """The 16 powers of the 16th root of unity (its inverse for the inverse
    transform): every register sub-transform's twiddles (a 2^d-point
    root is the (16/2^d)-th power); csrc/ntt.cu takes them as arguments."""
    w = _root(4, inverse)
    return tuple(pow(w, i, P) for i in range(16))


@cache
def first_pass_tables(log_n: int, rate_bits: int, K: int, shift: int, scale: int, device):
    """The first pass's small tables, or None where they would be all ones:
    F[e * C + t] = shift^(e * 2^(log_n - k)) * w_{2^K}^(t * e) for the k =
    K - rate_bits input digits e and the C = 2^rate_bits cosets t (applied
    as each input is loaded), and S[l] = scale * shift^l for the first
    pass's lines l (folded into the twist between passes)."""
    k, C = K - rate_bits, 1 << rate_bits
    shift %= P
    F = None
    if C > 1 or shift != 1:
        s_e = pow(shift, 1 << (log_n - k), P)
        wK = primitive_root_of_unity(K)
        F = np.empty((1 << k) * C, dtype=np.uint64)
        for e in range(1 << k):
            base = pow(s_e, e, P)
            step = pow(wK, e, P)
            for t in range(C):
                F[e * C + t] = base
                base = base * step % P
        F = tensor_from_u64(F, device)
    S = None
    if scale % P != 1 or shift != 1:
        S = tensor_from_u64(np.array([v * scale % P for v in power_table(shift, 1 << (log_n - k)).tolist()],
                                     dtype=np.uint64), device)
    return F, S


def _entry_args(kind: str, x: torch.Tensor, rate_bits: int = 0, shift: int = 1, powers=None) -> dict:
    """The kernel's arguments for one entry over rows x (..., n): the
    transform's lengths, direction, coset split, its scale (n^-1 for the
    inverse) and shift, and its optional output power table."""
    n = int(x.shape[-1])
    log_n = _log2(n)
    if kind == "ntt":
        return dict(log_n=log_n, rate=0, inverse=False, shift=1, scale=1, post=None)
    if kind == "intt":
        return dict(log_n=log_n, rate=0, inverse=True, shift=1, scale=pow(n, P - 2, P), post=powers)
    if kind == "coset_lde":
        if rate_bits < 0:
            raise ValueError("rate_bits must be >= 0")
        return dict(log_n=log_n, rate=rate_bits, inverse=False, shift=shift % P, scale=1, post=None)
    raise ValueError(f"no NTT entry {kind!r}")


def _rev(x: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(x)
    for b in range(bits):
        out |= ((x >> b) & 1) << (bits - 1 - b)
    return out


def _omega(tw: torch.Tensor, e: torch.Tensor, log_N: int) -> torch.Tensor:
    """csrc/ntt.cu: omega, w^e for e in [0, N) from the half table."""
    half = max(1, (1 << log_N) >> 1)
    hi = e >= half
    v = tw[torch.where(hi, e - half, e)]
    return torch.where(hi, GF(v).__neg__().v, v)


def _dft_regs(v: torch.Tensor, d: int, r16: torch.Tensor) -> torch.Tensor:
    """csrc/ntt.cu: dft_regs, the 2^d-point DFT of the last axis as the
    registers run it: inputs bit-reversed, then radix-2 stages whose
    twiddles w_{2h}^j are powers of the 16th root (none for j = 0)."""
    M = 1 << d
    vals = [v[..., int(_rev(torch.tensor(i), d))] for i in range(M)]
    for s in range(d):
        h = 1 << s
        for blk in range(0, M, 2 * h):
            for j in range(h):
                a, b = GF(vals[blk + j]), GF(vals[blk + j + h])
                if j:
                    b = b * GF(r16[j * (16 >> (s + 1))])
                vals[blk + j], vals[blk + j + h] = (a + b).v, (a - b).v
    return torch.stack(vals, dim=-1)


def _pass_dft(X: torch.Tensor, k: int, inverse: bool) -> torch.Tensor:
    """A pass's 2^k-point DFT of the last axis of X (natural input order)
    in the kernel's register rounds (decimation in time over the digits
    of round_digits(k), in place in the tile): round 0 reads input
    lam + e * 2^(k - d0) of item lam and writes positions v + rev(lam) *
    2^d0; round r >= 1 reads positions v' + e * 2^S(r-1) + rho * 2^S(r)
    of item (v', rho), multiplies them by w_{2^S(r)}^(e v') from the
    pass's root table and writes its outputs v over the e. Returns the
    last round's outputs (..., 2^(k - d_last) items v', 2^d_last outputs
    v), output u = v' + v * 2^(k - d_last)."""
    dev = X.device
    digits = round_digits(k)
    m = len(digits)
    r16 = torch.tensor([v - (1 << 64) if v >= 1 << 63 else v for v in root16(inverse)], dtype=torch.int64, device=dev)
    W = power_tensor(_root(k, inverse), 1 << k, dev)
    work = torch.empty_like(X)
    d0 = digits[0]
    lam = torch.arange(1 << (k - d0), device=dev)[:, None]
    e = torch.arange(1 << d0, device=dev)[None, :]
    y = _dft_regs(X[..., lam + (e << (k - d0))], d0, r16)
    if m == 1:
        return y
    # rev: lam's digits (from low: d_{m-1}, ..., d_1) in reverse order
    rev = lam if m == 2 else (lam >> digits[2]) | ((lam & ((1 << digits[2]) - 1)) << digits[1])
    work[..., e + (rev << d0)] = y
    S = d0
    for r in range(1, m):
        d = digits[r]
        nu = torch.arange(1 << (k - d), device=dev)[:, None]
        vp, rho = nu & ((1 << S) - 1), nu >> S
        e = torch.arange(1 << d, device=dev)[None, :]
        pos = vp + (e << S) + (rho << (S + d))
        vals = GF(work[..., pos]) * GF(W[(e * vp) << (k - S - d)])
        y = _dft_regs(vals.v, d, r16)
        if r == m - 1:
            return y
        work[..., pos] = y
        S += d


def _progression(values: torch.Tensor, base: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """csrc/ntt.cu: the twist between passes, values[..., i] * base *
    step^i, its factors made by one multiply each from the last."""
    out = torch.empty_like(values)
    tw = GF(base)
    for i in range(values.shape[-1]):
        out[..., i] = (GF(values[..., i]) * tw).v
        tw = tw * GF(step)
    return out


def schedule_plain(x: torch.Tensor, log_n: int, rate: int, inverse: bool, shift: int, scale: int, post,
                   ks: tuple[int, ...]) -> torch.Tensor:
    """The kernel's plain twin: the passes `ks` of csrc/ntt.cu over rows x
    (R, 2^log_n) into (R, 2^(log_n + rate)), with the kernel's coset
    split, lines, register rounds, twists and index arithmetic as int64
    torch ops on x's device.

    Pass 0 (K0 = ks[0] stages, k = K0 - rate of them on the input): line
    l < 2^(log_N - K0) of a row and coset t < 2^rate load inputs l + e *
    2^(log_n - k) times F[e * C + t], run the 2^k-point DFT and twist
    output u = t + C * u_k by S[l] * w_N^(l u); the line's run of 2^K0
    outputs is stored at u + rest(l) * 2^K0, rest(l) l's later-pass digits
    in reverse order. A later pass over stages [s, s + K) runs the
    2^K-point DFT of each line D + R * 2^s in place over positions D + e *
    2^s + R * 2^(s + K); a middle pass twists output u by w_N^(R u 2^s),
    the last multiplies by post. One pass: no twist, scale and post at
    the end."""
    dev = x.device
    R = int(x.shape[0])
    log_N = log_n + rate
    N, C = 1 << log_N, 1 << rate
    P_ = len(ks)
    tw = twiddle_table(log_N, inverse, dev)
    F, Stab = first_pass_tables(log_n, rate, ks[0], shift, scale, dev)
    dst = torch.empty((R, N), dtype=torch.int64, device=dev)
    # pass 0
    K = ks[0]
    k = K - rate
    lb = log_N - K
    l = torch.arange(1 << lb, device=dev)[:, None, None]
    t = torch.arange(C, device=dev)[None, :, None]
    e = torch.arange(1 << k, device=dev)[None, None, :]
    X = x[:, l + (e << (log_n - k))].expand(R, 1 << lb, C, 1 << k)  # (R, lines, C, 2^k)
    if F is not None:
        X = (GF(X) * GF(F[e * C + t])).v
    y = _pass_dft(X.contiguous(), k, inverse)  # (R, lines, C, items v', outputs v)
    dl = round_digits(k)[-1]
    vp = torch.arange(1 << (k - dl), device=dev)[None, None, :]
    v = torch.arange(1 << dl, device=dev)
    u = (t + C * vp)[..., None] + ((C * v) << (k - dl))  # (1, C, v', v)
    if P_ == 1:
        if scale % P != 1:
            y = GF(y).cmul(scale).v
        if post is not None:
            y = (GF(y) * GF(post[u])).v
        dst[:, u[0]] = y[:, 0]
        return dst
    base = _omega(tw, l * (t + C * vp), log_N)  # (lines, C, v')
    if Stab is not None:
        base = (GF(base) * GF(Stab[l])).v
    y = _progression(y, base, _omega(tw, l << (K - dl), log_N))
    K1, K2 = ks[1], (ks[2] if P_ > 2 else 0)
    rest = (l >> K2) | ((l & ((1 << K2) - 1)) << K1)
    dst[:, u + (rest[..., None] << K)] = y
    s = K
    for p in range(1, P_):
        K = ks[p]
        lines = torch.arange(1 << (log_N - K), device=dev)[:, None]
        D, Rr = lines & ((1 << s) - 1), lines >> s
        e = torch.arange(1 << K, device=dev)[None, :]
        y = _pass_dft(dst[:, D + (e << s) + (Rr << (s + K))], K, inverse)  # (R, lines, v', v)
        dl = round_digits(K)[-1]
        vp = torch.arange(1 << (K - dl), device=dev)[None, :]
        u = vp[..., None] + (torch.arange(1 << dl, device=dev) << (K - dl))  # (1, v', v)
        if p < P_ - 1:
            y = _progression(y, _omega(tw, (Rr * vp) << s, log_N), _omega(tw, Rr << (K - dl + s), log_N))
        elif post is not None:
            y = (GF(y) * GF(post[D[..., None] + (u << s)])).v
        dst[:, D[..., None] + (u << s) + (Rr[..., None] << (s + K))] = y
        s += K
    return dst


def schedule_twin(kind: str, x: torch.Tensor, rate_bits: int = 0, shift: int = MULTIPLICATIVE_GENERATOR,
                  powers=None, max_k: int = MAX_K) -> torch.Tensor:
    """An entry computed by the kernel's plain twin (schedule_plain) with
    the arguments the kernel gets, over rows x (..., n), at passes of at
    most max_k stages."""
    a = _entry_args(kind, x, rate_bits, shift, powers)
    rows = x.reshape(-1, int(x.shape[-1]))
    ks = ntt_plan(a["log_n"] + a["rate"], a["rate"], max_k)
    out = schedule_plain(rows, a["log_n"], a["rate"], a["inverse"], a["shift"], a["scale"], a["post"], ks)
    return out.reshape(tuple(x.shape[:-1]) + (1 << (a["log_n"] + a["rate"]),))


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
    lib.tmx_ntt.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_uint64, ptr, i64, i32, i32, ptr, i32, ptr]
    return lib


def _check_cuda(t: torch.Tensor, entry: str, what: str, dev, numel: int | None = None):
    if t.device != dev or t.dtype != torch.int64:
        raise TypeError(f"{entry}: {what} must be int64 on {dev}, got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{entry} takes a contiguous {what}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{entry}: {what} has {t.numel()} entries, {numel} wanted")


@cache
def _plan_args(log_n: int, rate: int, inverse: bool, shift: int, scale: int, device):
    """The plan of one transform shape and tmx_ntt's arguments for it, made
    once: (ks, (twiddles, pass root tables, F, S, scale, 16th-root powers,
    ks) as ctypes values; the tables stay alive in the cache)."""
    ks = ntt_plan(log_n + rate, rate)
    tw = twiddle_table(log_n + rate, inverse, device)
    roots = [power_tensor(_root(k, inverse), 1 << k, device) for k in (ks[0] - rate,) + ks[1:]]
    F, S = first_pass_tables(log_n, rate, ks[0], shift, scale, device)
    ptr = lambda t: None if t is None else t.data_ptr()
    return ks, (tw.data_ptr(), (ctypes.c_void_p * len(roots))(*[t.data_ptr() for t in roots]), ptr(F), ptr(S),
                scale, (ctypes.c_uint64 * 16)(*root16(inverse)), (ctypes.c_int * len(ks))(*ks))


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
    log_N = a["log_n"] + a["rate"]
    out = torch.empty(tuple(x.shape[:-1]) + (1 << log_N,), dtype=torch.int64, device=x.device)
    if rows == 0:
        return out, 0
    dev = x.device
    ks, c_args = _plan_args(a["log_n"], a["rate"], a["inverse"], a["shift"], a["scale"], dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().tmx_ntt(
            x.data_ptr(), out.data_ptr(), *c_args[:4], None if a["post"] is None else a["post"].data_ptr(),
            *c_args[4:6], rows, a["log_n"], a["rate"], c_args[6], len(ks), stream,
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
