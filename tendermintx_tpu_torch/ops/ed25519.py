"""Ed25519: host integer arithmetic and batched verification on a torch device.

Counterpart of ``tendermintx_tpu/ops/ed25519.py``. The host part (curve
constants, RFC 8032 decompression, affine addition, 13-bit limb packing,
the pure-Python ``verify_ints`` oracle) feeds the Ed25519 AIR's traces and
the witness preparation. The device part verifies one signature per lane,
the cofactorless equation [s]B == R + [k]A as Q = [s]B + [k](-A), Q == R
projectively: a 253-step double-and-add Straus ladder over a 4-entry
table, plus ``bind_witness``, which re-derives every ladder input from the
raw (pubkey, message, signature) bytes and the challenge digest
(ops/sha512.py: sha512_challenge). ``straus_verify`` and ``bind_witness``
run the plain torch versions below for a CPU tensor and csrc/ed25519.cu's
kernels (radix 2^25.5, csrc/ed25519.cuh) for a CUDA tensor.

Field elements mod p = 2^255 - 19 are 20 limbs of 13 bits in int64
tensors. The reference normalises limbs after every operation with a
sequential carry (39 + 21 dependent steps per multiply). Here the ladder's
arithmetic keeps limbs *bounded* instead: a carry pass moves every limb's
bits above 13 one limb up at once (limb 19's, of weight 2^260 = 608 mod p,
to limb 0 times 608). From limbs in [0, 9215] a product's 40 anti-diagonal
sums fold to 20 limbs below 2^42, and three passes bring every limb back
to <= 8799; a sum or a padded difference needs two (``_PASSES_*``; the
bound is checked by tests/test_torch_witness.py). Values stay
non-negative, so every shift is exact. ``to_canonical`` (and through it
``feq``) runs the reference's sequential carry and conditional
subtractions, so every comparison the verifier makes is on canonical
values, as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
from functools import cache

import numpy as np
import torch

from .cuda_build import operand

P25519 = 2**255 - 19
L_ORDER = 2**252 + 27742317777372353535851937790883648493
D_ED = (-121665 * pow(121666, P25519 - 2, P25519)) % P25519
D2_ED = (2 * D_ED) % P25519
BASE_Y = (4 * pow(5, P25519 - 2, P25519)) % P25519

N_LIMBS = 20
LIMB_BITS = 13
LIMB_MASK = (1 << LIMB_BITS) - 1
N_BITS = 253

SQRT_M1 = pow(2, (P25519 - 1) // 4, P25519)


def recover_x(y: int, sign: int) -> int | None:
    """Ed25519 point decompression (RFC 8032 §5.1.3)."""
    if y >= P25519:
        return None
    x2 = (y * y - 1) * pow(D_ED * y * y + 1, P25519 - 2, P25519) % P25519
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P25519 + 3) // 8, P25519)
    if (x * x - x2) % P25519 != 0:
        x = x * SQRT_M1 % P25519
    if (x * x - x2) % P25519 != 0:
        return None
    if x & 1 != sign:
        x = P25519 - x
    return x


def decompress(point: bytes) -> tuple[int, int] | None:
    y = int.from_bytes(point, "little") & ((1 << 255) - 1)
    sign = point[31] >> 7
    x = recover_x(y, sign)
    if x is None:
        return None
    return (x, y)


BASE_POINT = (recover_x(BASE_Y, 0), BASE_Y)


# -- host (python int) Edwards arithmetic: witness prep + oracle ------------


def pt_add(p, q):
    (x1, y1), (x2, y2) = p, q
    x3 = (x1 * y2 + x2 * y1) * pow(1 + D_ED * x1 * x2 * y1 * y2, P25519 - 2, P25519)
    y3 = (y1 * y2 + x1 * x2) * pow(1 - D_ED * x1 * x2 * y1 * y2, P25519 - 2, P25519)
    return (x3 % P25519, y3 % P25519)


def pt_neg(p):
    x, y = p
    return ((-x) % P25519, y)


def pt_mul(k: int, p):
    q = (0, 1)
    while k:
        if k & 1:
            q = pt_add(q, p)
        p = pt_add(p, p)
        k >>= 1
    return q


def verify_ints(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Host oracle: cofactorless Ed25519 verification in pure Python."""
    A = decompress(pubkey)
    R = decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L_ORDER:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pubkey + msg).digest(), "little") % L_ORDER
    return pt_mul(s, BASE_POINT) == pt_add(R, pt_mul(k, A))


# ---------------------------------------------------------------------------
# Limb packing
# ---------------------------------------------------------------------------


def int_to_limbs(x: int) -> np.ndarray:
    out = np.zeros(N_LIMBS, dtype=np.uint32)
    for i in range(N_LIMBS):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit 20 limbs of 13 bits")
    return out


def limbs_to_int(limbs) -> int:
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(np.asarray(limbs).tolist()))


def _make_sub_pad() -> list[int]:
    """Limbs of 256p with every limb >= 2^15 (borrowing 4 from each next
    limb), the 21st limb (7, weight 2^260 = 608 mod p) folded into limb 0:
    pad + a - b stays non-negative limb by limb for limbs of b <= 2^15."""
    v = 256 * P25519
    base = []
    for _ in range(21):
        base.append(v & LIMB_MASK)
        v >>= LIMB_BITS
    for i in range(20):
        base[i] += 1 << 15
        base[i + 1] -= 4
    if min(base[:20]) < 1 << 15 or base[20] < 0:
        raise AssertionError("sub pad construction")
    base[0] += base[20] * 608
    return base[:20]


_SUB_PAD = _make_sub_pad()

# Carry passes that bring limbs back to <= 8799 (< 2^13 + 2^10) from the
# inputs' bound of 9215: after a product (folded limbs < 2^42) and after a
# sum or a padded difference.
_PASSES_MUL = 3
_PASSES_ADD = 2
LAZY_LIMB_BOUND = 9215


@cache
def _const(values: tuple, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def _limbs_const(x: int, device) -> torch.Tensor:
    return _const(tuple(int(v) for v in int_to_limbs(x)), str(device))


# ---------------------------------------------------------------------------
# Device field ops: (..., 20) int64 limbs
# ---------------------------------------------------------------------------


def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    """Every limb keeps its low 13 bits and hands the rest one limb up, all
    limbs at once; limb 19's carry re-enters limb 0 times 608."""
    c = x >> LIMB_BITS
    out = x & LIMB_MASK
    out[..., 1:] += c[..., :-1]
    out[..., 0] += 608 * c[..., -1]
    return out


def _passes(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = _carry_pass(x)
    return x


def fadd(a, b):
    return _passes(a + b, _PASSES_ADD)


def fsub(a, b):
    return _passes(a - b + _const(tuple(_SUB_PAD), str(a.device)), _PASSES_ADD)


def _product_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact schoolbook product: (..., 20) x (..., 20) -> (..., 40) limb
    sums acc[k] = sum_{i+j=k} a[i] b[j] (limb 39 is 0). Row i of the
    outer product, padded to 41 entries, lands at column i + j of a
    (20, 40) view of the flattened rows; summing the rows gives the
    anti-diagonals."""
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-1]
    outer = a[..., :, None] * b[..., None, :]
    flat = torch.nn.functional.pad(outer, (0, N_LIMBS + 1)).reshape(*lead, N_LIMBS * (2 * N_LIMBS + 1))
    return flat[..., : N_LIMBS * 2 * N_LIMBS].reshape(*lead, N_LIMBS, 2 * N_LIMBS).sum(-2)


def fmul(a, b):
    acc = _product_limbs(a, b)
    # limbs 20 + j have weight 2^(260 + 13j) = 608 * 2^(13j) mod p
    return _passes(acc[..., :N_LIMBS] + 608 * acc[..., N_LIMBS:], _PASSES_MUL)


def fsquare(a):
    return fmul(a, a)


def _carry_step(x: torch.Tensor, i: int):
    c = x[..., i] >> LIMB_BITS
    x[..., i] &= LIMB_MASK
    x[..., i + 1] += c


def _carry_seq(x: torch.Tensor, n_steps: int) -> torch.Tensor:
    """The reference's sequential carry over the first n_steps limbs."""
    x = x.clone()
    for i in range(n_steps):
        _carry_step(x, i)
    return x


def _carry20(x: torch.Tensor) -> torch.Tensor:
    """Sequential carry into 13-bit limbs, bits at and above 2^255 folded
    back times 19, as the reference does."""
    x = _carry_seq(x, N_LIMBS - 1)
    h = x[..., -1] >> 8
    x[..., -1] &= 0xFF
    x[..., 0] += 19 * h
    for i in range(2):
        _carry_step(x, i)
    return x


def _try_sub(x: torch.Tensor, c_limbs: list[int]) -> torch.Tensor:
    """x - c limb by limb with borrow where x >= c, else x."""
    borrow = torch.zeros_like(x[..., 0])
    digits = []
    for i in range(N_LIMBS):
        d = x[..., i] + (1 << LIMB_BITS) - c_limbs[i] - borrow
        digits.append(d & LIMB_MASK)
        borrow = (d >> LIMB_BITS) ^ 1
    return torch.where((borrow == 0)[..., None], torch.stack(digits, -1), x)


_P_LIMBS = [int(v) for v in int_to_limbs(P25519)]


def to_canonical(x):
    """Fully reduce a non-negative limb vector into [0, p)."""
    x = _carry20(x)
    x = _try_sub(x, _P_LIMBS)
    return _try_sub(x, _P_LIMBS)


def feq(a, b):
    """Canonical equality of two field elements."""
    return (to_canonical(fsub(a, b)) == 0).all(-1)


# ---------------------------------------------------------------------------
# Device point arithmetic: extended coordinates (X, Y, Z, T), a = -1.
# Independent products are stacked into one batched fmul.
# ---------------------------------------------------------------------------


def _pt_double(X, Y, Z):
    """dbl-2008-hwcd (a = -1); T is not an input of doubling."""
    XY = fadd(X, Y)
    A, B, Csq, XY2 = fsquare(torch.stack([X, Y, Z, XY]))
    C, AB = fadd(torch.stack([Csq, A]), torch.stack([Csq, B]))
    G = fsub(B, A)  # aA + B with a = -1
    F, H, E = fsub(torch.stack([G, torch.zeros_like(AB), XY2]), torch.stack([C, AB, AB]))
    X3, Y3, T3, Z3 = fmul(torch.stack([E, G, E, F]), torch.stack([F, H, H, G]))
    return X3, Y3, Z3, T3


def _pt_madd_pre(X1, Y1, Z1, T1, ymx2, ypx2, t2d2):
    """Unified mixed addition with an affine point given as (y2 - x2,
    y2 + x2, 2d * x2 * y2)."""
    ymx1 = fsub(Y1, X1)
    ypx1, D = fadd(torch.stack([Y1, Z1]), torch.stack([X1, Z1]))
    A, B, C = fmul(torch.stack([ymx1, ypx1, T1]), torch.stack([ymx2, ypx2, t2d2]))
    E, F = fsub(torch.stack([B, D]), torch.stack([A, C]))
    G, H = fadd(torch.stack([D, B]), torch.stack([C, A]))
    X3, Y3, T3, Z3 = fmul(torch.stack([E, G, E, F]), torch.stack([F, H, H, G]))
    return X3, Y3, Z3, T3


def _madd_operands(x2, y2, t2):
    ymx, ypx = fsub(y2, x2), fadd(y2, x2)
    return ymx, ypx, fmul(t2, _limbs_const(D2_ED, x2.device))


def _pt_madd(X1, Y1, Z1, T1, x2, y2, t2):
    """Mixed addition with affine (x2, y2), t2 = x2*y2 (unified/complete)."""
    return _pt_madd_pre(X1, Y1, Z1, T1, *_madd_operands(x2, y2, t2))


def _select_steps(table: torch.Tensor, bits2: torch.Tensor) -> torch.Tensor:
    """table: (B, 4, 20); bits2: (B, N) in {0..3}. -> (B, N, 20): entry
    bits2[b, i] of lane b's table for every step (all-zero limbs for a
    selector outside 0..3, as the reference's one-hot sum gives)."""
    valid = (bits2 >= 0) & (bits2 <= 3)
    idx = torch.where(valid, bits2, 0)
    sel = torch.take_along_dim(table, idx[:, :, None], dim=1)
    return torch.where(valid[:, :, None], sel, 0)


# incremented exactly where each csrc/ed25519.cu entry is launched
straus_kernel_launches = 0
bind_kernel_launches = 0


def straus_verify(table_x, table_y, table_t, bits2, rx, ry):
    """Batched double-scalar ladder + projective comparison.

    table_*: (B, 4, 20) affine Straus table [identity, B, -A, B-A]
    bits2:   (B, N_BITS) in {0,1,2,3}: 2*bit_k + bit_s (MSB first)
    rx, ry:  (B, 20) affine R
    Returns: (B,) bool, [s]B + [k](-A) == R: the plain ladder for a CPU
    tensor, one csrc/ed25519.cu launch for a CUDA tensor."""
    t = table_x.device.type
    if t == "cpu":
        return straus_verify_plain(table_x, table_y, table_t, bits2, rx, ry)
    if t == "cuda":
        return straus_verify_cuda(table_x, table_y, table_t, bits2, rx, ry)
    raise ValueError(f"no Straus ladder for device {table_x.device}")


def straus_verify_plain(table_x, table_y, table_t, bits2, rx, ry):
    """straus_verify as torch ops (any device)."""
    ymx_t, ypx_t, t2d2_t = _madd_operands(table_x, table_y, table_t)
    ymx_s, ypx_s, t2d2_s = (_select_steps(t, bits2) for t in (ymx_t, ypx_t, t2d2_t))
    X, Y, Z, T = table_x[:, 0], table_y[:, 0], table_y[:, 0], table_t[:, 0]
    for i in range(bits2.shape[1]):
        X, Y, Z, T = _pt_double(X, Y, Z)
        X, Y, Z, T = _pt_madd_pre(X, Y, Z, T, ymx_s[:, i], ypx_s[:, i], t2d2_s[:, i])
    # Q == R  <=>  X == rx*Z and Y == ry*Z (R affine)
    rz = fmul(torch.stack([rx, ry]), Z)
    return feq(X, rz[0]) & feq(Y, rz[1])


# ---------------------------------------------------------------------------
# Device witness binding: re-derive or check every straus_verify input from
# the raw (pubkey, message, signature) bytes, so the verification program
# accepts no unbound witness data.
# ---------------------------------------------------------------------------

_L_LIMBS = [int(v) for v in int_to_limbs(L_ORDER)]
BASE_T = BASE_POINT[0] * BASE_POINT[1] % P25519


def bytes_le_to_limbs(data: torch.Tensor, n_limbs: int, n_bits: int | None = None) -> torch.Tensor:
    """(B, nbytes) uint8 little-endian integer -> (B, n_limbs) 13-bit
    limbs. Bits at and above n_bits are dropped (e.g. the sign bit of a
    compressed point)."""
    B, nbytes = data.shape
    dev = data.device
    total_bits = n_limbs * LIMB_BITS
    shifts = torch.arange(8, device=dev)
    bits = ((data.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(B, nbytes * 8)
    if n_bits is not None and n_bits < nbytes * 8:
        bits = bits * (torch.arange(nbytes * 8, device=dev) < n_bits)
    if nbytes * 8 < total_bits:
        bits = torch.nn.functional.pad(bits, (0, total_bits - nbytes * 8))
    else:
        bits = bits[:, :total_bits]
    w = 1 << torch.arange(LIMB_BITS, device=dev)
    return (bits.reshape(B, n_limbs, LIMB_BITS) * w).sum(-1)


def _lt_const(a: torch.Tensor, c_limbs: list[int]) -> torch.Tensor:
    """a < c for canonical base-2^13 limbs (a: (B, n), c constant)."""
    borrow = torch.zeros_like(a[..., 0])
    for i in range(a.shape[-1]):
        d = a[..., i] + (1 << LIMB_BITS) - c_limbs[i] - borrow
        borrow = (d >> LIMB_BITS) ^ 1
    return borrow == 1


def on_curve(x, y) -> torch.Tensor:
    """-x^2 + y^2 == 1 + d x^2 y^2 over GF(2^255-19), batched."""
    x2, y2 = fsquare(torch.stack([x, y]))
    lhs = fsub(y2, x2)
    rhs = fadd(_limbs_const(1, x.device), fmul(fmul(_limbs_const(D_ED, x.device), x2), y2))
    return feq(lhs, rhs)


@cache
def _bits_weights(device: str) -> torch.Tensor:
    """(253, 20): MSB-first bit i (= bit 252 - i) -> its limb weight."""
    pos = 252 - np.arange(N_BITS)
    W = np.zeros((N_BITS, N_LIMBS), dtype=np.int64)
    W[np.arange(N_BITS), pos // LIMB_BITS] = 1 << (pos % LIMB_BITS)
    return torch.from_numpy(W).to(device)


def _bits_to_limbs(bits: torch.Tensor) -> torch.Tensor:
    """bits: (B, 253) in {0,1}, MSB first. -> canonical 13-bit limbs."""
    return (bits[:, :, None] * _bits_weights(str(bits.device))).sum(1)


def _mul_add_int(q: torch.Tensor, c_limbs: list[int], k: torch.Tensor) -> torch.Tensor:
    """Exact integer q*c + k in base-2^13 limbs (no mod-p folding).
    q: (B, 20) 13-bit limbs; c: 20 constant limbs; k: (B, 20).
    -> (B, 40), carried as the reference carries it."""
    acc = _product_limbs(q, _const(tuple(c_limbs), str(q.device)))
    acc[:, :N_LIMBS] += k
    return _carry_seq(acc, 2 * N_LIMBS - 1)


def _in_range(x: torch.Tensor, hi: int, dims) -> torch.Tensor:
    return ((x >= 0) & (x <= hi)).all(dim=dims)


def bind_witness(
    table_x, table_y, table_t, bits2, rx, ry,
    sig_r, sig_s, sig_pk, digest_bytes, k_q,
):
    """Per-lane check that the Straus witness is exactly the one derived
    from (sig_pk, message, signature).

    sig_r/sig_s: (B, 32) uint8 signature halves; sig_pk: (B, 32) uint8
    compressed public key; digest_bytes: (B, 64) uint8 SHA-512(R‖A‖M);
    k_q: (B, 20) quotient limbs of the challenge's mod-L reduction.
    Returns (B,) bool: the plain checks for a CPU tensor, one
    csrc/ed25519.cu launch for a CUDA tensor."""
    args = (table_x, table_y, table_t, bits2, rx, ry, sig_r, sig_s, sig_pk, digest_bytes, k_q)
    t = rx.device.type
    if t == "cpu":
        return bind_witness_plain(*args)
    if t == "cuda":
        return bind_witness_cuda(*args)
    raise ValueError(f"no witness binding for device {rx.device}")


def bind_witness_plain(
    table_x, table_y, table_t, bits2, rx, ry,
    sig_r, sig_s, sig_pk, digest_bytes, k_q,
):
    """bind_witness as torch ops (any device)."""
    dev = rx.device
    # 0. limb/bit ranges on every witness array
    ok = _in_range(table_x, LIMB_MASK, (1, 2))
    ok &= _in_range(table_y, LIMB_MASK, (1, 2))
    ok &= _in_range(table_t, LIMB_MASK, (1, 2))
    ok &= _in_range(rx, LIMB_MASK, 1)
    ok &= _in_range(ry, LIMB_MASK, 1)
    ok &= _in_range(k_q, LIMB_MASK, 1)
    ok &= _in_range(bits2, 3, 1)

    # 1. R binding: ry is the canonical 255-bit y of sig_r, rx has the
    #    encoded parity and (rx, ry) is on the curve
    y_r = bytes_le_to_limbs(sig_r, N_LIMBS, n_bits=255)
    sign_r = sig_r[:, 31].to(torch.int64) >> 7
    ok &= _lt_const(y_r, _P_LIMBS)
    ok &= feq(ry, y_r)
    ok &= on_curve(rx, ry)
    ok &= (to_canonical(rx)[:, 0] & 1) == sign_r

    # 2. Straus table binding: [identity, B, -A, B + (-A)]
    zero = torch.zeros_like(rx)
    one, bx, by, bt = (
        _limbs_const(v, dev).expand_as(rx) for v in (1, BASE_POINT[0], BASE_POINT[1], BASE_T)
    )
    ok &= feq(table_x[:, 0], zero) & feq(table_y[:, 0], one)
    ok &= feq(table_x[:, 1], bx) & feq(table_y[:, 1], by)
    ok &= feq(table_t, fmul(table_x, table_y)).all(1)
    # slot 2 = -A: y from the pubkey bytes; negation flips the x parity
    y_a = bytes_le_to_limbs(sig_pk, N_LIMBS, n_bits=255)
    sign_a = sig_pk[:, 31].to(torch.int64) >> 7
    ok &= _lt_const(y_a, _P_LIMBS)
    ok &= feq(table_y[:, 2], y_a)
    ok &= on_curve(table_x[:, 2], table_y[:, 2])
    c2x = to_canonical(table_x[:, 2])
    x2_zero = (c2x == 0).all(1)
    ok &= torch.where(x2_zero, sign_a == 0, (c2x[:, 0] & 1) == (1 - sign_a))
    # slot 3 = slot 1 + slot 2, checked projectively via the unified add
    X3, Y3, Z3, _ = _pt_madd(bx, by, one, bt, table_x[:, 2], table_y[:, 2], table_t[:, 2])
    ok &= feq(fmul(table_x[:, 3], Z3), X3)
    ok &= feq(fmul(table_y[:, 3], Z3), Y3)

    # 3. s binding: the s-bits of bits2 recompose to sig_s, and s < L
    s_limbs = bytes_le_to_limbs(sig_s, N_LIMBS)
    ok &= _lt_const(s_limbs, _L_LIMBS)
    ok &= (_bits_to_limbs(bits2 & 1) == s_limbs).all(1)

    # 4. challenge binding: h = SHA-512(R‖A‖M) as a little-endian integer
    #    equals k_q * L + k with k < L, k recomposed from the k-bits of
    #    bits2, i.e. k = h mod L, verified without division
    h_limbs = bytes_le_to_limbs(digest_bytes, 2 * N_LIMBS)
    k_rec = _bits_to_limbs((bits2 >> 1) & 1)
    ok &= _lt_const(k_rec, _L_LIMBS)
    ok &= (_mul_add_int(k_q, _L_LIMBS, k_rec) == h_limbs).all(1)
    return ok


# ---------------------------------------------------------------------------
# csrc/ed25519.cu: the ladder and the binding on a card
# ---------------------------------------------------------------------------


class _StrausArgs(ctypes.Structure):
    """csrc/ed25519.cu's StrausArgs, field for field."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in ("table_x", "table_y", "table_t", "bits2", "rx", "ry")),
        ("lanes", ctypes.c_int64), ("steps", ctypes.c_int64), ("out", ctypes.c_void_p),
    ]


class _BindArgs(ctypes.Structure):
    """csrc/ed25519.cu's BindArgs, field for field."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in ("table_x", "table_y", "table_t", "bits2", "rx", "ry",
                                                "sig_r", "sig_s", "sig_pk", "digest", "k_q")),
        ("lanes", ctypes.c_int64), ("out", ctypes.c_void_p),
    ]


@cache
def _ed_library():
    from .cuda_build import load_library

    lib = load_library("ed25519")
    for fn, args in (("tmx_straus_verify", _StrausArgs), ("tmx_bind_witness", _BindArgs)):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
    return lib


def _ed_launch(fn: str, args, dev):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_ed_library(), fn)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


def _ladder_operands(fn, table_x, table_y, table_t, bits2, rx, ry, steps=None) -> tuple[list[int], int, int]:
    """(pointers, lanes, steps) of the ladder's inputs on one card."""
    dev = table_x.device
    if dev.type != "cuda":
        raise TypeError(f"{fn} runs on a card, got {dev}")
    B = int(table_x.shape[0])
    if steps is None:  # the ladder takes any number of steps, the binding N_BITS
        steps = int(bits2.shape[-1]) if bits2.dim() == 2 else -1
    shapes = ((B, 4, N_LIMBS),) * 3 + ((B, steps), (B, N_LIMBS), (B, N_LIMBS))
    names = ("table_x", "table_y", "table_t", "bits2", "rx", "ry")
    ptrs = [operand(t, dev, torch.int64, shape, f"{fn}'s {name}")
            for t, shape, name in zip((table_x, table_y, table_t, bits2, rx, ry), shapes, names)]
    return ptrs, B, steps


def straus_verify_cuda(table_x, table_y, table_t, bits2, rx, ry):
    """straus_verify_plain's (B,) bool by one csrc/ed25519.cu launch, on
    every input whose limbs lie in [0, 2^13) and for any int64 selector
    (one outside 0..3 selects the all-zero operand): a quad of thread
    pairs a lane, a pair a field product of each phase of a step, 4 lanes
    a one-warp block, the lane's table operands in shared memory.
    Contiguous int64 operands on one card, else raise."""
    global straus_kernel_launches
    ptrs, B, steps = _ladder_operands("straus_verify_cuda", table_x, table_y, table_t, bits2, rx, ry)
    out = torch.empty((B,), dtype=torch.bool, device=table_x.device)
    if B:
        _ed_launch("tmx_straus_verify", _StrausArgs(*ptrs, lanes=B, steps=steps, out=out.data_ptr()),
                   table_x.device)
        straus_kernel_launches += 1
    return out


def bind_witness_cuda(
    table_x, table_y, table_t, bits2, rx, ry,
    sig_r, sig_s, sig_pk, digest_bytes, k_q,
):
    """bind_witness_plain's (B,) bool by one csrc/ed25519.cu launch, on
    every int64 input (the range checks first): 4 lanes a block of two
    warps, their rows staged in shared memory in one burst; one warp runs
    the field checks on a quad of thread pairs a lane (a pair a field
    product of each phase), the other the scalar checks. Contiguous
    operands on one card: the ladder's int64 inputs with N_BITS steps,
    uint8 (B, 32) signature halves and key, uint8 (B, 64) digest and int64
    (B, 20) k_q; else raise."""
    global bind_kernel_launches
    fn = "bind_witness_cuda"
    ptrs, B, _ = _ladder_operands(fn, table_x, table_y, table_t, bits2, rx, ry, steps=N_BITS)
    dev = table_x.device
    ptrs += [operand(t, dev, torch.uint8, (B, n), f"{fn}'s {name}")
             for t, n, name in ((sig_r, 32, "sig_r"), (sig_s, 32, "sig_s"), (sig_pk, 32, "sig_pk"),
                                (digest_bytes, 64, "digest_bytes"))]
    ptrs.append(operand(k_q, dev, torch.int64, (B, N_LIMBS), f"{fn}'s k_q"))
    out = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        _ed_launch("tmx_bind_witness", _BindArgs(*ptrs, lanes=B, out=out.data_ptr()), dev)
        bind_kernel_launches += 1
    return out


def verify_bound(
    table_x, table_y, table_t, bits2, rx, ry,
    sig_r, sig_s, sig_pk, messages, msg_len, k_q,
):
    """Full device verification: derive the SHA-512 challenge from the raw
    bytes, bind every witness array, then run the Straus ladder.

    messages: (B, max_len) uint8 zero-padded; msg_len: (B,). The digest
    input R‖A‖M is assembled where it is hashed (ops/sha512.py:
    sha512_challenge, one kernel on a card), so the verified message is
    exactly the lane's message buffer."""
    from .sha512 import sha512_challenge

    digest = sha512_challenge(sig_r, sig_pk, messages, msg_len)
    bound = bind_witness(
        table_x, table_y, table_t, bits2, rx, ry, sig_r, sig_s, sig_pk, digest, k_q
    )
    return bound & straus_verify(table_x, table_y, table_t, bits2, rx, ry)


# ---------------------------------------------------------------------------
# Host-side batch preparation + end-to-end entry points
# ---------------------------------------------------------------------------


def prepare_batch(pubkeys: list[bytes], msgs: list[bytes], sigs: list[bytes], device=None):
    """Host witness prep: decompress, challenge scalars, Straus tables, as
    int64 tensors on `device`. Raises ValueError on malformed points or
    scalars."""
    B = len(pubkeys)
    table_x = np.zeros((B, 4, N_LIMBS), dtype=np.int64)
    table_y = np.zeros((B, 4, N_LIMBS), dtype=np.int64)
    table_t = np.zeros((B, 4, N_LIMBS), dtype=np.int64)
    bits2 = np.zeros((B, N_BITS), dtype=np.int64)
    rx = np.zeros((B, N_LIMBS), dtype=np.int64)
    ry = np.zeros((B, N_LIMBS), dtype=np.int64)
    for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
        A = decompress(pk)
        R = decompress(sig[:32])
        if A is None or R is None:
            raise ValueError(f"lane {i}: invalid point encoding")
        s = int.from_bytes(sig[32:], "little")
        if s >= L_ORDER:
            raise ValueError(f"lane {i}: scalar s out of range")
        k = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L_ORDER
        negA = pt_neg(A)
        pts = [(0, 1), BASE_POINT, negA, pt_add(BASE_POINT, negA)]
        for j, (x, y) in enumerate(pts):
            table_x[i, j] = int_to_limbs(x)
            table_y[i, j] = int_to_limbs(y)
            table_t[i, j] = int_to_limbs(x * y % P25519)
        for b in range(N_BITS):
            pos = N_BITS - 1 - b
            bits2[i, b] = ((k >> pos) & 1) * 2 + ((s >> pos) & 1)
        rx[i] = int_to_limbs(R[0])
        ry[i] = int_to_limbs(R[1])
    return tuple(torch.from_numpy(a).to(device) for a in (table_x, table_y, table_t, bits2, rx, ry))


def prepare_binding(pubkeys: list[bytes], msgs: list[bytes], sigs: list[bytes], device=None):
    """Host prep of the binding inputs: raw signature halves and pubkey
    bytes (uint8), and the mod-L quotient witness of the challenge."""
    B = len(pubkeys)
    sig_r = np.zeros((B, 32), dtype=np.uint8)
    sig_s = np.zeros((B, 32), dtype=np.uint8)
    sig_pk = np.zeros((B, 32), dtype=np.uint8)
    k_q = np.zeros((B, N_LIMBS), dtype=np.int64)
    for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
        sig_r[i] = np.frombuffer(sig[:32], dtype=np.uint8)
        sig_s[i] = np.frombuffer(sig[32:], dtype=np.uint8)
        sig_pk[i] = np.frombuffer(pk, dtype=np.uint8)
        h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little")
        k_q[i] = int_to_limbs(h // L_ORDER)
    return tuple(torch.from_numpy(a).to(device) for a in (sig_r, sig_s, sig_pk, k_q))


def verify_batch(pubkeys: list[bytes], msgs: list[bytes], sigs: list[bytes], *, device) -> np.ndarray:
    """End-to-end ladder on `device`: one bool per lane."""
    args = prepare_batch(pubkeys, msgs, sigs, device)
    return straus_verify(*args).cpu().numpy()


def verify_batch_bound(
    pubkeys: list[bytes], msgs: list[bytes], sigs: list[bytes], max_len: int = 124, *, device
) -> np.ndarray:
    """End-to-end with full witness binding on `device` (messages
    zero-padded to max_len): one bool per lane."""
    args = prepare_batch(pubkeys, msgs, sigs, device)
    binding = prepare_binding(pubkeys, msgs, sigs, device)
    m = np.zeros((len(msgs), max_len), dtype=np.uint8)
    for i, msg in enumerate(msgs):
        m[i, : len(msg)] = np.frombuffer(msg, dtype=np.uint8)
    mlen = torch.tensor([len(msg) for msg in msgs], device=device)
    sig_r, sig_s, sig_pk, k_q = binding
    return verify_bound(
        *args, sig_r, sig_s, sig_pk, torch.from_numpy(m).to(device), mlen, k_q
    ).cpu().numpy()
