"""Goldilocks field (p = 2**64 - 2**32 + 1) arithmetic on torch tensors.

Counterpart of ``tendermintx_tpu/ops/goldilocks.py``. A field element is
stored as the bit pattern of its canonical uint64 value in an ``int64``
tensor (torch's unsigned 64-bit type lacks ``+``, ``>>`` and ``<`` on the
CPU). Four rules keep the signed storage honest:

  * ``>>`` is arithmetic, so every right shift is masked afterwards;
  * unsigned compares flip the sign bit first: ``(a ^ MIN) < (b ^ MIN)``;
  * ``%`` / ``torch.remainder`` never touch a bit pattern >= 2**63;
  * Python ints >= 2**63 enter through ``np.uint64 -> view(int64)``.

Field operations are int64 torch ops and run on any device. Products of
32-bit halves wrap in int64 with the right low 64 bits; the reduction
mirrors the reference's ``reduce128`` (2**64 = 2**32 - 1, 2**96 = -1 mod
p). Eager torch spends ~45 full-tensor passes on one multiply; a fused
elementwise kernel is later work (ROADMAP queue 2).
"""

from __future__ import annotations

import numpy as np
import torch

P = 0xFFFFFFFF00000001  # 2**64 - 2**32 + 1
EPSILON = 0xFFFFFFFF  # 2**32 - 1 == 2**64 mod p
MULTIPLICATIVE_GENERATOR = 7
TWO_ADICITY = 32

_I64 = torch.int64
_M32 = 0xFFFFFFFF
_MIN = -(1 << 63)  # sign bit as an int64 value
_P_S = P - (1 << 64)  # p's bit pattern read as int64
_P_FLIP = _P_S ^ _MIN  # p with the sign bit flipped, for unsigned compares


# ---------------------------------------------------------------------------
# Host conversions (numpy / Python ints <-> int64 bit patterns)
# ---------------------------------------------------------------------------


def to_u64_array(x) -> np.ndarray:
    """Python ints / object array / integer numpy array -> canonical uint64."""
    arr = np.asarray(x)
    if arr.dtype == np.uint64:
        out = arr.copy()
        big = out >= np.uint64(P)
        out[big] -= np.uint64(P)
        return out
    if arr.dtype.kind in "ui" and arr.dtype.itemsize <= 4:
        return arr.astype(np.int64).astype(np.uint64) % np.uint64(P)
    flat = [int(v) % P for v in np.asarray(x, dtype=object).reshape(-1).tolist()]
    return np.array(flat, dtype=np.uint64).reshape(arr.shape)


def tensor_from_u64(u64: np.ndarray, device=None) -> torch.Tensor:
    """uint64 numpy array (canonical) -> int64 tensor of the same bits."""
    u64 = np.asarray(u64, dtype=np.uint64)
    if not u64.flags.c_contiguous:
        u64 = u64.copy()
    t = torch.from_numpy(u64.view(np.int64))
    return t.to(device) if device is not None else t.clone()


def tensor_to_u64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").contiguous().numpy().view(np.uint64)


def to_int_array(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> object array of Python ints (canonical values)."""
    return tensor_to_u64(t).astype(object)


def scalar_tensor(c: int, device=None) -> torch.Tensor:
    """0-d int64 tensor holding the field constant c."""
    return tensor_from_u64(np.array(c % P, dtype=np.uint64), device)


# ---------------------------------------------------------------------------
# Field operations (int64 torch ops, any device)
# ---------------------------------------------------------------------------


def _canon(v: torch.Tensor) -> torch.Tensor:
    """Subtract p once where v >= p (v any 64-bit pattern); in place."""
    # v - p == v + (2**32 - 1) mod 2**64
    return v.add_(((v ^ _MIN) >= _P_FLIP).to(_I64).mul_(EPSILON))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    # carry: the true sum is s + 2**64 = s + (2**32 - 1) mod p, which
    # cannot wrap again
    s.add_(((s ^ _MIN) < (a ^ _MIN)).to(_I64).mul_(EPSILON))
    return _canon(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    # borrow: d wrapped by 2**64 = (2**32 - 1) mod p; a - b + p is canonical
    return d.sub_(((a ^ _MIN) < (b ^ _MIN)).to(_I64).mul_(EPSILON))


def neg(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, _P_S - a)


def reduce_limbs(r0, r1, r2, r3) -> torch.Tensor:
    """Reduce r0 + r1*2^32 + r2*2^64 + r3*2^96 mod p, canonical output.

    The limbs are non-negative int64 values below 6 * 2**32 (unnormalised
    32-bit limbs) and are consumed (updated in place). 2**64 = 2**32 - 1
    and 2**96 = -1 give x = (r0 - r2 - r3) + (r1 + r2) * 2**32 (mod p)."""
    low = r0.sub_(r2).sub_(r3)
    high = r1.add_(r2)
    # bits of `high` above 32: h1 * 2**64 = h1 * (2**32 - 1)
    low.add_((high >> 32).mul_(EPSILON))
    high.bitwise_and_(_M32)
    high.add_(low >> 32)  # floor shift carries a negative low too
    low.bitwise_and_(_M32)
    k = high >> 32  # -1, 0 or 1 multiples of 2**64 beyond the bit pattern
    v = low.bitwise_or_(high.bitwise_and_(_M32).bitwise_left_shift_(32))
    v.add_(k.mul_(EPSILON))
    return _canon(v)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Products of 32-bit halves (each < 2**64, wrapping in int64 with the
    right bits) split into four unnormalised 32-bit limbs, then reduced."""
    a0 = a & _M32
    a1 = (a >> 32).bitwise_and_(_M32)
    b0 = b & _M32
    b1 = (b >> 32).bitwise_and_(_M32)
    p00 = a0 * b0
    p10 = a1 * b0
    p01 = a0 * b1
    p11 = a1 * b1
    r1 = (p00 >> 32).bitwise_and_(_M32)
    r1.add_(p01 & _M32).add_(p10 & _M32)
    r0 = p00.bitwise_and_(_M32)
    r2 = p01.bitwise_right_shift_(32).bitwise_and_(_M32)
    r2.add_(p10.bitwise_right_shift_(32).bitwise_and_(_M32))
    r3 = (p11 >> 32).bitwise_and_(_M32)
    r2.add_(p11.bitwise_and_(_M32))
    return reduce_limbs(r0, r1, r2, r3)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a**e for a fixed Python-int exponent (square and multiply)."""
    if e == 0:
        return torch.ones_like(a)
    bits = bin(e)[2:]
    r = a
    for bit in bits[1:]:
        r = mul(r, r)
        if bit == "1":
            r = mul(r, a)
    return r


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a**(p-2); inv(0) = 0 by convention."""
    return pow_const(a, P - 2)


def field_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Field sum along `dim` as a pairwise tree of adds (exact, so the
    order differs from the reference's sequential loop without changing
    the result)."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=_I64, device=x.device)
    while x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        s = add(x[:half], x[half : 2 * half])
        x = torch.cat([s, x[2 * half :]]) if n % 2 else s
    return x[0]


# ---------------------------------------------------------------------------
# GF: thin wrapper over an int64 tensor
# ---------------------------------------------------------------------------


class GF:
    """Array of Goldilocks elements (canonical uint64 bits in int64)."""

    __slots__ = ("v",)

    def __init__(self, v: torch.Tensor):
        self.v = v

    # -- constructors --
    @classmethod
    def from_ints(cls, x, device=None):
        return cls(tensor_from_u64(to_u64_array(x), device))

    @classmethod
    def from_u64(cls, x: np.ndarray, device=None):
        """Canonical uint64 numpy array -> GF (no reduction pass)."""
        return cls(tensor_from_u64(x, device))

    @classmethod
    def from_small(cls, x: np.ndarray, device=None):
        """Non-negative integer numpy array with values < p (e.g. uint32
        trace cells) -> GF."""
        t = torch.from_numpy(np.ascontiguousarray(x).astype(np.int64, copy=False))
        return cls(t.to(device) if device is not None else t.clone())

    @classmethod
    def zeros(cls, shape, device=None):
        return cls(torch.zeros(shape, dtype=_I64, device=device))

    @classmethod
    def ones(cls, shape, device=None):
        return cls(torch.ones(shape, dtype=_I64, device=device))

    @classmethod
    def full(cls, shape, c: int, device=None):
        return cls(scalar_tensor(c, device).expand(shape).clone())

    # -- introspection --
    @property
    def shape(self):
        return tuple(self.v.shape)

    @property
    def ndim(self):
        return self.v.ndim

    @property
    def device(self):
        return self.v.device

    def to(self, device):
        return GF(self.v.to(device))

    def to_ints(self):
        return to_int_array(self.v)

    # -- arithmetic --
    def __add__(self, other):
        return GF(add(self.v, other.v))

    def __sub__(self, other):
        return GF(sub(self.v, other.v))

    def __mul__(self, other):
        return GF(mul(self.v, other.v))

    def __neg__(self):
        return GF(neg(self.v))

    def square(self):
        return GF(mul(self.v, self.v))

    def inv(self):
        return GF(inv(self.v))

    def pow(self, e: int):
        return GF(pow_const(self.v, e))

    def mul_small(self, c: int):
        return self.cmul(c)

    def cmul(self, c: int):
        """Multiply by a Python-int constant."""
        c = c % P
        if c == 0:
            return GF(torch.zeros_like(self.v))
        if c == 1:
            return self
        return GF(mul(self.v, scalar_tensor(c, self.v.device)))

    def equal(self, other):
        return self.v == other.v

    def is_zero(self):
        return self.v == 0

    # -- structural ops --
    def __getitem__(self, idx):
        return GF(self.v[idx])

    def reshape(self, *shape):
        return GF(self.v.reshape(*shape))

    def broadcast_to(self, shape):
        return GF(self.v.expand(shape))

    @classmethod
    def concatenate(cls, parts, axis=0):
        return cls(torch.cat([p.v for p in parts], dim=axis))

    @classmethod
    def stack(cls, parts, axis=0):
        return cls(torch.stack([p.v for p in parts], dim=axis))

    @classmethod
    def where(cls, cond, a, b):
        return cls(torch.where(cond, a.v, b.v))

    def sum(self, axis=None):
        if axis is None:
            return GF(field_sum(self.v.reshape(-1), 0))
        return GF(field_sum(self.v, axis))

    def __repr__(self):
        return f"GF(shape={self.shape}, device={self.device})"
