"""Quadratic extension GF(p^2) = GF(p)[X] / (X^2 - 7) over Goldilocks.

Counterpart of ``tendermintx_tpu/ops/ext.py``: elements are pairs (c0, c1)
of base-field ``GF`` arrays representing c0 + c1*X, plus the Python-int
host arithmetic the verifier and challenger use.
"""

from __future__ import annotations

from .goldilocks import GF, P

W = 7  # non-residue defining the extension


class GF2:
    """Array of GF(p^2) elements as a pair of base-field arrays."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: GF, c1: GF):
        self.c0 = c0
        self.c1 = c1

    # -- constructors --
    @classmethod
    def from_base(cls, x: GF):
        return cls(x, GF.zeros(x.shape, x.device))

    @classmethod
    def from_ints(cls, c0, c1, device=None):
        return cls(GF.from_ints(c0, device), GF.from_ints(c1, device))

    @classmethod
    def zeros(cls, shape, device=None):
        return cls(GF.zeros(shape, device), GF.zeros(shape, device))

    @classmethod
    def ones(cls, shape, device=None):
        return cls(GF.ones(shape, device), GF.zeros(shape, device))

    @property
    def shape(self):
        return self.c0.shape

    @property
    def device(self):
        return self.c0.device

    def to_ints(self):
        return self.c0.to_ints(), self.c1.to_ints()

    # -- arithmetic --
    def __add__(self, o):
        return GF2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return GF2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return GF2(-self.c0, -self.c1)

    def __mul__(self, o):
        # (a0 + a1 X)(b0 + b1 X) = a0 b0 + W a1 b1 + (a0 b1 + a1 b0) X
        a0b0 = self.c0 * o.c0
        a1b1 = self.c1 * o.c1
        a0b1 = self.c0 * o.c1
        a1b0 = self.c1 * o.c0
        return GF2(a0b0 + a1b1.mul_small(W), a0b1 + a1b0)

    def scale(self, s: GF):
        return GF2(self.c0 * s, self.c1 * s)

    def square(self):
        return self * self

    def inv(self):
        # 1/(a0 + a1 X) = (a0 - a1 X) / (a0^2 - W a1^2)
        norm = self.c0.square() - self.c1.square().mul_small(W)
        ninv = norm.inv()
        return GF2(self.c0 * ninv, -(self.c1 * ninv))

    def pow(self, e: int):
        if e == 0:
            return GF2.ones(self.shape, self.device)
        r = self
        for bit in bin(e)[3:]:
            r = r.square()
            if bit == "1":
                r = r * self
        return r

    @classmethod
    def where(cls, cond, a, b):
        return cls(GF.where(cond, a.c0, b.c0), GF.where(cond, a.c1, b.c1))

    def equal(self, o):
        return self.c0.equal(o.c0) & self.c1.equal(o.c1)

    def __getitem__(self, idx):
        return GF2(self.c0[idx], self.c1[idx])

    def reshape(self, *shape):
        return GF2(self.c0.reshape(*shape), self.c1.reshape(*shape))

    def broadcast_to(self, shape):
        return GF2(self.c0.broadcast_to(shape), self.c1.broadcast_to(shape))

    def sum(self, axis=None):
        return GF2(self.c0.sum(axis), self.c1.sum(axis))

    @classmethod
    def stack(cls, parts, axis=0):
        return cls(
            GF.stack([p.c0 for p in parts], axis),
            GF.stack([p.c1 for p in parts], axis),
        )

    @classmethod
    def concatenate(cls, parts, axis=0):
        return cls(
            GF.concatenate([p.c0 for p in parts], axis),
            GF.concatenate([p.c1 for p in parts], axis),
        )

    def __repr__(self):
        return f"GF2(shape={self.shape}, device={self.device})"


# Host-side (Python int) arithmetic for GF(p^2): verifier and challenger.


def ext_mul(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 + W * a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def ext_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def ext_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def ext_inv(a):
    norm = (a[0] * a[0] - W * a[1] * a[1]) % P
    ninv = pow(norm, P - 2, P)
    return ((a[0] * ninv) % P, (-a[1] * ninv) % P)


def ext_pow(a, e: int):
    r = (1, 0)
    base = a
    while e:
        if e & 1:
            r = ext_mul(r, base)
        base = ext_mul(base, base)
        e >>= 1
    return r
