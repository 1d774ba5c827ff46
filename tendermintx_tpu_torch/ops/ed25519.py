"""Host integer Edwards25519 arithmetic for the Ed25519 AIR.

The host-side part of ``tendermintx_tpu/ops/ed25519.py`` that
``stark/ed25519_air.py`` builds its traces and lane checks from: curve
constants, RFC 8032 point decompression, affine addition and negation,
and 13-bit limb packing. The reference's device ladder in 13-bit limbs is
not on the composite prover's path and is not ported.
"""

from __future__ import annotations

import numpy as np

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


def pt_add(p, q):
    (x1, y1), (x2, y2) = p, q
    x3 = (x1 * y2 + x2 * y1) * pow(1 + D_ED * x1 * x2 * y1 * y2, P25519 - 2, P25519)
    y3 = (y1 * y2 + x1 * x2) * pow(1 - D_ED * x1 * x2 * y1 * y2, P25519 - 2, P25519)
    return (x3 % P25519, y3 % P25519)


def pt_neg(p):
    x, y = p
    return ((-x) % P25519, y)


def int_to_limbs(x: int) -> np.ndarray:
    out = np.zeros(N_LIMBS, dtype=np.uint32)
    for i in range(N_LIMBS):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit 20 limbs of 13 bits")
    return out
