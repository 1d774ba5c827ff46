"""Converters between the JAX package's field layout and the port's.

The JAX package stores a Goldilocks array as a ``GF`` pair of uint32
arrays ``(lo, hi)``; the port stores each element's canonical uint64 bit
pattern in one int64 tensor. These functions cross that boundary with
numpy only, so tests can hand the same values to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.goldilocks import tensor_from_u64, tensor_to_u64


def felts_from_jax(lo: np.ndarray, hi: np.ndarray, device=None) -> torch.Tensor:
    """JAX (lo, hi) uint32 limb arrays -> int64 field tensor."""
    lo = np.asarray(lo, dtype=np.uint32).astype(np.uint64)
    hi = np.asarray(hi, dtype=np.uint32).astype(np.uint64)
    return tensor_from_u64(lo | (hi << np.uint64(32)), device)


def felts_to_jax(t: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 field tensor -> JAX (lo, hi) uint32 limb arrays."""
    u = tensor_to_u64(t)
    return (u & np.uint64(0xFFFFFFFF)).astype(np.uint32), (u >> np.uint64(32)).astype(
        np.uint32
    )


def felts_from_u64(x: np.ndarray, device=None) -> torch.Tensor:
    """Canonical uint64 array -> int64 field tensor (same bits)."""
    return tensor_from_u64(np.asarray(x, dtype=np.uint64), device)


def felts_to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 field tensor -> uint64 array (same bits)."""
    return tensor_to_u64(t).copy()
