"""Number-theoretic transform and low-degree extension over Goldilocks.

Counterpart of ``tendermintx_tpu/ops/ntt.py``: radix-2 iterative
Cooley-Tukey on the LAST axis (leading axes are batch, e.g. trace columns),
twiddles precomputed on the host, butterflies as field ops on tensors.
"""

from __future__ import annotations

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


# ---------------------------------------------------------------------------
# Device transforms
# ---------------------------------------------------------------------------


def _transform(x: GF, inverse: bool) -> GF:
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
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


def ntt(x: GF) -> GF:
    """Forward NTT on the last axis: coefficients -> evaluations
    [p(w^0), ..., p(w^(n-1))] in natural order."""
    return _transform(x, inverse=False)


def intt(x: GF) -> GF:
    """Inverse NTT on the last axis: evaluations -> coefficients."""
    n = x.shape[-1]
    out = _transform(x, inverse=True)
    if n == 1:
        return out
    return out.cmul(pow(n, P - 2, P))


def coset_lde(coeffs: GF, rate_bits: int, shift: int = MULTIPLICATIVE_GENERATOR) -> GF:
    """Coefficients (deg < n on the last axis) -> evaluations on the coset
    shift * <w_N>, N = n * 2^rate_bits, natural order."""
    n = coeffs.shape[-1]
    N = n << rate_bits
    scaled = coeffs * _gf_const(power_table(shift, n), coeffs.device)
    pad = GF.zeros(tuple(coeffs.shape[:-1]) + (N - n,), coeffs.device)
    return ntt(GF.concatenate([scaled, pad], axis=-1))


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
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc
