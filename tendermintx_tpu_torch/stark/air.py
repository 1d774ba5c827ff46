"""AIR (algebraic intermediate representation) abstraction.

Counterpart of ``tendermintx_tpu/stark/air.py``. An AIR is one Python
constraint program evaluated both

  * on the device over whole LDE-domain row vectors (``DeviceAlgebra``:
    base-field ``GF`` tensors, vectorised over all rows), and
  * on the host at one out-of-domain point (``HostAlgebra``: extension
    field Python ints),

so the prover and the verifier share one source of truth for the
constraints. Constraint groups: transition (all rows but the last), first
(row 0), last (row n-1) and cyclic (every row, references wrap).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.ext import ext_add, ext_mul, ext_sub
from ..ops.goldilocks import GF, P, field_sum, mul, tensor_from_u64


class HostFelt:
    """Extension-field element with operator overloading (host evaluation)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = (v[0] % P, v[1] % P)

    def __add__(self, o):
        return HostFelt(ext_add(self.v, o.v))

    def __sub__(self, o):
        return HostFelt(ext_sub(self.v, o.v))

    def __mul__(self, o):
        return HostFelt(ext_mul(self.v, o.v))

    def __neg__(self):
        return HostFelt((-self.v[0] % P, -self.v[1] % P))


class HostVec:
    """Vector of HostFelts with elementwise operators."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = list(items)

    def _zip(self, o, op):
        if isinstance(o, HostVec):
            return HostVec([op(a, b) for a, b in zip(self.items, o.items)])
        return HostVec([op(a, o) for a in self.items])

    def __add__(self, o):
        return self._zip(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._zip(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._zip(o, lambda a, b: a * b)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return HostVec(self.items[i])
        return self.items[i]


class HostAlgebra:
    felt = HostFelt

    @staticmethod
    def const(c: int):
        return HostFelt((c % P, 0))

    @staticmethod
    def cmul(c: int, x):
        return HostFelt(ext_mul((c % P, 0), x.v))

    # -- vector helpers (k-lane stacks of felts) --

    @staticmethod
    def stack(felts):
        return HostVec(felts)

    @staticmethod
    def rot(vec, r: int):
        k = len(vec)
        return HostVec([vec[(i + r) % k] for i in range(k)])

    @staticmethod
    def shift_down(vec, r: int):
        k = len(vec)
        zero = HostFelt((0, 0))
        return HostVec([vec[i + r] if i + r < k else zero for i in range(k)])

    @staticmethod
    def weighted_sum(vec, weights):
        acc = HostFelt((0, 0))
        for w, x in zip(weights, vec.items):
            acc = acc + HostAlgebra.cmul(w, x)
        return acc

    @staticmethod
    def vcmul(c: int, vec):
        return HostVec([HostAlgebra.cmul(c, x) for x in vec.items])

    @staticmethod
    def unstack(vec):
        return list(vec.items)

    @staticmethod
    def vconst_bits(bits):
        return HostVec([HostFelt((int(b) % P, 0)) for b in bits])

    @staticmethod
    def vconst(vals):
        return HostVec([HostFelt((int(v) % P, 0)) for v in vals])

    @staticmethod
    def col_range(frame, offset_index: int, start: int, count: int):
        return HostVec(frame.rows[offset_index][start : start + count])

    @staticmethod
    def vconcat(vecs):
        items = []
        for v in vecs:
            items.extend(v.items)
        return HostVec(items)

    @staticmethod
    def stack_len(vec) -> int:
        return len(vec)

    @staticmethod
    def pad_stack(vec, out_len: int):
        zero = HostFelt((0, 0))
        items = list(vec.items) + [zero] * (out_len - len(vec))
        return HostVec(items[:out_len])

    @staticmethod
    def shift_up(vec, r: int, out_len: int):
        zero = HostFelt((0, 0))
        items = [zero] * r + list(vec.items)
        items = items + [zero] * (out_len - len(items))
        return HostVec(items[:out_len])


def _const_column(vals, device) -> torch.Tensor:
    """(k, 1) int64 tensor of field constants (broadcasts over rows)."""
    u = np.array([int(v) % P for v in vals], dtype=np.uint64)
    return tensor_from_u64(u, device)[:, None]


class DeviceAlgebra:
    """Constraint evaluation over base-field row vectors (shape (N,)) on
    one torch device: the counterpart of the reference's DeviceAlgebra.
    Vector stacks are leading tensor axes, so 32-bit-wide bit operations
    are single tensor ops instead of 32 scalar ones."""

    def __init__(self, n_rows: int, device):
        self.n_rows = n_rows
        self.device = torch.device(device)

    def const(self, c: int):
        return GF.full((self.n_rows,), c, self.device)

    @staticmethod
    def cmul(c: int, x: GF):
        return x.cmul(c)

    @staticmethod
    def stack(felts):
        return GF.stack(felts, axis=0)  # (k, N)

    @staticmethod
    def rot(vec: GF, r: int):
        return GF(torch.roll(vec.v, -r, dims=0))

    @staticmethod
    def shift_down(vec: GF, r: int):
        if r == 0:
            return vec
        pad = torch.zeros((r,) + tuple(vec.v.shape[1:]), dtype=vec.v.dtype, device=vec.v.device)
        return GF(torch.cat([vec.v[r:], pad], dim=0))

    @staticmethod
    def weighted_sum(vec: GF, weights):
        w = _const_column(weights, vec.v.device)
        w = w.reshape((-1,) + (1,) * (vec.v.ndim - 1))
        return GF(field_sum(mul(vec.v, w), 0))

    @staticmethod
    def vcmul(c: int, vec: GF):
        return vec.cmul(c)

    @staticmethod
    def unstack(vec: GF):
        return [GF(vec.v[i]) for i in range(vec.v.shape[0])]

    def vconst_bits(self, bits):
        """Constant bit vector as a (k, 1) broadcastable tensor."""
        return GF(_const_column([int(b) & 0xFFFFFFFF for b in bits], self.device))

    def vconst(self, vals):
        """Arbitrary constant stack as a (k, 1) broadcastable tensor."""
        return GF(_const_column(vals, self.device))

    @staticmethod
    def stack_len(vec) -> int:
        return vec.v.shape[0]

    @staticmethod
    def pad_stack(vec, out_len: int):
        k = vec.v.shape[0]
        if k == out_len:
            return vec
        pad = torch.zeros((out_len - k,) + tuple(vec.v.shape[1:]), dtype=vec.v.dtype, device=vec.v.device)
        return GF(torch.cat([vec.v, pad], dim=0))

    @staticmethod
    def shift_up(vec, r: int, out_len: int):
        k = vec.v.shape[0]
        keep = min(k, out_len - r)
        rest = tuple(vec.v.shape[1:])
        z = lambda m: torch.zeros((m,) + rest, dtype=vec.v.dtype, device=vec.v.device)
        return GF(torch.cat([z(r), vec.v[:keep], z(out_len - r - keep)], dim=0))

    @staticmethod
    def col_range(frame, offset_index: int, start: int, count: int):
        return GF(frame.rows_stacked.v[offset_index, start : start + count])

    @staticmethod
    def vconcat(vecs):
        return GF.concatenate(vecs, axis=0)


@dataclass
class Frame:
    """One evaluation frame: trace column values at each declared row offset
    (`rows[k][i]` = column i at offset `air.frame_offsets[k]`), public
    inputs, periodic-column values, all lifted to the algebra."""

    rows: list
    public: list
    periodic: list
    # offset-0 values of public columns (verifier-reconstructible full-length
    # columns derived from the public inputs; not committed)
    public_cols: list = None
    # device only: pre-stacked (n_offsets, n_cols, N) trace values
    rows_stacked: object = None
    # extension challenges sampled between the main and aux commitments, as
    # 2*n_challenges base-field scalars (c0, c1 of each)
    challenges: list = None

    @property
    def local(self):
        return self.rows[0]

    @property
    def next(self):
        return self.rows[1]

    def at_offset(self, offset: int, air: "Air"):
        return self.rows[air.frame_offsets.index(offset)]


def constraint_count(c) -> int:
    """Constraints may be single felts/(N,)-vectors or stacked blocks
    (HostVec / (K, N) GF); each block row is one constraint."""
    if isinstance(c, HostVec):
        return len(c)
    if isinstance(c, HostFelt):
        return 1
    return c.v.shape[0] if c.v.ndim == 2 else 1


def flatten_host_constraints(constraints) -> list:
    """HostFelt list with blocks expanded, in order."""
    out = []
    for c in constraints:
        if isinstance(c, HostVec):
            out.extend(c.items)
        else:
            out.append(c)
    return out


def public_columns_u64(cols, n: int) -> np.ndarray:
    """An AIR's public columns as one (len(cols), n) uint64 array, every
    value reduced mod p: uint64 arrays in one vectorised step (a uint64 is
    below 2p), other columns value by value."""
    arr = np.zeros((len(cols), n), dtype=np.uint64)
    for i, col in enumerate(cols):
        if len(col) != n:
            raise ValueError("public column length differs from the trace")
        if isinstance(col, np.ndarray) and col.dtype == np.uint64:
            arr[i] = np.where(col >= np.uint64(P), col - np.uint64(P), col)
        else:
            arr[i] = [int(v) % P for v in col]
    return arr


class Air:
    """Subclass and override. See the reference's Air for the contract:
    `n_cols`, `n_public`, `n_public_cols`, `constraint_degree`,
    `frame_offsets`, `n_aux_cols`/`n_challenges` for two-phase AIRs, and the
    eval_* constraint groups."""

    n_cols: int = 0
    n_public: int = 0
    n_public_cols: int = 0
    constraint_degree: int = 3
    frame_offsets: list[int] = [0, 1]
    n_aux_cols: int = 0
    n_challenges: int = 0

    def periodic_columns(self) -> list[list[int]]:
        return []

    def validate_publics(self, publics) -> bool:
        """Structural validity of (untrusted) public inputs; must be total."""
        return len(publics) == self.n_public

    def aux_columns(self, trace, challenges, publics):
        """Phase-2 witness: (n_aux_cols, n) GF from the main trace and the
        sampled challenges."""
        raise NotImplementedError

    def public_columns(self, publics: list[int], n_rows: int) -> list[list[int]]:
        return []

    def eval_transition(self, frame: Frame, alg) -> list:
        return []

    def eval_cyclic(self, frame: Frame, alg) -> list:
        return []

    def eval_first(self, frame: Frame, alg) -> list:
        return []

    def eval_last(self, frame: Frame, alg) -> list:
        return []

    @property
    def n_constraints(self) -> int:
        # evaluate symbolically on the host with zeros to count constraints
        zero = HostFelt((0, 0))
        total = self.n_cols + self.n_aux_cols
        frame = Frame(
            rows=[[zero] * total for _ in self.frame_offsets],
            public=[zero] * self.n_public,
            periodic=[zero] * len(self.periodic_columns()),
            public_cols=[zero] * self.n_public_cols,
            challenges=[zero] * (2 * self.n_challenges),
        )
        alg = HostAlgebra()
        return sum(
            constraint_count(c)
            for group in (
                self.eval_first(frame, alg),
                self.eval_transition(frame, alg),
                self.eval_cyclic(frame, alg),
                self.eval_last(frame, alg),
            )
            for c in group
        )
