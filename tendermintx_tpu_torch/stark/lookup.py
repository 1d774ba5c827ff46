"""LogUp lookup argument: batched range checks over the aux commitment.

Counterpart of ``tendermintx_tpu/stark/lookup.py``. For a challenge gamma
sampled after the main trace commits,

    sum_cells 1/(gamma - v)  ==  sum_rows m(row)/(gamma - t(row))

holds iff every checked value appears in the table column t with the
committed multiplicities m. Inverse sums are auxiliary (phase-2) columns
in GF(p^2), BATCH checked values folded into one aux column:

    w * prod_i (gamma - v_i) = sum_j prod_{i != j} (gamma - v_i)   (degree BATCH + 1)
    wt * (gamma - t_j) = m_j                                       (degree 2)
    S = running sum of (sum_b w_b - sum_j wt_j); S(last) = 0

The table is [0, 2^bits), split column-major over `width` periodic columns
when the trace is shorter than the table.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.ext import GF2, W
from ..ops.goldilocks import GF, P, add

BATCH = 4  # checked values per aux column -> constraint degree BATCH + 1


def _epair_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _epair_sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _epair_mul(a, b, alg):
    # (a0 + a1 X)(b0 + b1 X) with X^2 = W
    return (
        a[0] * b[0] + alg.cmul(W, a[1] * b[1]),
        a[0] * b[1] + a[1] * b[0],
    )


@dataclass
class RangeLookup:
    """Range-check plumbing one AIR instance owns (see the reference)."""

    checked_cols: list[int]
    mult_base: int
    n_rows: int
    table_bits: int = 13
    aux_base: int = 0  # set by the AIR: absolute column index of aux[0]

    @property
    def table_size(self) -> int:
        return 1 << self.table_bits

    @property
    def width(self) -> int:
        return max(1, self.table_size // self.n_rows)

    @property
    def n_batches(self) -> int:
        return (len(self.checked_cols) + BATCH - 1) // BATCH

    @property
    def n_aux_ext(self) -> int:
        return self.n_batches + self.width + 1  # w's, wt's, S

    @property
    def n_aux_cols(self) -> int:
        return 2 * self.n_aux_ext

    # -- table ---------------------------------------------------------------

    def table_patterns(self) -> list[list[int]]:
        """Periodic table columns (length min(n_rows, table_size))."""
        span = min(self.n_rows, self.table_size)
        out = []
        for j in range(self.width):
            base = j * span
            if self.n_rows >= self.table_size:
                out.append([i % self.table_size for i in range(span)])
            else:
                out.append([base + i for i in range(span)])
        return out

    def _table_values(self) -> np.ndarray:
        """(width, n_rows) table values as the trace sees them."""
        out = np.zeros((self.width, self.n_rows), dtype=np.uint32)
        for j, pat in enumerate(self.table_patterns()):
            reps = self.n_rows // len(pat)
            out[j] = np.tile(np.asarray(pat, dtype=np.uint32), reps)
        return out

    def multiplicity_columns(self, checked_vals: np.ndarray) -> np.ndarray:
        """Count table hits: checked_vals (K, n_rows) uint; returns
        (width, n_rows) multiplicities for the main trace. Raises if any
        value is out of range."""
        vals = np.ascontiguousarray(checked_vals).ravel()
        if vals.size:
            if vals.dtype.kind != "u" and int(vals.min()) < 0:
                raise ValueError("range-check witness value out of table range")
            if int(vals.max()) >= self.table_size:
                raise ValueError("range-check witness value out of table range")
        counts = np.bincount(vals, minlength=self.table_size)
        out = np.zeros((self.width, self.n_rows), dtype=np.uint32)
        # each value's count goes at its FIRST table occurrence: value v sits
        # at (v // span, v % span) within the first `span` rows
        span = min(self.n_rows, self.table_size)
        out[:, :span] = counts[: self.width * span].reshape(self.width, span)
        return out

    # -- prover: aux columns (device) -----------------------------------------

    def build_aux(self, trace: GF, gamma: GF2) -> GF:
        """trace: (n_cols_main, n) on the device; gamma a (1,) GF2 scalar.
        Returns the (n_aux_cols, n) aux columns."""
        n = self.n_rows
        dev = trace.device
        idx = torch.tensor(self.checked_cols, device=dev)
        checked = trace.v.index_select(0, idx)
        K, nb = len(self.checked_cols), self.n_batches
        pad = nb * BATCH - K
        if pad:
            # pad cells get denominator (gamma - 0) but are removed from the
            # numerator (see _aux_w)
            checked = torch.cat([checked, torch.zeros((pad, n), dtype=torch.int64, device=dev)])
        checked = GF(checked.reshape(nb, BATCH, n))
        w = _aux_w(checked, gamma, pad)
        table = GF.from_small(self._table_values(), dev)  # (width, n)
        m_idx = torch.arange(self.mult_base, self.mult_base + self.width, device=dev)
        m = GF(trace.v.index_select(0, m_idx))
        wt = _aux_wt(table, m, gamma)
        S = _aux_scan(w, wt)
        return _aux_assemble(w, wt, S)

    # -- constraints -----------------------------------------------------------

    def _aux_pair(self, frame, offset_index: int, ext_idx: int):
        row = frame.rows[offset_index]
        base = self.aux_base + 2 * ext_idx
        return (row[base], row[base + 1])

    @property
    def _contiguous(self) -> bool:
        c = self.checked_cols
        return len(c) % BATCH == 0 and c == list(range(c[0], c[0] + len(c)))

    def eval_lookup(self, frame, alg, periodic_base: int):
        """(cyclic, first, transition, last) constraint pieces; the AIR
        extends its own groups with them. Contiguous checked columns that
        are a multiple of BATCH use stacked blocks."""
        if self._contiguous:
            return self._eval_lookup_stacked(frame, alg, periodic_base)
        return self._eval_lookup_scalar(frame, alg, periodic_base)

    def _eval_lookup_stacked(self, frame, alg, periodic_base: int):
        g0, g1 = frame.challenges[0], frame.challenges[1]
        K = len(self.checked_cols)
        nb = self.n_batches
        v = alg.col_range(frame, 0, self.checked_cols[0], K)  # (K, N)
        d = (alg.vcmul(P - 1, v) + g0, alg.vcmul(0, v) + g1)  # gamma - v, ext

        def evmul(a, b):
            return (
                a[0] * b[0] + alg.vcmul(W, a[1] * b[1]),
                a[0] * b[1] + a[1] * b[0],
            )

        def evadd(a, b):
            return (a[0] + b[0], a[1] + b[1])

        dk = [(d[0][k::BATCH], d[1][k::BATCH]) for k in range(BATCH)]
        p01 = evmul(dk[0], dk[1])
        p23 = evmul(dk[2], dk[3])
        total = evmul(p01, p23)
        numer = evadd(
            evmul(p23, evadd(dk[0], dk[1])), evmul(p01, evadd(dk[2], dk[3]))
        )
        wc = alg.col_range(frame, 0, self.aux_base, 2 * nb)
        w = (wc[0::2], wc[1::2])
        c = evmul(w, total)
        cyclic = [c[0] - numer[0], c[1] - numer[1]]  # two (nb, N) blocks
        cyclic.extend(self._table_constraints(frame, alg, periodic_base))
        first, transition, last = self._sum_constraints(frame, alg)
        return cyclic, first, transition, last

    def _table_constraints(self, frame, alg, periodic_base: int):
        from .air import DeviceAlgebra

        if isinstance(alg, DeviceAlgebra):
            return self._table_constraints_device(frame, alg, periodic_base)
        gamma = (frame.challenges[0], frame.challenges[1])
        zero_ = alg.const(0)
        out = []
        row0 = frame.rows[0]
        for j in range(self.width):
            t = frame.periodic[periodic_base + j]
            m = row0[self.mult_base + j]
            wt = self._aux_pair(frame, 0, self.n_batches + j)
            gm = (gamma[0] - t, gamma[1] - zero_)
            c = _epair_sub(_epair_mul(wt, gm, alg), (m, zero_))
            out.extend([c[0], c[1]])
        return out

    def _table_constraints_device(self, frame, alg, periodic_base: int):
        """Batched wt*(gamma - t) - m over all `width` table columns: ONE
        (2*width, N) block, rows interleaved (c0_j, c1_j) in j order (the
        host loop's flatten order)."""
        w, nb = self.width, self.n_batches
        g0, g1 = frame.challenges[0], frame.challenges[1]
        t = GF.stack(frame.periodic[periodic_base : periodic_base + w], axis=0)
        m = alg.col_range(frame, 0, self.mult_base, w)
        allc = alg.col_range(frame, 0, self.aux_base + 2 * nb, 2 * w)
        wt0, wt1 = allc[0::2], allc[1::2]
        g0b = GF(g0.v[None, :])
        g1b = GF(g1.v[None, :])
        gm0 = g0b - t
        c0 = wt0 * gm0 + (wt1 * g1b).cmul(W) - m
        c1 = wt0 * g1b + wt1 * gm0
        return [GF(torch.stack([c0.v, c1.v], dim=1).reshape(2 * w, -1))]

    def _sum_constraints(self, frame, alg):
        from .air import DeviceAlgebra

        if isinstance(alg, DeviceAlgebra):
            return self._sum_constraints_device(frame, alg)
        zero_ = alg.const(0)

        def diff_at(offset_index: int):
            d = (zero_, zero_)
            for b in range(self.n_batches):
                d = _epair_add(d, self._aux_pair(frame, offset_index, b))
            for j in range(self.width):
                d = _epair_sub(
                    d, self._aux_pair(frame, offset_index, self.n_batches + j)
                )
            return d

        S0 = self._aux_pair(frame, 0, self.n_batches + self.width)
        S1 = self._aux_pair(frame, 1, self.n_batches + self.width)
        first = list(_epair_sub(S0, diff_at(0)))
        transition = list(_epair_sub(_epair_sub(S1, S0), diff_at(1)))
        last = list(S0)
        return first, transition, last

    def _sum_constraints_device(self, frame, alg):
        """Batched running-sum constraints over strided column slices."""
        nb, w = self.n_batches, self.width

        def diff_at(offset_index: int):
            allc = alg.col_range(frame, offset_index, self.aux_base, 2 * (nb + w))
            ws, ts = allc[: 2 * nb], allc[2 * nb :]
            return (
                ws[0::2].sum(axis=0) - ts[0::2].sum(axis=0),
                ws[1::2].sum(axis=0) - ts[1::2].sum(axis=0),
            )

        S0 = self._aux_pair(frame, 0, nb + w)
        S1 = self._aux_pair(frame, 1, nb + w)
        first = list(_epair_sub(S0, diff_at(0)))
        transition = list(_epair_sub(_epair_sub(S1, S0), diff_at(1)))
        last = list(S0)
        return first, transition, last

    def _eval_lookup_scalar(self, frame, alg, periodic_base: int):
        gamma = (frame.challenges[0], frame.challenges[1])
        one = alg.const(1)
        zero_ = alg.const(0)

        def gm(v):  # gamma - v for base felt v
            return (gamma[0] - v, (gamma[1] - zero_))

        cyclic = []
        row0 = frame.rows[0]
        for b in range(self.n_batches):
            cols = self.checked_cols[b * BATCH : (b + 1) * BATCH]
            ds = [gm(row0[c]) for c in cols]
            k = len(ds)
            pre = [(one, zero_)] * (k + 1)
            for i in range(k):
                pre[i + 1] = _epair_mul(pre[i], ds[i], alg)
            suf = [(one, zero_)] * (k + 1)
            for i in range(k - 1, -1, -1):
                suf[i] = _epair_mul(suf[i + 1], ds[i], alg)
            total = pre[k]
            numer = (zero_, zero_)
            for j in range(k):
                numer = _epair_add(numer, _epair_mul(pre[j], suf[j + 1], alg))
            w = self._aux_pair(frame, 0, b)
            c = _epair_sub(_epair_mul(w, total, alg), numer)
            cyclic.extend([c[0], c[1]])
        for j in range(self.width):
            t = frame.periodic[periodic_base + j]
            m = row0[self.mult_base + j]
            wt = self._aux_pair(frame, 0, self.n_batches + j)
            c = _epair_sub(_epair_mul(wt, gm(t), alg), (m, zero_))
            cyclic.extend([c[0], c[1]])

        def diff_at(offset_index: int):
            d = (zero_, zero_)
            for b in range(self.n_batches):
                d = _epair_add(d, self._aux_pair(frame, offset_index, b))
            for j in range(self.width):
                d = _epair_sub(
                    d, self._aux_pair(frame, offset_index, self.n_batches + j)
                )
            return d

        S0 = self._aux_pair(frame, 0, self.n_batches + self.width)
        S1 = self._aux_pair(frame, 1, self.n_batches + self.width)
        first = list(_epair_sub(S0, diff_at(0)))
        transition = list(_epair_sub(_epair_sub(S1, S0), diff_at(1)))
        last = list(S0)
        return cyclic, first, transition, last


# -- aux columns (the reference's jitted _aux_* kernels, as torch ops) -------


def _gamma_minus(g: GF2, base_vals: GF) -> GF2:
    # (K, n) base -> ext (gamma - v)
    return GF2(g.c0.broadcast_to(base_vals.shape) - base_vals, g.c1.broadcast_to(base_vals.shape))


def _aux_w(checked: GF, g: GF2, pad: int) -> GF2:
    """checked: (nb, BATCH, n); w (nb, n) with w_b = sum_i 1/(gamma - v_i)
    via (sum_i prod_{j != i}) / prod_i: one inversion per batch."""
    nb = checked.shape[0]
    segs = [_gamma_minus(g, checked[:, k]) for k in range(BATCH)]
    if pad:
        # pad cells exist only in the LAST batch row: their d becomes 1 (no
        # effect on products) and their numerator terms are removed below
        last = torch.arange(nb, device=checked.device)[:, None] == nb - 1
        one = GF2.ones(segs[0].shape, checked.device)
        for k in range(BATCH - pad, BATCH):
            segs[k] = GF2.where(last, one, segs[k])
    d0, d1, d2, d3 = segs
    p01 = d0 * d1
    p23 = d2 * d3
    denom = p01 * p23
    numer = p23 * (d0 + d1) + p01 * (d2 + d3)
    if pad:
        # each pad cell contributed prod_{j != i} = denom to the last row
        mask = (torch.arange(nb, device=checked.device) == nb - 1).to(torch.int64)[:, None]
        sub = GF2(denom.c0.cmul(pad), denom.c1.cmul(pad))
        numer = numer - GF2(GF(sub.c0.v * mask), GF(sub.c1.v * mask))
    return numer * denom.inv()


def _aux_wt(table: GF, m: GF, g: GF2) -> GF2:
    """wt_j = m_j / (gamma - t_j): multiplicity-weighted table terms."""
    tdinv = _gamma_minus(g, table).inv()
    return GF2(tdinv.c0 * m, tdinv.c1 * m)


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive field prefix sum along the last axis (Hillis-Steele:
    log2(n) passes of shifted adds; exact, so equal to a sequential scan)."""
    n = x.shape[-1]
    shift = 1
    while shift < n:
        x = torch.cat([x[..., :shift], add(x[..., shift:], x[..., :-shift])], dim=-1)
        shift *= 2
    return x


def _aux_scan(w: GF2, wt: GF2) -> GF2:
    """Running sum S[i] = sum_{r <= i} (sum_b w_b[r] - sum_j wt_j[r])."""
    diff = GF2(w.c0.sum(axis=0), w.c1.sum(axis=0)) - GF2(
        wt.c0.sum(axis=0), wt.c1.sum(axis=0)
    )
    return GF2(GF(_prefix_sum(diff.c0.v)), GF(_prefix_sum(diff.c1.v)))


def _aux_assemble(w: GF2, wt: GF2, S: GF2) -> GF:
    def interleave(pair: GF2) -> torch.Tensor:
        # (k, n) ext -> (2k, n) base rows [c0_0, c1_0, c0_1, ...]
        k = pair.c0.shape[0]
        return torch.stack([pair.c0.v, pair.c1.v], dim=1).reshape(2 * k, -1)

    return GF(
        torch.cat([interleave(w), interleave(wt), torch.stack([S.c0.v, S.c1.v])], dim=0)
    )
