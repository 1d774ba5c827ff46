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

import ctypes
from dataclasses import dataclass
from functools import cache

import numpy as np
import torch

from ..ops.ext import GF2, W
from ..ops.goldilocks import GF, P, add, field_sum

BATCH = 4  # checked values per aux column -> constraint degree BATCH + 1

# incremented exactly where each csrc/logup.cu entry is launched, by the
# CUDA kernels it launches (tmx_logup_scan: its tile-sum and scan kernels, 2)
logup_terms_kernel_launches = 0
logup_scan_kernel_launches = 0
# csrc/logup.cu's terms grid: rows by groups of terms, the groups cut until
# about _LOGUP_BLOCKS blocks of _LOGUP_THREADS rows fill the card; a group
# is a multiple of _LOGUP_TERMS, the terms a thread divides by their norms
# together
_LOGUP_THREADS = 128
_LOGUP_BLOCKS = 2048
_LOGUP_TERMS = 8
# csrc/logup.cu's scan: tiles of a multiple of _SCAN_THREADS rows (the
# rows a chunk, one a thread), about _SCAN_TILES of them (one wave)
_SCAN_THREADS = 256
_SCAN_TILES = 128


def scan_tiles(n: int) -> tuple[int, int]:
    """(rows a tile, tiles) of csrc/logup.cu's scan over n rows: whole
    chunks of _SCAN_THREADS rows, as few a tile as keep the tiles at most
    _SCAN_TILES."""
    chunks = max(1, -(-n // (_SCAN_THREADS * _SCAN_TILES)))
    tile = chunks * _SCAN_THREADS
    return tile, -(-n // tile)


@cache
def _checked_index(cols: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The checked columns' indices on `device`, uploaded once: a fresh
    upload a launch is a blocking copy that waits for the stream's work."""
    return torch.tensor(cols, dtype=torch.int64, device=device)


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

    @property
    def _span(self) -> int:
        """Table rows before the values repeat: t_j[r] = j span + r % span."""
        return min(self.n_rows, self.table_size)

    def table_patterns(self) -> list[list[int]]:
        """Periodic table columns (length min(n_rows, table_size))."""
        span = self._span
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
        span = self._span
        out[:, :span] = counts[: self.width * span].reshape(self.width, span)
        return out

    # -- prover: aux columns (device) -----------------------------------------

    def build_aux(self, trace: GF, gamma: GF2) -> GF:
        """trace: (n_cols_main, n) on the device; gamma a (1,) GF2 scalar.
        Returns the (n_aux_cols, n) aux columns: torch ops for a CPU trace,
        the csrc/logup.cu kernels (logup_terms, then logup_scan) for a CUDA
        one."""
        t = trace.device.type
        if t == "cpu":
            return self.build_aux_plain(trace, gamma)
        if t == "cuda":
            return self.build_aux_cuda(trace, gamma)
        raise ValueError(f"no LogUp aux columns for device {trace.device}")

    def build_aux_plain(self, trace: GF, gamma: GF2) -> GF:
        """The aux columns as int64 torch ops (any device)."""
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

    # -- prover: aux columns (csrc/logup.cu) -----------------------------------

    def logup_groups(self) -> tuple[int, int]:
        """(terms a thread sums, groups) of the terms kernel's grid: groups
        of a multiple of _LOGUP_TERMS terms, the last one shorter."""
        terms = self.n_batches + self.width
        runs = -(-terms // _LOGUP_TERMS)
        row_blocks = -(-self.n_rows // _LOGUP_THREADS)
        n_groups = min(runs, max(1, -(-_LOGUP_BLOCKS // row_blocks)))
        group = -(-runs // n_groups) * _LOGUP_TERMS
        return group, -(-terms // group)

    def scan_tiles(self) -> tuple[int, int]:
        """(rows a tile, tiles) of the scan over this lookup's rows."""
        return scan_tiles(self.n_rows)

    def build_aux_cuda(self, trace: GF, gamma: GF2) -> GF:
        """logup_terms writes every w_b and wt_j into its rows of the aux
        output and each group's signed sum a row into a scratch;
        logup_scan adds the groups and scans them into S, the last two rows."""
        out = torch.empty((self.n_aux_cols, self.n_rows), dtype=torch.int64, device=trace.device)
        partial = self.logup_terms_cuda(trace, gamma, out)
        self.logup_scan_cuda(partial, out)
        return GF(out)

    def _logup_args(self, out: torch.Tensor, partial: torch.Tensor, trace: GF | None = None,
                    gamma: GF2 | None = None, checked: torch.Tensor | None = None,
                    tile_sums: torch.Tensor | None = None) -> "_LogupArgs":
        """The kernels' arguments; the scan reads no trace, gamma or column
        index, the terms no tile sums (None: null pointers)."""
        group, n_groups = self.logup_groups()
        tile, n_tiles = self.scan_tiles()
        ptr = lambda t: t.data_ptr() if t is not None else None
        return _LogupArgs(
            trace=ptr(trace.v if trace is not None else None),
            trace_ld=int(trace.v.stride(0)) if trace is not None else 0,
            checked=ptr(checked), n_checked=len(self.checked_cols), n_batches=self.n_batches,
            mult_base=self.mult_base, width=self.width, span=self._span,
            gamma0=ptr(gamma.c0.v if gamma is not None else None),
            gamma1=ptr(gamma.c1.v if gamma is not None else None),
            n=self.n_rows, group=group, n_groups=n_groups, out=out.data_ptr(), partial=partial.data_ptr(),
            tile=tile, n_tiles=n_tiles, tile_sums=ptr(tile_sums),
        )

    def _check_cuda(self, trace: GF, gamma: GF2, out: torch.Tensor):
        dev = trace.device
        if dev.type != "cuda":
            raise TypeError(f"the LogUp kernels take a CUDA trace, got {dev}")
        n_cols = max([*self.checked_cols, self.mult_base + self.width - 1]) + 1
        v = trace.v
        if v.dtype != torch.int64 or v.dim() != 2 or int(v.shape[1]) != self.n_rows or int(v.shape[0]) < n_cols:
            raise ValueError(f"logup: the trace is {v.dtype} {tuple(v.shape)}; int64 (>= {n_cols}, "
                             f"{self.n_rows}) wanted")
        if self.n_rows > 1 and v.stride(1) != 1:
            raise ValueError("logup: the trace must have unit stride along its rows")
        for what, t in (("gamma c0", gamma.c0.v), ("gamma c1", gamma.c1.v)):
            if t.device != dev or t.dtype != torch.int64 or t.numel() != 1:
                raise TypeError(f"logup: {what} must be one int64 word on {dev}")
        if (out.device != dev or out.dtype != torch.int64 or not out.is_contiguous()
                or tuple(out.shape) != (self.n_aux_cols, self.n_rows)):
            raise ValueError(f"logup: the output must be a contiguous int64 ({self.n_aux_cols}, {self.n_rows}) "
                             f"tensor on {dev}")

    def logup_terms_cuda(self, trace: GF, gamma: GF2, out: torch.Tensor) -> torch.Tensor:
        """One launch: the w and wt rows of `out`; returns the (2, groups, n)
        signed sums of each group of terms a row (w added, wt taken away)."""
        global logup_terms_kernel_launches
        self._check_cuda(trace, gamma, out)
        dev = trace.device
        checked = _checked_index(tuple(self.checked_cols), dev)
        partial = torch.empty((2, self.logup_groups()[1], self.n_rows), dtype=torch.int64, device=dev)
        _logup_launch("tmx_logup_terms", self._logup_args(out, partial, trace, gamma, checked), dev)
        logup_terms_kernel_launches += 1
        return partial

    def logup_scan_cuda(self, partial: torch.Tensor, out: torch.Tensor):
        """S into the last two rows of `out` from the groups' sums (the
        other rows are not read): two kernels over the tiles of
        scan_tiles, their sums into a (2, tiles) scratch, then each tile
        scanned after the sum of the tiles before it."""
        global logup_scan_kernel_launches
        dev = out.device
        if dev.type != "cuda":
            raise TypeError(f"logup_scan_cuda takes CUDA tensors, got {dev}")
        shape = (2, self.logup_groups()[1], self.n_rows)
        if (partial.device != dev or partial.dtype != torch.int64 or not partial.is_contiguous()
                or tuple(partial.shape) != shape):
            raise ValueError(f"logup_scan_cuda: the group sums must be a contiguous int64 {shape} tensor on {dev}")
        if (out.dtype != torch.int64 or not out.is_contiguous()
                or tuple(out.shape) != (self.n_aux_cols, self.n_rows)):
            raise ValueError(f"logup_scan_cuda: the output must be a contiguous int64 "
                             f"({self.n_aux_cols}, {self.n_rows}) tensor")
        tile_sums = torch.empty((2, self.scan_tiles()[1]), dtype=torch.int64, device=dev)
        _logup_launch("tmx_logup_scan", self._logup_args(out, partial, tile_sums=tile_sums), dev)
        logup_scan_kernel_launches += 2

    def logup_terms_plain(self, trace: GF, gamma: GF2) -> tuple[torch.Tensor, torch.Tensor]:
        """logup_terms_cuda's two results as torch ops (any device): the
        (2 (n_batches + width), n) w and wt rows, and the (2, groups, n)
        group sums."""
        aux = self.build_aux_plain(trace, gamma).v
        terms = self.n_batches + self.width
        rows = aux[: 2 * terms]
        group, n_groups = self.logup_groups()
        sign = [0] * self.n_batches + [1] * self.width
        parts = []
        for c in range(2):
            comp = rows[c::2]  # (terms, n)
            signed = torch.stack([GF(comp[t]).v if not sign[t] else (-GF(comp[t])).v for t in range(terms)])
            parts.append(torch.stack([
                field_sum(signed[g * group : (g + 1) * group], 0) for g in range(n_groups)
            ]))
        return rows, torch.stack(parts)

    @staticmethod
    def logup_scan_plain(partial: torch.Tensor) -> torch.Tensor:
        """logup_scan's S rows, (2, n), from the group sums (any device)."""
        return torch.stack([_prefix_sum(field_sum(partial[c], 0)) for c in range(2)])

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


# -- csrc/logup.cu -----------------------------------------------------------


class _LogupArgs(ctypes.Structure):
    """csrc/logup.cu's LogupArgs, field for field."""

    _fields_ = [
        ("trace", ctypes.c_void_p), ("trace_ld", ctypes.c_int64),
        ("checked", ctypes.c_void_p), ("n_checked", ctypes.c_int64), ("n_batches", ctypes.c_int64),
        ("mult_base", ctypes.c_int64), ("width", ctypes.c_int64), ("span", ctypes.c_int64),
        ("gamma0", ctypes.c_void_p), ("gamma1", ctypes.c_void_p),
        ("n", ctypes.c_int64), ("group", ctypes.c_int64), ("n_groups", ctypes.c_int64),
        ("out", ctypes.c_void_p), ("partial", ctypes.c_void_p),
        ("tile", ctypes.c_int64), ("n_tiles", ctypes.c_int64), ("tile_sums", ctypes.c_void_p),
    ]


@cache
def _logup_library():
    from ..ops.cuda_build import load_library

    lib = load_library("logup")
    for fn in ("tmx_logup_terms", "tmx_logup_scan"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.POINTER(_LogupArgs), ctypes.c_void_p]
    return lib


def _logup_launch(fn: str, args: _LogupArgs, dev):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_logup_library(), fn)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
