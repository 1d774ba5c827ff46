"""Sharded STARK proving over a lane mesh.

Counterpart of ``tendermintx_tpu/parallel/prover.py``. The prover's heavy
phases map onto the 1-D mesh of parallel/sharding.py:

  * trace/aux LDE  - COLUMN-sharded (each NTT is independent per column;
                     no communication);
  * resharding     - one column-to-row ``all_to_all`` turns the column
                     shards into contiguous (columns, N/D) row blocks, the
                     layout the reference gets from XLA where the
                     quotient's row in-spec meets a column-sharded LDE;
  * Merkle leaves  - ROW-sharded: each device sponges its contiguous row
                     block with the column-major Poseidon sponge;
  * quotient       - ROW-sharded: multi-row frames read up to
                     max(frame_offsets) * blowup rows past the block end,
                     fetched from the cyclic right neighbour with ONE
                     ``ppermute`` halo exchange;
  * DEEP           - ROW-sharded (pointwise in the domain, no halo);
  * FRI folds      - ROW-sharded with four routed partial moves;
  * one long NTT   - the four-step all-to-all NTT (``sharded_ntt_fn``).

A sharded value is a list of per-device blocks, block i on
``mesh.devices[i]``; values the reference replicates live on the mesh's
first device and are copied to each device as a phase needs them. Every
function computes the same values whatever the mesh size; stark/prover.py
runs the statement phases through them on every path (a one-device mesh
without ``mesh=``), and the fold and the NTT equal stark/fri.py's and
ops/ntt.py's, so ``prove(..., mesh=...)`` gives byte-identical proofs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ntt as nttmod
from ..ops import poseidon as ps
from ..ops.ext import GF2
from ..ops.goldilocks import GF, P, tensor_from_u64
from .sharding import LaneMesh, all_to_all, ppermute


def _gf_to(x: GF, dev) -> GF:
    return GF(x.v.to(dev, non_blocking=True))


def _gf2_to(x: GF2, dev) -> GF2:
    return GF2(_gf_to(x.c0, dev), _gf_to(x.c1, dev))


def _rows(x, start: int, stop: int, dev):
    """Rows [start, stop) of the last axis of a GF / GF2, on `dev`."""
    if isinstance(x, GF2):
        return GF2(_rows(x.c0, start, stop, dev), _rows(x.c1, start, stop, dev))
    return _gf_to(x[..., start:stop], dev)


def sharded_trace_lde(mesh: LaneMesh, rate_bits: int, shift: int):
    """Column-sharded LDE, the sharded analog of stark.prover.trace_lde.

    fn(cols GF (C, n)) -> (coeffs GF (C, n) on the first device,
    lde blocks: D x GF (ceil(C/D), N)); the column count is padded with
    zero columns to a multiple of the mesh size, so the last blocks may
    end in padding (``columns_to_rows`` drops it)."""
    D = mesh.size

    def fn(cols: GF):
        C = int(cols.shape[0])
        extra = (-C) % D
        v = cols.v
        if extra:
            v = torch.cat([v, torch.zeros((extra,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)])
        coeffs, ldes = [], []
        for block in mesh.split(v, 0):
            c = nttmod.intt(GF(block))
            ldes.append(nttmod.coset_lde(c, rate_bits, shift))
            coeffs.append(c.v)
        return GF(mesh.gather(coeffs)[:C]), ldes

    return fn


def columns_to_rows(mesh: LaneMesh, blocks: list[GF], n_cols: int) -> list[GF]:
    """Column shards (D x (Cb, N)) -> contiguous row blocks (D x (n_cols,
    N/D)) by one tiled all_to_all; the zero padding columns beyond
    `n_cols` are dropped."""
    rows = all_to_all(mesh, [b.v for b in blocks], split_dim=1, concat_dim=0)
    return [GF(r[:n_cols]) for r in rows]


def sharded_leaf_hashes(mesh: LaneMesh):
    """Row-sharded Merkle leaf hashing: fn(row blocks D x GF (L, N/D))
    -> GF (N, 4) leaf digests on the first device, one column-major
    sponge (``poseidon.hash_no_pad_cols``: the kernel on a card) per
    block. Equal to hash_no_pad of the (N, L) rows zero-padded to a RATE
    multiple."""

    def fn(blocks: list[GF]) -> GF:
        return GF(mesh.gather([ps.hash_no_pad_cols(GF(b.v.contiguous())).v for b in blocks]))

    return fn


def _window(block: torch.Tensor, halo: torch.Tensor | None, start: int, length: int) -> torch.Tensor:
    """Columns [start, start + length) of cat([block, halo], dim=1),
    without materializing the concatenation."""
    nb = int(block.shape[1])
    if start + length <= nb:
        return block[:, start : start + length]
    over = start + length - nb
    return torch.cat([block[:, start:], halo[:, :over]], dim=1)


def sharded_quotient_fn(mesh: LaneMesh, air, log_n: int, rate_bits: int):
    """Row-sharded constraint quotient with a ppermute halo exchange.

    Device d holds LDE columns [d*Nb, (d+1)*Nb); frame offset k reads row
    x + k*blowup, so each device needs the first max_offset*blowup rows of
    its right (cyclic) neighbour: one ppermute of that halo slab replaces
    ``% N`` indexing over the whole domain (on a one-device mesh the halo
    is the shard's own leading rows). Within a shard, rows go through
    ``_eval_quotient_core`` in blocks of ``_quotient_blocks`` rows.

    fn(trace blocks, aux blocks | None, alpha_pows, pub, periodic,
       public_cols, zinvs, chal) -> D x GF2 (Nb,)

    The LDE blocks are the row blocks of ``columns_to_rows``; periodic,
    public_cols and zinvs are whole (N,) columns, sharded here; the rest
    is replicated."""
    from ..stark.prover import _eval_quotient_core, _quotient_blocks

    D = mesh.size
    N = 1 << (log_n + rate_bits)
    blowup = 1 << rate_bits
    offsets = list(air.frame_offsets)
    halo = max(offsets) * blowup
    Nb = N // D
    if halo > Nb:
        raise ValueError(f"shard block of {Nb} rows is smaller than the frame halo of {halo}")
    # send my leading slab to my LEFT neighbour (it is their right halo)
    perm = [(i, (i - 1) % D) for i in range(D)]
    n_total = air.n_cols + air.n_aux_cols
    n_sub = _quotient_blocks(len(offsets), n_total, Nb)
    B = Nb // n_sub

    def exchange(blocks):
        if blocks is None or not halo:
            return [None] * D
        return ppermute(mesh, [b.v[:, :halo] for b in blocks], perm)

    def fn(trace_blocks, aux_blocks, alpha_pows, pub, periodic, public_cols, zinvs, chal):
        t_halo = exchange(trace_blocks)
        a_halo = exchange(aux_blocks)
        out = []
        for d, dev in enumerate(mesh.devices):
            tb = trace_blocks[d].v
            ab = aux_blocks[d].v if aux_blocks is not None else None
            alpha_d, pub_d, chal_d = _gf2_to(alpha_pows, dev), _gf_to(pub, dev), _gf_to(chal, dev)
            parts = []
            for si in range(n_sub):
                s = si * B
                frame = []
                for k in offsets:
                    f = _window(tb, t_halo[d], s + k * blowup, B)
                    if ab is not None:
                        f = torch.cat([f, _window(ab, a_halo[d], s + k * blowup, B)])
                    frame.append(f)
                stacked = GF(torch.stack(frame))
                del frame
                g0 = d * Nb + s
                parts.append(
                    _eval_quotient_core(
                        air, stacked, alpha_d, pub_d,
                        tuple(_rows(p, g0, g0 + B, dev) for p in periodic),
                        tuple(_rows(p, g0, g0 + B, dev) for p in public_cols),
                        tuple(_rows(z, g0, g0 + B, dev) for z in zinvs),
                        chal_d, B,
                    )
                )
                del stacked
            out.append(GF2.concatenate(parts, axis=0))
        return out

    return fn


def sharded_deep_fn(mesh: LaneMesh, air, log_n: int, rate_bits: int):
    """Row-sharded DEEP composition (pointwise in the domain).

    fn(trace blocks, aux blocks | None, chunk blocks D x GF2 (n_chunks, Nb),
       betas_t, betas_q, g0s, invs GF2 (n_offsets, N)) -> D x GF2 (Nb,)"""
    from ..stark.prover import deep_composition

    D = mesh.size
    Nb = (1 << (log_n + rate_bits)) // D

    def fn(trace_blocks, aux_blocks, chunk_blocks, betas_t, betas_q, g0s, invs):
        out = []
        for d, dev in enumerate(mesh.devices):
            out.append(
                deep_composition(
                    trace_blocks[d],
                    aux_blocks[d] if aux_blocks is not None else None,
                    chunk_blocks[d],
                    _gf2_to(betas_t, dev), _gf2_to(betas_q, dev), _gf2_to(g0s, dev),
                    _rows(invs, d * Nb, (d + 1) * Nb, dev),
                )
            )
        return out

    return fn


def sharded_fold_fn(mesh: LaneMesh):
    """Row-sharded FRI fold.

    A fold pairs positions (i, i + N/2): with the evaluations row-sharded
    over D devices, device d's OUTPUT block [d*N/2D, (d+1)*N/2D) needs the
    E half from (device d//2, local half d%2) and the O half from (device
    D/2 + d//2, same local half). Four partial ppermutes move exactly one
    N/2D-sized piece to every device, then the fold is local:

        out = (E + O)/2 + beta * (E - O) * (2x)^{-1}

    fn(blocks D x GF2 (N/D,), invx GF (N/2,), beta GF2 (1,)) -> D x GF2
    (N/2D,), the values of fri._fold_layer. Needs D even and N >= 2D."""
    from ..stark.fri import _fold_layer

    D = mesh.size
    if D % 2:
        raise ValueError("the sharded fold needs an even mesh")
    pe0 = [(s, 2 * s) for s in range(D // 2)]
    pe1 = [(s, 2 * s + 1) for s in range(D // 2)]
    po0 = [(s, 2 * (s - D // 2)) for s in range(D // 2, D)]
    po1 = [(s, 2 * (s - D // 2) + 1) for s in range(D // 2, D)]

    def route(halves: list[GF2], pairs) -> list[GF2]:
        c0 = ppermute(mesh, [h.c0.v for h in halves], pairs)
        c1 = ppermute(mesh, [h.c1.v for h in halves], pairs)
        return [GF2(GF(a), GF(b)) for a, b in zip(c0, c1)]

    def fn(blocks: list[GF2], invx: GF, beta: GF2) -> list[GF2]:
        half = int(blocks[0].shape[0]) // 2
        h0 = [GF2(b.c0[:half], b.c1[:half]) for b in blocks]
        h1 = [GF2(b.c0[half:], b.c1[half:]) for b in blocks]
        e0, e1, o0, o1 = route(h0, pe0), route(h1, pe1), route(h0, po0), route(h1, po1)
        out = []
        for d, dev in enumerate(mesh.devices):
            odd = d % 2 == 1
            e = e1[d] if odd else e0[d]
            o = o1[d] if odd else o0[d]
            # _fold_layer of the (E, O) pair: its first half is E, its
            # second O, and invx is this device's slice of the table
            pair = GF2(GF(torch.cat([e.c0.v, o.c0.v])), GF(torch.cat([e.c1.v, o.c1.v])))
            out.append(_fold_layer(pair, _gf2_to(beta, dev), _rows(invx, d * half, (d + 1) * half, dev)))
        return out

    return fn


def sharded_ntt_fn(mesh: LaneMesh, log_n: int):
    """One length-2^log_n NTT sharded across the mesh by the four-step
    (Bailey) decomposition: the communication pattern that scales a
    SINGLE polynomial column beyond one device's memory (for columns that
    fit one device, the per-column sharding of sharded_trace_lde needs no
    collectives). With N = R*C, R = D devices, coefficients row-major
    x[r*C + c] (device r holds row r):

        A[p, c] = DFT_R over r of x[. C + c]          (cross-device dim)
        B[p, c] = A[p, c] * w_N^(p*c)                 (twiddle)
        X[q*R + p] = DFT_C over c of B[p, .] at q     (in-device dim)

    Three all_to_alls make each DFT local: columns to devices for DFT_R,
    rows back for DFT_C, and a final transpose into natural order.

    fn(blocks D x GF (C,)) -> D x GF (C,), block r holding entries
    [r*C, (r+1)*C) of ops/ntt.ntt of the whole vector (same values, same
    order). Needs N >= D^2."""
    D = mesh.size
    N = 1 << log_n
    C = N // D
    if C % D:
        raise ValueError("the four-step layout needs N >= D^2")
    w = nttmod.primitive_root_of_unity(log_n)
    tw = np.empty((D, C), dtype=np.uint64)  # tw[p, c] = w^(p*c)
    for p in range(D):
        tw[p] = nttmod.power_table(pow(w, p, P), C)
    tw_blocks = mesh.split(tensor_from_u64(tw), 1)  # device e: columns of chunk e

    def fn(blocks: list[GF]) -> list[GF]:
        # device r: (D, C/D), row j = x[r*C + j*C/D : r*C + (j+1)*C/D]
        cols = all_to_all(mesh, [b.v.reshape(D, C // D) for b in blocks], 0, 0)
        # device e: (D, C/D) = all rows r, columns of chunk e; DFT over r
        b_ = []
        for e, col in enumerate(cols):
            a = nttmod.ntt(GF(col.t().contiguous())).v.t()  # (D, C/D): [p, c_loc]
            b_.append((GF(a) * GF(tw_blocks[e])).v)
        # device p: (1, C) = row p, every c; DFT over c (natural q order)
        rows_p = all_to_all(mesh, b_, 0, 1)
        f = [nttmod.ntt(GF(r.reshape(C))).v for r in rows_p]
        # final transpose to the natural k = q*R + p order
        out = all_to_all(mesh, [x.reshape(D, C // D) for x in f], 0, 0)  # device j: [p, q_loc]
        return [GF(o.t().reshape(C)) for o in out]

    return fn
