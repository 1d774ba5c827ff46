"""Poseidon Merkle tree commitments (device build, host open/verify).

Counterpart of ``tendermintx_tpu/ops/merkle.py``. Leaves are rows of an
(n_leaves, width) field matrix, zero-padded to a RATE multiple and sponge
hashed; an inner node is the 2-to-1 compression of its two children, one
``merkle_layer`` per level. The layers stay on the device; openings gather only the queried
sibling digests. Commitments may be CAPS: the 2^k digests at depth k from
the root.
"""

from __future__ import annotations

import torch

from . import poseidon as ps
from .goldilocks import GF, to_int_array


def pad_row_width(rows: GF) -> GF:
    """Zero-pad the last axis to a RATE multiple."""
    w = int(rows.shape[-1])
    extra = (-w) % ps.RATE
    if not extra:
        return rows
    z = GF.zeros(tuple(rows.shape[:-1]) + (extra,), rows.device)
    return GF.concatenate([rows, z], axis=-1)


def pad_row_ints(row: list[int]) -> list[int]:
    """Host-side analog of pad_row_width for an opened leaf row."""
    return list(row) + [0] * ((-len(row)) % ps.RATE)


def cap_levels(n_leaves: int, cap_bits: int) -> int:
    """Number of path levels below a 2^min(cap_bits, depth)-entry cap."""
    depth = max(n_leaves.bit_length() - 1, 0)
    return depth - min(cap_bits, depth)


class MerkleTree:
    """dev_layers[0]: (n_leaves, 4) leaf digests; dev_layers[-1]: (1, 4)."""

    def __init__(self, dev_layers: list[GF]):
        self.dev_layers = dev_layers
        self._root = None

    @property
    def root(self) -> list[int]:
        if self._root is None:
            self._root = [int(v) for v in self.dev_layers[-1].to_ints()[0]]
        return self._root

    @property
    def n_leaves(self) -> int:
        return int(self.dev_layers[0].shape[0])

    def cap_dev(self, cap_bits: int) -> GF:
        """The cap as its device (2^min(cap_bits, depth), 4) digest layer."""
        depth = len(self.dev_layers) - 1
        return self.dev_layers[depth - min(cap_bits, depth)]

    def cap(self, cap_bits: int) -> list[list[int]]:
        """The 2^min(cap_bits, depth) digests at cap depth."""
        return [[int(v) for v in row] for row in self.cap_dev(cap_bits).to_ints()]

    @classmethod
    def build(cls, rows: GF) -> "MerkleTree":
        """rows: (n_leaves, width) on the device; n_leaves a power of two."""
        n = int(rows.shape[0])
        if n & (n - 1):
            raise ValueError("n_leaves must be a power of two")
        return cls._from_leaves(ps.hash_no_pad(pad_row_width(rows)), n)

    @classmethod
    def from_leaves(cls, leaves: GF) -> "MerkleTree":
        """A tree over already hashed (n_leaves, 4) leaf digests;
        n_leaves a power of two. The prover's LDE trees hash their leaves
        straight from column-major row blocks (``poseidon.hash_no_pad_cols``,
        digest-identical to ``build`` of the transposed rows without the
        row-major copy; the sponge zero-fills a ragged last chunk itself)."""
        n = int(leaves.shape[0])
        if n & (n - 1):
            raise ValueError("n_leaves must be a power of two")
        return cls._from_leaves(leaves, n)

    @classmethod
    def _from_leaves(cls, leaves: GF, n: int) -> "MerkleTree":
        layers = [leaves]
        cur = leaves
        while int(cur.shape[0]) > 1:
            cur = ps.merkle_layer(cur)
            layers.append(cur)
        return cls(layers)

    def open(self, index: int) -> list[list[int]]:
        """Sibling path from leaf `index` to the root (exclusive)."""
        return self.open_many([index])[index]

    def sibling_gather(self, indices: list[int], cap_bits: int = 0):
        """Device gather of every sibling digest for `indices` up to the
        cap level. Returns (GF (n_inner*k, 4), uniq, n_inner); decode the
        fetched ints with `decode_paths`."""
        uniq = sorted(set(int(i) for i in indices))
        k = len(uniq)
        n_inner = cap_levels(self.n_leaves, cap_bits)
        dev = self.dev_layers[0].device
        if n_inner == 0 or k == 0:
            return GF.zeros((0, 4), dev), uniq, n_inner
        gathers = []
        for l in range(n_inner):
            sibs = torch.tensor([(i >> l) ^ 1 for i in uniq], device=dev)
            gathers.append(self.dev_layers[l].v.index_select(0, sibs))
        return GF(torch.cat(gathers, dim=0)), uniq, n_inner

    @staticmethod
    def decode_paths(allg, uniq: list[int], n_inner: int):
        """allg: (n_inner*k, 4) ints from sibling_gather's fetch."""
        k = len(uniq)
        return {
            idx: [[int(v) for v in allg[l * k + qi]] for l in range(n_inner)]
            for qi, idx in enumerate(uniq)
        }

    def open_many(self, indices: list[int]) -> dict[int, list[list[int]]]:
        dev, uniq, n_inner = self.sibling_gather(indices)
        if n_inner == 0 or not uniq:
            return {i: [] for i in uniq}
        return self.decode_paths(to_int_array(dev.v), uniq, n_inner)


def verify_opening(
    cap: list[list[int]],
    index: int,
    leaf_row: list[int],
    path: list[list[int]],
    levels: int | None = None,
) -> bool:
    """Host-side check of an opening against a Merkle CAP: leaf_row is the
    raw row (pre-hash, pre-padding); the path climbs len(path) levels and
    the digest must equal cap[index >> len(path)]. `levels`, when given,
    pins the path length."""
    if levels is not None and len(path) != levels:
        return False
    slot = index >> len(path)
    if not 0 <= slot < len(cap):
        return False
    expected = cap[slot]
    row = pad_row_ints(leaf_row)
    from ..utils import native

    out = native.merkle_verify_native(list(expected), index, row, path)
    if out is not None:
        return out
    digest = ps.hash_ints(row)
    idx = index
    for sibling in path:
        if idx & 1:
            digest = ps.two_to_one_ints(sibling, digest)
        else:
            digest = ps.two_to_one_ints(digest, sibling)
        idx >>= 1
    return digest == list(expected)
