"""Step/skip verification as batched tensor programs on one device.

Counterpart of ``tendermintx_tpu/circuits/verify.py``: the upstream
circuits' `verify_step` and `verify_skip` as one boolean conjunction each
over a witness (circuits/variables.py), on the device the witness lives
on. Scalars (heights as (lo, hi) 32-bit halves, lengths) may be Python
ints or tensors. Each returns (valid: () bool tensor, header (32,) uint8).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ed25519
from . import gadgets as g
from .consts import VARINT_BYTES_LENGTH_MAX
from .gadgets import MASK32, as_tensor
from .variables import HeaderProof, SkipWitness, StepWitness


# ---------------------------------------------------------------------------
# In-program protobuf varint marshaling
# ---------------------------------------------------------------------------


def marshal_int64_varint(h_lo, h_hi):
    """Protobuf varint encoding of a u64 given as (lo, hi) 32-bit halves
    (the MSB must be 0: a non-negative i64). Returns (bytes (9,) uint8,
    length ())."""
    septets = []
    for k in range(VARINT_BYTES_LENGTH_MAX):
        lo_shift = 7 * k
        if lo_shift < 32:
            s = (h_lo >> lo_shift) & 0x7F
            if lo_shift > 32 - 7:
                s = s | ((h_hi << (32 - lo_shift)) & 0x7F)
        else:
            s = (h_hi >> (lo_shift - 32)) & 0x7F
        septets.append(s)
    sep = torch.stack(septets)
    idx = torch.arange(VARINT_BYTES_LENGTH_MAX, device=sep.device)
    # length = index of the last nonzero septet + 1 (at least 1)
    length = torch.clamp(torch.where(sep != 0, idx, 0).max() + 1, min=1)
    out = sep | ((idx < length - 1).to(torch.int64) << 7)
    return torch.where(idx < length, out, 0).to(torch.uint8), length


def _height_leaf(h_lo, h_hi, width: int):
    """Expected 0x00-prefixed Int64Value header leaf for a height."""
    varint, vlen = marshal_int64_varint(h_lo, h_hi)
    leaf = torch.zeros((width,), dtype=torch.uint8, device=varint.device)
    leaf[1] = 0x08
    leaf[2 : 2 + VARINT_BYTES_LENGTH_MAX] = varint
    return leaf, vlen + 2


def _proof_roots(proofs: list[HeaderProof]) -> torch.Tensor:
    """Roots of several header proofs, evaluated as one batch. -> (k, 32)."""
    return g.header_proof_root(
        torch.cat([p.leaf_bytes for p in proofs]),
        torch.cat([p.leaf_len for p in proofs]),
        torch.cat([p.aunts for p in proofs]),
        torch.cat([p.path_bits for p in proofs]),
    )


def _leaf_hash_window(p: HeaderProof, start: int) -> torch.Tensor:
    """32 bytes of the proof leaf from `start` (the 0x00 prefix counts)."""
    return p.leaf_bytes[0, start : start + 32]


def _lanes_checks(lanes, nb, round_, height_lo, height_hi, header_hash):
    """Checks shared by step and skip: signatures (with full witness
    binding: challenge SHA-512, Straus table and scalar bits derived or
    checked from the raw bytes), message contents, the enabled-lane shape,
    the validators-hash recomputation and 2/3 of the voting power.
    Returns (ok, computed validators hash)."""
    B = lanes.pubkeys.shape[0]
    dev = lanes.pubkeys.device
    sig_ok = ed25519.verify_bound(
        lanes.table_x, lanes.table_y, lanes.table_t, lanes.bits2,
        lanes.rx, lanes.ry, lanes.sig_r, lanes.sig_s, lanes.sig_pubkeys,
        lanes.messages, lanes.msg_len, lanes.k_q,
    ).all()
    # signed lanes must verify under the validator's own pubkey; the dummy
    # triple is only legal for unsigned lanes
    pk_ok = (~lanes.signed | g.bytes_equal(lanes.sig_pubkeys, lanes.pubkeys)).all()
    msg_ok = g.message_checks(
        lanes.messages, lanes.msg_len, lanes.signed, round_,
        (height_lo, height_hi), header_hash,
    ).all()
    lane_shape_ok = (lanes.enabled == (torch.arange(B, device=dev) < as_tensor(nb, dev))).all() & (
        ~lanes.signed | lanes.enabled
    ).all()
    leaf_digests = g.hash_validator_leaves(lanes.leaf_bytes, lanes.leaf_len)
    computed_vhash = g.merkle_root_dynamic(leaf_digests, nb)
    threshold_ok = g.voting_threshold_ok(lanes.vp_lo, lanes.vp_hi, lanes.signed, lanes.enabled, 2, 3)
    return sig_ok & pk_ok & msg_ok & lane_shape_ok & threshold_ok, computed_vhash


def _leaf_ok(proof: HeaderProof, leaf: torch.Tensor, leaf_len) -> torch.Tensor:
    return g.bytes_equal(proof.leaf_bytes[0], leaf) & (proof.leaf_len[0] == leaf_len)


def step_verify(
    w: StepWitness,
    prev_header_hash,  # (32,) u8
    prev_h_lo,
    prev_h_hi,
    chain_id_leaf,  # (73,) u8 zero-padded expected leaf
    chain_id_leaf_len,
):
    """Returns (valid: () bool, next_header (32,) u8), the upstream
    `verify_step`: full header verification of prev + 1 plus the
    previous-hash and next-validators-hash links."""
    dev = w.next_header.device
    prev_header_hash = torch.as_tensor(prev_header_hash).to(dev)
    next_lo = (as_tensor(prev_h_lo, dev) + 1) & MASK32
    next_hi = (as_tensor(prev_h_hi, dev) + (next_lo == 0).to(torch.int64)) & MASK32

    base_ok, computed_vhash = _lanes_checks(
        w.lanes, w.nb_validators, w.round, next_lo, next_hi, w.next_header
    )
    vh, cid, hp, lbi, pnvh = (
        w.validators_hash_proof, w.chain_id_proof, w.height_proof,
        w.last_block_id_proof, w.prev_nvh_proof,
    )
    roots = _proof_roots([vh, cid, hp, lbi, pnvh])
    # the header Merkle proofs all bind to next_header
    vh_ok = g.bytes_equal(roots[0], w.next_header) & g.bytes_equal(
        _leaf_hash_window(vh, 3), computed_vhash
    )
    cid_ok = g.bytes_equal(roots[1], w.next_header) & _leaf_ok(
        cid, torch.as_tensor(chain_id_leaf).to(dev), as_tensor(chain_id_leaf_len, dev)
    )
    exp_leaf, exp_len = _height_leaf(next_lo, next_hi, hp.leaf_bytes.shape[1])
    h_ok = g.bytes_equal(roots[2], w.next_header) & _leaf_ok(hp, exp_leaf, exp_len)
    # previous-header link via the LAST_BLOCK_ID leaf
    lbi_ok = g.bytes_equal(roots[3], w.next_header) & g.bytes_equal(
        _leaf_hash_window(lbi, 3), prev_header_hash
    )
    # validator-set link via the previous header's NEXT_VALIDATORS_HASH
    pnvh_ok = g.bytes_equal(roots[4], prev_header_hash) & g.bytes_equal(
        _leaf_hash_window(pnvh, 3), computed_vhash
    )
    valid = base_ok & vh_ok & cid_ok & h_ok & lbi_ok & pnvh_ok
    return valid, w.next_header


def skip_verify(
    w: SkipWitness,
    trusted_header_hash,  # (32,) u8
    trusted_h_lo,
    trusted_h_hi,
    target_h_lo,
    target_h_hi,
    chain_id_leaf,
    chain_id_leaf_len,
    skip_max: int,
):
    """Returns (valid, target_header), the upstream `verify_skip`: skip
    distance, the 1/3 trusted-validator intersection and full header
    verification of the target block."""
    dev = w.target_header.device
    trusted_header_hash = torch.as_tensor(trusted_header_hash).to(dev)
    t_lo, t_hi, g_lo, g_hi = (
        as_tensor(v, dev) for v in (trusted_h_lo, trusted_h_hi, target_h_lo, target_h_hi)
    )
    base_ok, computed_vhash = _lanes_checks(
        w.lanes, w.nb_target_validators, w.target_round, g_lo, g_hi, w.target_header
    )
    vh, cid, hp, tvh = w.validators_hash_proof, w.chain_id_proof, w.height_proof, w.trusted_vh_proof
    roots = _proof_roots([vh, cid, hp, tvh])
    vh_ok = g.bytes_equal(roots[0], w.target_header) & g.bytes_equal(
        _leaf_hash_window(vh, 3), computed_vhash
    )
    cid_ok = g.bytes_equal(roots[1], w.target_header) & _leaf_ok(
        cid, torch.as_tensor(chain_id_leaf).to(dev), as_tensor(chain_id_leaf_len, dev)
    )
    exp_leaf, exp_len = _height_leaf(g_lo, g_hi, hp.leaf_bytes.shape[1])
    h_ok = g.bytes_equal(roots[2], w.target_header) & _leaf_ok(hp, exp_leaf, exp_len)

    # the trusted validators hash binds to the trusted header
    tl = w.trusted_lanes
    trusted_vhash = g.merkle_root_dynamic(
        g.hash_validator_leaves(tl.leaf_bytes, tl.leaf_len), w.nb_trusted_validators
    )
    tvh_ok = g.bytes_equal(roots[3], trusted_header_hash) & g.bytes_equal(
        _leaf_hash_window(tvh, 3), trusted_vhash
    )
    trusted_shape_ok = (
        tl.enabled == (torch.arange(tl.pubkeys.shape[0], device=dev) < as_tensor(w.nb_trusted_validators, dev))
    ).all()

    # 1/3 intersection over the trusted voting power
    signed_mask = g.trusted_intersection_mask(
        w.lanes.pubkeys, w.lanes.signed & w.lanes.enabled, tl.pubkeys
    )
    intersect_ok = g.voting_threshold_ok(tl.vp_lo, tl.vp_hi, signed_mask, tl.enabled, 1, 3)

    # skip distance: trusted + 1 < target <= trusted + skip_max
    one = (as_tensor(1, dev), as_tensor(0, dev))
    gt_ok = g.u64_gt((g_lo, g_hi), g.u64_add((t_lo, t_hi), one))
    smax = (as_tensor(skip_max & MASK32, dev), as_tensor(skip_max >> 32, dev))
    le_ok = ~g.u64_gt((g_lo, g_hi), g.u64_add((t_lo, t_hi), smax))

    valid = base_ok & vh_ok & cid_ok & h_ok & tvh_ok & trusted_shape_ok & intersect_ok & gt_ok & le_ok
    return valid, w.target_header


def chain_id_leaf_const(chain_id: str, width: int = 73):
    """Expected 0x00-prefixed StringValue leaf for the chain id:
    ((width,) uint8 tensor, its length)."""
    body = chain_id.encode()
    full = b"\x00" + b"\x0a" + bytes([len(body)]) + body
    arr = np.zeros((width,), dtype=np.uint8)
    arr[: len(full)] = np.frombuffer(full, dtype=np.uint8)
    return torch.from_numpy(arr), len(full)
