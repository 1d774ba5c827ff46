"""Device gadgets for Tendermint header verification.

Counterpart of ``tendermintx_tpu/circuits/gadgets.py``: each gadget is a
batched tensor program over validator lanes or proof lanes, on the
device of its inputs. Bytes are uint8 tensors; 64-bit integers (voting
power, heights) are (lo, hi) pairs of 32-bit values in int64 tensors, with
the reference's wrap-around arithmetic; digests are uint8 (..., 32).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import sha256
from ..ops.cuda_build import operand
from .consts import HEADER_PROOF_DEPTH

MASK32 = 0xFFFFFFFF


def as_tensor(x, device) -> torch.Tensor:
    """A Python int or a tensor as an int64 tensor on `device`."""
    return torch.as_tensor(x, device=device).to(torch.int64)


# ---------------------------------------------------------------------------
# Byte/block helpers
# ---------------------------------------------------------------------------


def bytes_to_blocks(data: torch.Tensor, byte_len: torch.Tensor, n_blocks: int):
    """SHA-256-pad lanes of bytes on their device.

    data: (B, max_bytes) uint8 (zero right-padded), byte_len: (B,).
    Returns (blocks (B, n_blocks, 16) int64 words, n_active (B,)). The
    caller guarantees byte_len <= n_blocks*64 - 9 per lane."""
    B, max_bytes = data.shape
    dev = data.device
    total = n_blocks * 64
    byte_len = as_tensor(byte_len, dev)
    buf = torch.zeros((B, total), dtype=torch.int64, device=dev)
    buf[:, :max_bytes] = data.to(torch.int64)
    idx = torch.arange(total, device=dev)[None, :]
    buf = torch.where(idx < byte_len[:, None], buf, 0)
    buf = torch.where(idx == byte_len[:, None], 0x80, buf)
    # per-lane block count: smallest nb with byte_len + 9 <= nb*64
    n_active = (byte_len + 9 + 63) // 64
    bitlen = byte_len * 8
    # the 8-byte big-endian length field ends the last active block; only
    # its low 4 bytes can be nonzero for these sizes
    last = n_active * 64 - 8
    rows = torch.arange(B, device=dev)
    for k in range(4):
        buf[rows, last + 4 + k] = (bitlen >> (8 * (3 - k))) & 0xFF
    w = buf.reshape(B, n_blocks, 16, 4)
    blocks = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]
    return blocks, n_active


def digests_to_bytes_dev(digests: torch.Tensor) -> torch.Tensor:
    """(B, 8) int64 words -> (B, 32) uint8 big-endian."""
    shifts = torch.tensor([24, 16, 8, 0], device=digests.device)
    return ((digests[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(digests.shape[0], 32)


def sha256_bytes_var(data: torch.Tensor, byte_len: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Variable-length SHA-256 of byte lanes -> (B, 32) uint8 digests."""
    return digests_to_bytes_dev(sha256.sha256_blocks(*bytes_to_blocks(data, byte_len, n_blocks)))


def _sha256_bytes_plain(data: torch.Tensor, byte_len: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """sha256_bytes_var through the plain SHA-256 rounds on any device (the
    twins' hashes)."""
    return digests_to_bytes_dev(sha256.sha256_blocks_plain(*bytes_to_blocks(data, byte_len, n_blocks)))


# ---------------------------------------------------------------------------
# Validator hashing
# ---------------------------------------------------------------------------


def hash_validator_leaves(leaf_bytes: torch.Tensor, leaf_len: torch.Tensor) -> torch.Tensor:
    """leaf_bytes: (B, 47) uint8 = 0x00 ‖ SimpleValidator encoding (padded),
    leaf_len: (B,) true lengths including the 0x00 prefix. -> (B, 32)."""
    return sha256_bytes_var(leaf_bytes, leaf_len, n_blocks=1)


def _pair_hashes(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """SHA-256(0x01 ‖ left ‖ right) per row (an inner Merkle node), the
    plain rounds."""
    prefix = torch.ones((left.shape[0], 1), dtype=torch.uint8, device=left.device)
    inp = torch.cat([prefix, left, right], dim=1)
    return _sha256_bytes_plain(inp, torch.full((left.shape[0],), 65, device=left.device), n_blocks=2)


def merkle_root_dynamic(leaf_digests: torch.Tensor, n_enabled) -> torch.Tensor:
    """CometBFT variable-size Merkle root over the first n_enabled of B leaf
    digests, as torch ops with the plain SHA-256 rounds (validator_root's
    twin). Level-wise pair-and-promote equals the largest-power-of-two
    split recursion (RFC 6962).

    leaf_digests: (B, 32) uint8; n_enabled: () int or tensor. -> (32,) uint8."""
    B = leaf_digests.shape[0]
    dev = leaf_digests.device
    Bp = 1 << max((B - 1).bit_length(), 0)
    nodes = leaf_digests
    if Bp != B:
        # non-power-of-two lane counts: pad with rows no level ever selects
        nodes = torch.cat([nodes, torch.zeros((Bp - B, 32), dtype=torch.uint8, device=dev)])
    n = as_tensor(n_enabled, dev)
    for _ in range(Bp.bit_length() - 1):
        half = nodes.shape[0] // 2
        merged = _pair_hashes(nodes[0::2], nodes[1::2])
        n_pairs = n // 2
        odd = n % 2
        idx = torch.arange(half, device=dev)
        # node i of the next level: merged[i] for i < n_pairs; the promoted
        # odd node nodes[n-1] at i == n_pairs when n is odd; else zeros
        promoted = nodes.index_select(0, torch.clamp(n - 1, min=0).reshape(1))
        take_merge = (idx < n_pairs)[:, None]
        take_promote = ((idx == n_pairs) & (odd == 1))[:, None]
        nodes = torch.where(take_merge, merged, torch.where(take_promote, promoted, 0)).to(torch.uint8)
        n = n_pairs + odd
    return nodes[0]


# ---------------------------------------------------------------------------
# csrc/sha.cu's validator-tree and header-proof entries
# ---------------------------------------------------------------------------


class _RootArgs(ctypes.Structure):
    """csrc/sha.cu's RootArgs, field for field."""

    _fields_ = [
        ("leaf_bytes", ctypes.c_void_p), ("leaf_len", ctypes.c_void_p), ("n_enabled", ctypes.c_void_p),
        ("lanes", ctypes.c_int64), ("width", ctypes.c_int64), ("out", ctypes.c_void_p),
    ]


class _ProofArgs(ctypes.Structure):
    """csrc/sha.cu's ProofArgs, field for field."""

    _fields_ = [
        ("leaf_bytes", ctypes.c_void_p), ("leaf_len", ctypes.c_void_p), ("aunts", ctypes.c_void_p),
        ("path_bits", ctypes.c_void_p), ("proofs", ctypes.c_int64), ("width", ctypes.c_int64),
        ("out", ctypes.c_void_p),
    ]


# csrc/sha.cu's MAX_TREE_LANES: one block, a thread a leaf
MAX_TREE_LANES = 1024

# incremented exactly where csrc/sha.cu's tree and proof entries are launched
validator_root_kernel_launches = 0
header_proofs_kernel_launches = 0


def _byte_rows(fn: str, leaf_bytes: torch.Tensor) -> tuple[int, int]:
    dev = leaf_bytes.device
    if dev.type != "cuda":
        raise TypeError(f"{fn} hashes on a card, got {dev}")
    if leaf_bytes.dim() != 2:
        raise ValueError(f"{fn}: leaf_bytes must be (lanes, width), got {tuple(leaf_bytes.shape)}")
    return int(leaf_bytes.shape[0]), int(leaf_bytes.shape[1])


def validator_root_cuda(leaf_bytes: torch.Tensor, leaf_len: torch.Tensor, n_enabled: torch.Tensor) -> torch.Tensor:
    """validator_root_plain's (32,) uint8 root by one csrc/sha.cu launch:
    one block of B' threads (B' the lane count rounded up to a power of
    two), the leaves hashed and every level paired and promoted in shared
    memory, n_enabled read on the card. Contiguous uint8 leaf_bytes (B,
    width), int64 leaf_len (B,) and a one-element int64 n_enabled on one
    card, 1 <= B <= MAX_TREE_LANES; else raise."""
    global validator_root_kernel_launches
    fn = "validator_root_cuda"
    B, width = _byte_rows(fn, leaf_bytes)
    if not 1 <= B <= MAX_TREE_LANES:
        raise ValueError(f"{fn}: one block takes 1 to {MAX_TREE_LANES} lanes, got {B}")
    dev = leaf_bytes.device
    if n_enabled.numel() != 1:
        raise ValueError(f"{fn}: n_enabled must hold one value, got {tuple(n_enabled.shape)}")
    ptrs = (operand(leaf_bytes, dev, torch.uint8, (B, width), f"{fn}'s leaf_bytes"),
            operand(leaf_len, dev, torch.int64, (B,), f"{fn}'s leaf_len"),
            operand(n_enabled.reshape(()), dev, torch.int64, (), f"{fn}'s n_enabled"))
    out = torch.empty((32,), dtype=torch.uint8, device=dev)
    sha256.sha_launch("tmx_sha256_validator_root", _RootArgs(*ptrs, lanes=B, width=width, out=out.data_ptr()), dev)
    validator_root_kernel_launches += 1
    return out


def header_proofs_cuda(leaf_bytes: torch.Tensor, leaf_len: torch.Tensor, aunts: torch.Tensor,
                       path_bits: torch.Tensor) -> torch.Tensor:
    """header_proof_root_plain's (k, 32) uint8 roots by one csrc/sha.cu
    launch, a thread a proof. Contiguous uint8 leaf_bytes (k, width) and
    aunts (k, 4, 32), int64 leaf_len (k,) and path_bits (k, 4) on one
    card, else raise; k = 0 launches nothing."""
    global header_proofs_kernel_launches
    fn = "header_proofs_cuda"
    k, width = _byte_rows(fn, leaf_bytes)
    dev = leaf_bytes.device
    ptrs = (operand(leaf_bytes, dev, torch.uint8, (k, width), f"{fn}'s leaf_bytes"),
            operand(leaf_len, dev, torch.int64, (k,), f"{fn}'s leaf_len"),
            operand(aunts, dev, torch.uint8, (k, HEADER_PROOF_DEPTH, 32), f"{fn}'s aunts"),
            operand(path_bits, dev, torch.int64, (k, HEADER_PROOF_DEPTH), f"{fn}'s path_bits"))
    out = torch.empty((k, 32), dtype=torch.uint8, device=dev)
    if k:
        sha256.sha_launch("tmx_sha256_header_proofs", _ProofArgs(*ptrs, proofs=k, width=width, out=out.data_ptr()),
                          dev)
        header_proofs_kernel_launches += 1
    return out


def validator_root_plain(leaf_bytes: torch.Tensor, leaf_len: torch.Tensor, n_enabled) -> torch.Tensor:
    """validator_root as torch ops (any device): the leaves and every
    level through the plain SHA-256 rounds."""
    return merkle_root_dynamic(_sha256_bytes_plain(leaf_bytes, leaf_len, n_blocks=1), n_enabled)


def validator_root(leaf_bytes: torch.Tensor, leaf_len: torch.Tensor, n_enabled) -> torch.Tensor:
    """The validators hash: the CometBFT Merkle root over the first
    n_enabled of the B validator leaves, merkle_root_dynamic of
    hash_validator_leaves (leaf_bytes (B, 47) uint8 0x00-prefixed,
    leaf_len (B,) their lengths; n_enabled () int or tensor). -> (32,)
    uint8: the plain twin for a CPU tensor, one csrc/sha.cu launch for a
    CUDA tensor (at most MAX_TREE_LANES lanes)."""
    t = leaf_bytes.device.type
    if t == "cpu":
        return validator_root_plain(leaf_bytes, leaf_len, n_enabled)
    if t == "cuda":
        dev = leaf_bytes.device
        return validator_root_cuda(leaf_bytes, as_tensor(leaf_len, dev), as_tensor(n_enabled, dev))
    raise ValueError(f"no validator root for device {leaf_bytes.device}")


# ---------------------------------------------------------------------------
# Header-field Merkle proofs (fixed depth 4)
# ---------------------------------------------------------------------------


def header_proof_root_plain(
    leaf_bytes: torch.Tensor,
    leaf_len: torch.Tensor,
    aunts: torch.Tensor,
    path_bits: torch.Tensor,
) -> torch.Tensor:
    """header_proof_root as torch ops with the plain SHA-256 rounds (any
    device)."""
    digest = _sha256_bytes_plain(leaf_bytes, leaf_len, n_blocks=2)
    for d in range(HEADER_PROOF_DEPTH):
        aunt = aunts[:, d, :]
        right_child = (path_bits[:, d] == 1)[:, None]
        left = torch.where(right_child, aunt, digest)
        right = torch.where(right_child, digest, aunt)
        digest = _pair_hashes(left, right)
    return digest


def header_proof_root(
    leaf_bytes: torch.Tensor,
    leaf_len: torch.Tensor,
    aunts: torch.Tensor,
    path_bits: torch.Tensor,
) -> torch.Tensor:
    """Batched fixed-depth-4 header Merkle proof evaluation.

    leaf_bytes: (B, L) uint8 (0x00-prefixed leaf, padded), leaf_len: (B,),
    aunts: (B, 4, 32) uint8, path_bits: (B, 4) (1 = the current node is
    the right child). -> roots (B, 32) uint8: the plain twin for a CPU
    tensor, one csrc/sha.cu launch for a CUDA tensor."""
    t = leaf_bytes.device.type
    if t == "cpu":
        return header_proof_root_plain(leaf_bytes, leaf_len, aunts, path_bits)
    if t == "cuda":
        return header_proofs_cuda(leaf_bytes, leaf_len, aunts, path_bits)
    raise ValueError(f"no header proofs for device {leaf_bytes.device}")


# ---------------------------------------------------------------------------
# 64-bit voting-power arithmetic on (lo, hi) 32-bit pairs
# ---------------------------------------------------------------------------


def u64_add(a, b):
    lo = a[0] + b[0]
    return lo & MASK32, (a[1] + b[1] + (lo >> 32)) & MASK32


def u64_sum_masked(vp_lo: torch.Tensor, vp_hi: torch.Tensor, mask: torch.Tensor):
    """Tree-sum of masked voting powers. mask: (B,) bool/int."""
    m = mask.to(torch.int64)
    lo = vp_lo.to(torch.int64) * m
    hi = vp_hi.to(torch.int64) * m
    n = lo.shape[0]
    pad = (1 << max((n - 1).bit_length(), 0)) - n
    if pad:  # non-power-of-two lane counts (e.g. max_validators=100)
        z = torch.zeros((pad,), dtype=torch.int64, device=lo.device)
        lo, hi = torch.cat([lo, z]), torch.cat([hi, z])
        n += pad
    while n > 1:
        half = n // 2
        lo, hi = u64_add((lo[:half], hi[:half]), (lo[half:], hi[half:]))
        n = half
    return lo[0], hi[0]


def u64_mul_small(a, c: int):
    """(lo, hi) * small constant c (c <= 8). CometBFT caps the total voting
    power at i64::MAX/8, so c*vp fits in 64 bits."""
    out = (torch.zeros_like(a[0]), torch.zeros_like(a[1]))
    for _ in range(c):
        out = u64_add(out, a)
    return out


def u64_gt(a, b):
    """a > b for (lo, hi) pairs."""
    return (a[1] > b[1]) | ((a[1] == b[1]) & (a[0] > b[0]))


def voting_threshold_ok(vp_lo, vp_hi, included_mask, enabled_mask, num: int, den: int):
    """included voting power * den > total voting power * num."""
    inc = u64_sum_masked(vp_lo, vp_hi, included_mask & enabled_mask)
    tot = u64_sum_masked(vp_lo, vp_hi, enabled_mask)
    return u64_gt(u64_mul_small(inc, den), u64_mul_small(tot, num))


# ---------------------------------------------------------------------------
# Signed-message checks
# ---------------------------------------------------------------------------


def _le32(messages: torch.Tensor, start: int) -> torch.Tensor:
    """The little-endian u32 at bytes start..start+4 of every lane."""
    b = messages[:, start : start + 4].to(torch.int64)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def message_checks(
    messages: torch.Tensor,
    msg_len: torch.Tensor,
    signed: torch.Tensor,
    round_,
    expected_height,
    header_hash: torch.Tensor,
) -> torch.Tensor:
    """Per-lane checks that each signed message is a Precommit for the right
    (height, round, header hash).

    messages: (B, 124) uint8; msg_len: (B,) the byte length the signature
    covers (every checked byte must lie inside it); signed: (B,) bool;
    round_: () commit round; expected_height: (lo, hi) pair; header_hash:
    (32,) uint8. Returns (B,) bool, True where the lane is consistent
    (unsigned lanes are vacuously True)."""
    dev = messages.device
    round_ = as_tensor(round_, dev)
    msg_len = as_tensor(msg_len, dev)
    h_lo, h_hi = (as_tensor(v, dev) for v in expected_height)
    # precommit marker [8, 2] at bytes 1..2
    is_precommit = (messages[:, 1] == 8) & (messages[:, 2] == 2)
    # sfixed64 LE height at bytes 4..12
    height_ok = (_le32(messages, 4) == h_lo) & (_le32(messages, 8) == h_hi)
    # round != 0: byte 12 is the sfixed64 tag 0x19 and bytes 13..21 hold the
    # round LE; all 8 bytes are compared, so the high word must be zero,
    # which also rules out a negative round (the sign bit is in byte 20)
    round_ok = torch.where(
        round_ == 0,
        True,
        (messages[:, 12] == 0x19) & (_le32(messages, 13) == round_) & (_le32(messages, 17) == 0),
    )
    # header hash at offset 16 (round == 0) or 25 (round != 0)
    off = torch.where(round_ == 0, 16, 25)
    window = messages[:, off + torch.arange(32, device=dev)]
    hash_ok = (window == header_hash[None, :].to(dev)).all(1)
    # the hash window is the furthest byte read, and bytes beyond msg_len
    # are not signed
    len_ok = (msg_len >= off + 32) & (msg_len <= messages.shape[1])
    ok = is_precommit & height_ok & round_ok & hash_ok & len_ok
    return torch.where(signed, ok, True)


def bytes_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


# ---------------------------------------------------------------------------
# Trusted-validator intersection
# ---------------------------------------------------------------------------


def trusted_intersection_mask(
    target_pubkeys: torch.Tensor,
    target_signed: torch.Tensor,
    trusted_pubkeys: torch.Tensor,
) -> torch.Tensor:
    """For each trusted validator j: did any signing target validator i
    have the same pubkey? O(N^2) pubkey match.

    target_pubkeys: (B, 32) uint8; target_signed: (B,) bool;
    trusted_pubkeys: (B, 32) uint8. -> (B,) bool."""
    eq = (target_pubkeys[:, None, :] == trusted_pubkeys[None, :, :]).all(-1)  # (i, j)
    return (eq & target_signed[:, None]).any(0)
