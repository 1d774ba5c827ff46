"""Batched SHA-256 over lanes of variable-length messages (witness program).

Counterpart of ``tendermintx_tpu/ops/sha256.py``. One lane is one message;
messages are padded to a fixed number of 64-byte blocks, and a per-lane
active-block count gives the variable-length semantics inside one
fixed-shape program. Words are uint32 values held in int64 tensors.
``sha256_blocks`` runs the plain torch rounds (masked after every add: CPU
torch has no unsigned 32-bit arithmetic) for a CPU tensor and
csrc/sha.cu's kernel, one launch a call, for a CUDA tensor.
``sha_launch`` launches any of csrc/sha.cu's entries; circuits/gadgets.py
binds its validator-tree and header-proof entries.
"""

from __future__ import annotations

import ctypes
from functools import cache

import numpy as np
import torch

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)

MASK32 = 0xFFFFFFFF


def _sigma(x: torch.Tensor, r1: int, r2: int, r3: int, shift: bool) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ (rotr or shr)(x, r3) of 32-bit words.
    A word duplicated into both halves of an int64 makes every rotation
    one right shift; the bits above 32 are masked off once at the end."""
    y = x | (x << 32)
    third = (x >> r3) if shift else (y >> r3)
    return ((y >> r1) ^ (y >> r2) ^ third) & MASK32


def _compress_block(state: list[torch.Tensor], block: torch.Tensor) -> list[torch.Tensor]:
    """state: 8 (B,) word tensors; block: (B, 16) words. Returns the 8
    words after this block's 64 rounds and the feed-forward add."""
    w = list(block.unbind(-1))
    for t in range(16, 64):
        s0 = _sigma(w[t - 15], 7, 18, 3, True)
        s1 = _sigma(w[t - 2], 17, 19, 10, True)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _sigma(e, 6, 11, 25, False)
        ch = (e & f) ^ (~e & g)
        temp1 = h + S1 + ch + int(_K[t]) + w[t]
        S0 = _sigma(a, 2, 13, 22, False)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + temp1) & MASK32
        d, c, b, a = c, b, a, (temp1 + S0 + maj) & MASK32
    return [(s + v) & MASK32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


# incremented exactly where csrc/sha.cu's SHA-256 entry is launched
sha256_kernel_launches = 0


def sha256_blocks(blocks: torch.Tensor, n_active: torch.Tensor) -> torch.Tensor:
    """blocks: (B, n_blocks, 16) big-endian words (int64, values < 2^32);
    n_active: (B,) number of blocks that are part of each lane's padded
    message. Returns digests (B, 8) int64 words: the plain rounds for a
    CPU tensor, one csrc/sha.cu launch for a CUDA tensor."""
    t = blocks.device.type
    if t == "cpu":
        return sha256_blocks_plain(blocks, n_active)
    if t == "cuda":
        return sha256_blocks_cuda(blocks, n_active)
    raise ValueError(f"no SHA-256 for device {blocks.device}")


def sha256_blocks_plain(blocks: torch.Tensor, n_active: torch.Tensor) -> torch.Tensor:
    """sha256_blocks as torch ops (any device): every block compressed, the
    state kept where the block is active."""
    B, n_blocks, _ = blocks.shape
    dev = blocks.device
    blocks = blocks.to(torch.int64)
    n_active = n_active.to(device=dev, dtype=torch.int64)
    state = [torch.full((B,), int(h), dtype=torch.int64, device=dev) for h in _H0]
    for i in range(n_blocks):
        new = _compress_block(state, blocks[:, i, :])
        keep = i < n_active
        state = [torch.where(keep, n, s) for n, s in zip(new, state)]
    return torch.stack(state, dim=-1)


class _ShaArgs(ctypes.Structure):
    """csrc/sha.cu's ShaArgs, field for field."""

    _fields_ = [
        ("blocks", ctypes.c_void_p), ("n_active", ctypes.c_void_p),
        ("lanes", ctypes.c_int64), ("n_blocks", ctypes.c_int64), ("out", ctypes.c_void_p),
    ]


@cache
def _sha_library():
    from .cuda_build import load_library

    lib = load_library("sha")
    for fn in ("tmx_sha256_blocks", "tmx_sha512_blocks", "tmx_sha512_challenge", "tmx_sha256_validator_root",
               "tmx_sha256_header_proofs"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def sha_launch(fn: str, args, dev):
    """Launch csrc/sha.cu's entry `fn` with its argument struct `args` (a
    ctypes.Structure matching the entry's) on `dev`'s current stream."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_sha_library(), fn)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


def sha_blocks_cuda(fn: str, blocks: torch.Tensor, n_active: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """(digests (B, 8) int64, launched) of csrc/sha.cu's entry `fn` over
    contiguous int64 blocks (B, n_blocks, 16) and n_active (B,) on one
    card; B = 0 launches nothing. Refuses any other operand."""
    dev = blocks.device
    if dev.type != "cuda":
        raise TypeError(f"{fn} hashes on a card, got {dev}")
    if blocks.dtype != torch.int64 or blocks.dim() != 3 or blocks.shape[2] != 16 or not blocks.is_contiguous():
        raise ValueError(f"{fn}: blocks must be a contiguous int64 (B, n_blocks, 16) tensor, "
                         f"got {blocks.dtype} {tuple(blocks.shape)}")
    B, n_blocks = int(blocks.shape[0]), int(blocks.shape[1])
    if (n_active.device != dev or n_active.dtype != torch.int64 or tuple(n_active.shape) != (B,)
            or not n_active.is_contiguous()):
        raise ValueError(f"{fn}: n_active must be a contiguous int64 ({B},) tensor on {dev}, "
                         f"got {n_active.dtype} {tuple(n_active.shape)} on {n_active.device}")
    out = torch.empty((B, 8), dtype=torch.int64, device=dev)
    if B:
        args = _ShaArgs(blocks=blocks.data_ptr(), n_active=n_active.data_ptr(), lanes=B, n_blocks=n_blocks,
                        out=out.data_ptr())
        sha_launch(fn, args, dev)
    return out, B > 0


def sha256_blocks_cuda(blocks: torch.Tensor, n_active: torch.Tensor) -> torch.Tensor:
    """sha256_blocks_plain's digests by one csrc/sha.cu launch, for words in
    [0, 2^32) (the kernel reads each word's low 32 bits): a thread a lane."""
    global sha256_kernel_launches
    out, launched = sha_blocks_cuda("tmx_sha256_blocks", blocks, n_active)
    sha256_kernel_launches += launched
    return out


# ---------------------------------------------------------------------------
# Host-side packing helpers
# ---------------------------------------------------------------------------


def pad_messages(msgs: list[bytes], n_blocks: int | None = None, device=None):
    """SHA-256-pad each message; returns (blocks (B, n_blocks, 16) int64,
    n_active (B,) int64) on `device`."""
    padded = []
    for m in msgs:
        bitlen = len(m) * 8
        p = m + b"\x80"
        while (len(p) + 8) % 64:
            p += b"\x00"
        p += bitlen.to_bytes(8, "big")
        padded.append(p)
    max_blocks = max(len(p) // 64 for p in padded)
    if n_blocks is None:
        n_blocks = max_blocks
    if n_blocks < max_blocks:
        raise ValueError(f"messages need {max_blocks} blocks, got n_blocks={n_blocks}")
    blocks = np.zeros((len(msgs), n_blocks, 16), dtype=np.int64)
    n_active = np.zeros((len(msgs),), dtype=np.int64)
    for i, p in enumerate(padded):
        nb = len(p) // 64
        n_active[i] = nb
        blocks[i, :nb] = np.frombuffer(p, dtype=">u4").reshape(nb, 16)
    return torch.from_numpy(blocks).to(device), torch.from_numpy(n_active).to(device)


def digests_to_bytes(digests: torch.Tensor) -> list[bytes]:
    arr = digests.cpu().numpy().astype(">u4")
    return [arr[i].tobytes() for i in range(arr.shape[0])]


def sha256_many(msgs: list[bytes], n_blocks: int | None = None, *, device) -> list[bytes]:
    """Hash a batch of byte strings on `device`."""
    blocks, n_active = pad_messages(msgs, n_blocks, device)
    return digests_to_bytes(sha256_blocks(blocks, n_active))
