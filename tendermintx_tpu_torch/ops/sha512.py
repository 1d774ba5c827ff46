"""Batched SHA-512, the Ed25519 challenge hash (witness program).

Counterpart of ``tendermintx_tpu/ops/sha512.py``. The JAX package holds a
64-bit word as a (lo, hi) pair of uint32 arrays; here each word is the
bit pattern of one int64 (two's-complement adds wrap exactly as uint64
adds do), with logical right shifts emulated by a mask. Interfaces that
expose words take and return one (..., 8) or (..., 16) int64 tensor.
``sha512_blocks`` runs the plain torch rounds for a CPU tensor and
csrc/sha.cu's kernel, one launch a call, for a CUDA tensor;
``sha512_challenge`` (the Ed25519 challenge SHA-512(R || A || M) from the
raw bytes, padding included) likewise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import sha256
from .cuda_build import operand

_K = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]

_H0 = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]


def _i64(u: int) -> int:
    """uint64 value -> the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_K_I64 = [_i64(k) for k in _K]
_H0_I64 = [_i64(h) for h in _H0]


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def _compress_block(state: list[torch.Tensor], block: torch.Tensor) -> list[torch.Tensor]:
    """state: 8 (B,) int64 words; block: (B, 16) int64 words."""
    w = list(block.unbind(-1))
    for t in range(16, 80):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _rotr(w15, 1) ^ _rotr(w15, 8) ^ _shr(w15, 7)
        s1 = _rotr(w2, 19) ^ _rotr(w2, 61) ^ _shr(w2, 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        S1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + _K_I64[t] + w[t]
        S0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, d + t1
        d, c, b, a = c, b, a, t1 + S0 + maj
    return [s + v for s, v in zip(state, (a, b, c, d, e, f, g, h))]


# incremented exactly where csrc/sha.cu's SHA-512 entry is launched
sha512_kernel_launches = 0


def sha512_blocks(blocks: torch.Tensor, n_active: torch.Tensor) -> torch.Tensor:
    """blocks: (B, n_blocks, 16) int64 words; n_active: (B,). -> (B, 8):
    the plain rounds for a CPU tensor, one csrc/sha.cu launch for a CUDA
    tensor."""
    t = blocks.device.type
    if t == "cpu":
        return sha512_blocks_plain(blocks, n_active)
    if t == "cuda":
        return sha512_blocks_cuda(blocks, n_active)
    raise ValueError(f"no SHA-512 for device {blocks.device}")


def sha512_blocks_plain(blocks: torch.Tensor, n_active: torch.Tensor) -> torch.Tensor:
    """sha512_blocks as torch ops (any device)."""
    B, n_blocks, _ = blocks.shape
    dev = blocks.device
    n_active = n_active.to(device=dev, dtype=torch.int64)
    state = [torch.full((B,), h, dtype=torch.int64, device=dev) for h in _H0_I64]
    for i in range(n_blocks):
        new = _compress_block(state, blocks[:, i, :])
        keep = i < n_active
        state = [torch.where(keep, n, s) for n, s in zip(new, state)]
    return torch.stack(state, dim=-1)


def sha512_blocks_cuda(blocks: torch.Tensor, n_active: torch.Tensor) -> torch.Tensor:
    """sha512_blocks_plain's digests by one csrc/sha.cu launch (exact on
    every int64 word): a thread a lane."""
    global sha512_kernel_launches
    out, launched = sha256.sha_blocks_cuda("tmx_sha512_blocks", blocks, n_active)
    sha512_kernel_launches += launched
    return out


def _bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """(..., 8k) byte values (int64) -> (..., k) big-endian int64 words."""
    b = b.reshape(*b.shape[:-1], -1, 8)
    out = b[..., 0]
    for j in range(1, 8):
        out = (out << 8) | b[..., j]
    return out


def bytes_to_blocks512(data: torch.Tensor, byte_len: torch.Tensor, n_blocks: int):
    """SHA-512-pad byte lanes on their device (128-byte blocks).

    data: (B, max_bytes) uint8 zero-right-padded; byte_len: (B,). The
    caller guarantees byte_len <= n_blocks*128 - 17 per lane. Returns
    (blocks (B, n_blocks, 16) int64 words, n_active (B,))."""
    B, max_bytes = data.shape
    dev = data.device
    total = n_blocks * 128
    byte_len = byte_len.to(device=dev, dtype=torch.int64)
    buf = torch.zeros((B, total), dtype=torch.int64, device=dev)
    buf[:, :max_bytes] = data.to(torch.int64)
    idx = torch.arange(total, device=dev)[None, :]
    buf = torch.where(idx < byte_len[:, None], buf, 0)
    buf = torch.where(idx == byte_len[:, None], 0x80, buf)
    n_active = (byte_len + 17 + 127) // 128
    bitlen = byte_len * 8
    # 16-byte big-endian length field; only its last 4 bytes can be nonzero
    last = n_active * 128 - 4
    rows = torch.arange(B, device=dev)
    for k in range(4):
        buf[rows, last + k] = (bitlen >> (8 * (3 - k))) & 0xFF
    return _bytes_to_words(buf).reshape(B, n_blocks, 16), n_active


def sha512_bytes_var(data: torch.Tensor, byte_len: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Variable-length SHA-512 of byte lanes -> (B, 8) int64 words."""
    blocks, n_active = bytes_to_blocks512(data, byte_len, n_blocks)
    return sha512_blocks(blocks, n_active)


def digest_words_to_bytes_dev(words: torch.Tensor) -> torch.Tensor:
    """(B, 8) int64 words -> (B, 64) uint8 big-endian digest bytes."""
    shifts = torch.arange(56, -8, -8, device=words.device)
    return ((words[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(words.shape[0], 64)


# ---------------------------------------------------------------------------
# The Ed25519 challenge: SHA-512(R || A || M) from the raw bytes
# ---------------------------------------------------------------------------

# incremented exactly where csrc/sha.cu's challenge entry is launched
sha512_challenge_kernel_launches = 0
# the widest message rows the kernel takes: a block's 32 rows, staged in
# shared memory beside its two schedule slots, fit Hopper's 227 KB
CHALLENGE_MAX_WIDTH = 4096


def challenge_blocks(width: int) -> int:
    """SHA-512 blocks of R || A || M for message rows of `width` bytes."""
    return (64 + width + 17 + 127) // 128


def challenge_byte_len(msg_len: torch.Tensor, width: int) -> torch.Tensor:
    """64 + msg_len clamped into bytes_to_blocks512's contract [0,
    128 n_blocks - 17]: within it, the reference's byte length (the bytes
    past the width zeros, a negative msg_len a prefix of R || A)."""
    cap = 128 * challenge_blocks(width) - 17
    return torch.clamp(msg_len.to(torch.int64), -64, cap - 64) + 64


def sha512_challenge(sig_r: torch.Tensor, sig_pk: torch.Tensor, messages: torch.Tensor,
                     msg_len: torch.Tensor) -> torch.Tensor:
    """SHA-512(R || A || M) of each lane: sig_r, sig_pk (B, 32) and messages
    (B, W) uint8, msg_len (B,) (clamped as challenge_byte_len clamps it).
    -> (B, 64) uint8 digest bytes: the plain composition for a CPU tensor,
    one csrc/sha.cu launch for a CUDA tensor."""
    t = sig_r.device.type
    if t == "cpu":
        return sha512_challenge_plain(sig_r, sig_pk, messages, msg_len)
    if t == "cuda":
        return sha512_challenge_cuda(sig_r, sig_pk, messages, msg_len)
    raise ValueError(f"no SHA-512 challenge for device {sig_r.device}")


def sha512_challenge_plain(sig_r, sig_pk, messages, msg_len) -> torch.Tensor:
    """sha512_challenge as torch ops (any device): the reference's byte
    assembly (tendermintx_tpu/ops/ed25519.py:533-536) over
    sha512_blocks_plain."""
    n_blocks = challenge_blocks(int(messages.shape[1]))
    data = torch.cat([sig_r, sig_pk, messages], dim=1)
    blocks, n_active = bytes_to_blocks512(data, challenge_byte_len(msg_len, int(messages.shape[1])), n_blocks)
    return digest_words_to_bytes_dev(sha512_blocks_plain(blocks, n_active))


class _ChallengeArgs(ctypes.Structure):
    """csrc/sha.cu's ChallengeArgs, field for field."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in ("sig_r", "sig_pk", "messages", "msg_len")),
        ("lanes", ctypes.c_int64), ("width", ctypes.c_int64), ("out", ctypes.c_void_p),
    ]


def sha512_challenge_cuda(sig_r, sig_pk, messages, msg_len) -> torch.Tensor:
    """sha512_challenge_plain's digests by one csrc/sha.cu launch, on every
    int64 msg_len: contiguous uint8 (B, 32) sig_r and sig_pk, (B, W)
    messages (W at most CHALLENGE_MAX_WIDTH) and int64 (B,) msg_len on one
    card, else raise. 32 lanes a block of two warps: one pads the lanes'
    streams and expands their schedules into shared memory ahead of the
    other's rounds."""
    global sha512_challenge_kernel_launches
    fn = "sha512_challenge_cuda"
    dev = sig_r.device
    if dev.type != "cuda":
        raise TypeError(f"{fn} hashes on a card, got {dev}")
    if messages.dim() != 2 or not 0 <= messages.shape[1] <= CHALLENGE_MAX_WIDTH:
        raise ValueError(f"{fn}: messages must be (B, W) with W <= {CHALLENGE_MAX_WIDTH}, "
                         f"got {tuple(messages.shape)}")
    B, W = int(messages.shape[0]), int(messages.shape[1])
    ptrs = [operand(t, dev, torch.uint8, shape, f"{fn}'s {name}")
            for t, shape, name in ((sig_r, (B, 32), "sig_r"), (sig_pk, (B, 32), "sig_pk"),
                                   (messages, (B, W), "messages"))]
    ptrs.append(operand(msg_len, dev, torch.int64, (B,), f"{fn}'s msg_len"))
    out = torch.empty((B, 64), dtype=torch.uint8, device=dev)
    if B:
        sha256.sha_launch("tmx_sha512_challenge", _ChallengeArgs(*ptrs, lanes=B, width=W, out=out.data_ptr()), dev)
        sha512_challenge_kernel_launches += 1
    return out


def pad_messages(msgs: list[bytes], n_blocks: int | None = None, device=None):
    """SHA-512-pad; returns (blocks (B, n_blocks, 16) int64, n_active)."""
    padded = []
    for m in msgs:
        bitlen = len(m) * 8
        p = m + b"\x80"
        while (len(p) + 16) % 128:
            p += b"\x00"
        p += bitlen.to_bytes(16, "big")
        padded.append(p)
    max_blocks = max(len(p) // 128 for p in padded)
    if n_blocks is None:
        n_blocks = max_blocks
    if n_blocks < max_blocks:
        raise ValueError(f"messages need {max_blocks} blocks, got n_blocks={n_blocks}")
    blocks = np.zeros((len(msgs), n_blocks, 16), dtype=np.int64)
    n_active = np.zeros((len(msgs),), dtype=np.int64)
    for i, p in enumerate(padded):
        nb = len(p) // 128
        n_active[i] = nb
        words = np.frombuffer(p, dtype=">u8").astype(np.uint64)
        blocks[i, :nb] = words.view(np.int64).reshape(nb, 16)
    return torch.from_numpy(blocks).to(device), torch.from_numpy(n_active).to(device)


def digests_to_bytes(digests: torch.Tensor) -> list[bytes]:
    words = digests.cpu().numpy().view(np.uint64)
    return [words[i].astype(">u8").tobytes() for i in range(words.shape[0])]


def sha512_many(msgs: list[bytes], n_blocks: int | None = None, *, device) -> list[bytes]:
    blocks, n_active = pad_messages(msgs, n_blocks, device)
    return digests_to_bytes(sha512_blocks(blocks, n_active))
