"""The Ed25519 challenge SHA-512(R || A || M) of the witness programs
(ops/sha512.py: sha512_challenge, csrc/sha.cu's tmx_sha512_challenge)
against the JAX package, on the CPU.

The plain twin is the reference's byte assembly in verify_bound
(tendermintx_tpu/ops/ed25519.py:536-541: concatenation, sha512.py:160
bytes_to_blocks512, :143 sha512_blocks, :193 digest_words_to_bytes_dev)
with the byte length clamped into bytes_to_blocks512's contract; it is
held equal to that composition and to hashlib at every edge length. The
kernel's padding (its stream words, the last active block's length word,
the blocks a 32-lane block runs) is modelled in numpy and held equal to the
reference's padded blocks. The port's verify_bound is held equal to the
JAX package's on honest lanes, tampered ones and edited lengths. Exact
equality throughout."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_witness import _t, ladder_inputs  # noqa: F401  (the witness fixture)

from tendermintx_tpu.ops import ed25519 as jed
from tendermintx_tpu.ops import sha512 as jsha512
from tendermintx_tpu_torch.ops import ed25519 as ed
from tendermintx_tpu_torch.ops import sha512

W = 124  # circuits/variables.py: a signed message's row
N_BLOCKS = sha512.challenge_blocks(W)
CAP = 128 * N_BLOCKS - 81  # the largest msg_len inside bytes_to_blocks512's contract
LANES = 5


@pytest.fixture(scope="module")
def reference():
    """The reference's challenge composition, jitted once for (LANES, W)."""

    def digest(data, byte_len):
        lo, hi = jsha512.sha512_bytes_var(data, byte_len, N_BLOCKS)
        return jsha512.digest_words_to_bytes_dev(lo, hi)

    return jax.jit(digest)


def _lanes(seed: int, lanes: int = LANES, width: int = W):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, size=(lanes, n), dtype=np.uint8) for n in (32, 32, width))


def _hashlib(r, pk, m, n: int) -> bytes:
    """SHA-512 of R || A || M || zeros, cut at 64 + n clamped as the twin
    clamps it."""
    cap = 128 * sha512.challenge_blocks(m.shape[0]) - 81
    row = bytes(r) + bytes(pk) + bytes(m) + bytes(cap)
    return hashlib.sha512(row[: min(max(n, -64), cap) + 64]).digest()


@pytest.mark.parametrize("n", [0, 1, 47, 48, W - 1, W, -64, -1, W + 1, CAP])
def test_challenge_twin_equals_reference_and_hashlib(reference, n):
    """msg_len at the edges of [0, W] (one and two blocks) and, outside
    it, at the ends of bytes_to_blocks512's contract (-64: no byte; CAP:
    the most two blocks hold), each lane's bytes past its length random:
    the twin equals the reference's composition and hashlib."""
    r, pk, m = _lanes(n + 100)
    msg_len = np.full(LANES, n, dtype=np.int64)
    got = sha512.sha512_challenge(torch.from_numpy(r), torch.from_numpy(pk), torch.from_numpy(m),
                                  torch.from_numpy(msg_len))
    data = np.concatenate([r, pk, m], axis=1)
    # the reference takes msg_len as uint32 and adds 64: -64 .. -1 wrap to 0 .. 63
    want = np.asarray(reference(jnp.asarray(data), jnp.asarray((msg_len + 64).astype(np.uint32))))
    assert np.array_equal(got.numpy(), want)
    assert [bytes(row) for row in want] == [_hashlib(r[i], pk[i], m[i], n) for i in range(LANES)]


def test_challenge_twin_clamps_outside_the_contract():
    """Below -64 and past CAP the twin hashes as at -64 and CAP (the
    kernel clamps alike: tests/test_torch_cuda.py), so every int64 length
    has one digest; the dispatcher takes the twin on the CPU."""
    r, pk, m = (torch.from_numpy(a) for a in _lanes(7, lanes=6))
    lens = torch.tensor([-(1 << 62), -65, CAP + 1, 1 << 40, -64, CAP])
    clamped = torch.tensor([-64, -64, CAP, CAP, -64, CAP])
    got = sha512.sha512_challenge(r, pk, m, lens)
    assert torch.equal(got, sha512.sha512_challenge_plain(r, pk, m, clamped))
    assert [bytes(row.numpy()) for row in got] == [
        _hashlib(r[i].numpy(), pk[i].numpy(), m[i].numpy(), int(n)) for i, n in enumerate(clamped)]


def kernel_stream(r, pk, m, msg_len, n_blocks: int):
    """tmx_sha512_challenge_kernel's padded words, lane-parallel: the byte
    length clamped, `have` = min(len, 64 + width), word t of block b built
    from bytes 128 b + 8 t .. + 7 (R's, A's, then the message's below
    `have`, 0x80 at len, else zero; R and A end on word boundaries), the
    last active block's word 15 the bit length. -> (words (B, n_blocks, 16)
    uint64, last active block (B,))."""
    B, width = m.shape
    cap = 128 * n_blocks - 17
    ml = np.asarray(msg_len, dtype=np.int64)
    length = np.where(ml < -64, 0, np.where(ml > cap - 64, cap, ml + 64))
    have = np.minimum(length, 64 + width)
    last = (length + 17 + 127) // 128 - 1
    words = np.zeros((B, n_blocks, 16), dtype=np.uint64)
    for i in range(B):
        for b in range(n_blocks):
            for t in range(16):
                p0 = 128 * b + 8 * t
                if b == last[i] and t == 15:
                    words[i, b, t] = (int(length[i]) * 8) & 0xFFFFFFFF
                    continue
                src, off = (r[i], p0) if p0 < 32 else (pk[i], p0 - 32) if p0 < 64 else (m[i], p0 - 64)
                w = 0
                for j in range(8):
                    p = p0 + j
                    w = (w << 8) | (int(src[off + j]) if p < have[i] else 0x80 if p == length[i] else 0)
                words[i, b, t] = w
    return words, last


@pytest.mark.parametrize("width", [0, W, 300])
def test_kernel_padding_model_equals_reference_blocks(width):
    """The kernel's words equal the reference's bytes_to_blocks512 words in
    every active block, and its blocks a lane are the reference's n_active,
    for lengths across [-65, CAP + 1] at message widths 0, 124 and 300
    (three blocks)."""
    n_blocks = sha512.challenge_blocks(width)
    cap = 128 * n_blocks - 81
    lens = np.array(sorted({-65, -64, -1, 0, 1, 47, 48, 55, width - 1, width, width + 1, cap - 1, cap, cap + 1}
                           - ({width - 1} if width == 0 else set())), dtype=np.int64)
    r, pk, m = _lanes(width, lanes=len(lens), width=width)
    words, last = kernel_stream(r, pk, m, lens, n_blocks)
    byte_len = sha512.challenge_byte_len(torch.from_numpy(lens), width).numpy()
    data = np.concatenate([r, pk, m], axis=1)
    lo, hi, n_active = jsha512.bytes_to_blocks512(jnp.asarray(data), jnp.asarray(byte_len.astype(np.uint32)),
                                                  n_blocks)
    want = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    assert np.array_equal(last + 1, np.asarray(n_active))
    for i, n in enumerate(np.asarray(n_active)):
        assert np.array_equal(words[i, :n], want[i, :n])
    # the digests of the kernel's words are the twin's
    got = sha512.sha512_blocks_plain(torch.from_numpy(words.view(np.int64)), torch.from_numpy(last + 1))
    twin = sha512.sha512_challenge_plain(*(torch.from_numpy(a) for a in (r, pk, m, lens)))
    assert torch.equal(sha512.digest_words_to_bytes_dev(got), twin)


def test_verify_bound_on_cpu_equals_jax(ladder_inputs):
    """The port's verify_bound (the challenge twin inside) against the JAX
    package's on the fixture's 8 lanes (4 honest; tampered R, S, message,
    key) and copies of the honest ones whose msg_len is edited (0, W, -1,
    W + 1: the challenge changes, the binding rejects them)."""
    _, _, _, args, binding, m, mlen = ladder_inputs
    take = [0, 1, 2, 3]
    args = [np.concatenate([a, a[take]]) for a in args]
    binding = [np.concatenate([b, b[take]]) for b in binding]
    m = np.concatenate([m, m[take]])
    mlen = np.concatenate([mlen.astype(np.int64), np.array([0, W, -1, W + 1])])
    want = np.asarray(jax.jit(jed.verify_bound)(
        *(jnp.asarray(a) for a in args), *(jnp.asarray(b) for b in binding[:3]), jnp.asarray(m),
        jnp.asarray(mlen.astype(np.uint32)), jnp.asarray(binding[3])))
    got = ed.verify_bound(*(_t(a) for a in args), *(_t(b) for b in binding[:3]), torch.from_numpy(m),
                          torch.from_numpy(mlen), _t(binding[3])).numpy()
    assert got.tolist() == want.tolist() == [True] * 4 + [False] * 8
