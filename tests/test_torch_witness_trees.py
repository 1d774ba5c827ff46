"""The witness programs' Merkle gadgets (circuits/gadgets.py): the plain
twins of csrc/sha.cu's validator-tree and header-proof entries against the
JAX package's merkle_root_dynamic(hash_validator_leaves(...)) and
header_proof_root on the CPU, and their dispatchers.

Inputs are made from a seed with numpy. The validator trees cover 1, 2, 5,
8 and 16 lanes (5 padded to 8 rows, as the twin and the kernel pad it) at n_enabled 0, 1, odd, even and B, and leaf lengths from
1 to 55 bytes (one SHA-256 block); a CometBFT root computed by hashlib
(RFC 6962's split recursion) holds both. The header proofs cover leaves of
one and two blocks and path bits both ways (also a bit of 2, which is not
1 and so a left child). Exact equality throughout."""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.circuits import gadgets as jg
from tendermintx_tpu_torch.circuits import gadgets as g
from tendermintx_tpu_torch.ops import sha256

LEAF_WIDTH = 47  # circuits/variables.py: 0x00 || SimpleValidator encoding
PROOF_WIDTH = 73  # a header proof's zero-padded leaf


def _leaves(B: int, seed: int, width: int = LEAF_WIDTH, max_len: int = LEAF_WIDTH):
    """(B, width) uint8 rows of a 0x00 prefix and random bytes up to each
    row's length (1..max_len; junk past it, which the padding must mask),
    and the lengths."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, width), dtype=np.uint8)
    data[:, 0] = 0
    lens = rng.integers(1, max_len + 1, size=B).astype(np.int64)
    return data, lens


def _rfc6962_root(leaves: list[bytes]) -> bytes:
    """CometBFT's HashFromByteSlices over already-hashed leaves."""
    if len(leaves) == 1:
        return leaves[0]
    k = 1 << ((len(leaves) - 1).bit_length() - 1)
    return hashlib.sha256(b"\x01" + _rfc6962_root(leaves[:k]) + _rfc6962_root(leaves[k:])).digest()


@jax.jit
def _jax_root(leaf_bytes, leaf_len, n_enabled):
    return jg.merkle_root_dynamic(jg.hash_validator_leaves(leaf_bytes, leaf_len), n_enabled)


@pytest.mark.parametrize("B", [1, 2, 5, 8, 16])
def test_validator_root_twin_matches_jax(B):
    data, lens = _leaves(B, seed=B)
    # wider than the one-block contract allows: lengths up to 55 with the
    # row's 47 bytes and zeros past them
    lens[0] = 55 if B > 1 else lens[0]
    counts = sorted({0, 1, B, max(B - 1, 0), B // 2, (B // 2) | 1} & set(range(B + 1)))
    leaf_digests = [hashlib.sha256(bytes(data[i, : min(lens[i], LEAF_WIDTH)])
                                   + bytes(max(int(lens[i]) - LEAF_WIDTH, 0))).digest() for i in range(B)]
    for n in counts:
        want = np.asarray(_jax_root(jnp.asarray(data), jnp.asarray(lens.astype(np.int32)), jnp.int32(n)))
        got = g.validator_root(torch.from_numpy(data), torch.from_numpy(lens), torch.tensor(n))
        assert got.dtype == torch.uint8 and got.shape == (32,)
        assert got.numpy().tolist() == want.tolist(), f"B={B} n={n}"
        if B == 1:
            assert bytes(got.numpy()) == leaf_digests[0]
        elif n:
            assert bytes(got.numpy()) == _rfc6962_root(leaf_digests[:n]), f"B={B} n={n}"
        else:
            assert not got.any()
    # a Python int for n_enabled
    assert torch.equal(g.validator_root(torch.from_numpy(data), torch.from_numpy(lens), n), got)


def test_validator_root_of_the_witness_chain_is_its_validators_hash(tmp_path):
    """The N=8 skip witness's two validator sets hash to the trusted and
    target headers' validators hashes (through skip_verify's leaf
    windows)."""
    import chip_smoke
    from tendermintx_tpu_torch.circuits.variables import pack_skip_witness

    sc = chip_smoke.SkipChain(8, str(tmp_path))
    _, _, inputs = sc.skip(2, 6)
    w = pack_skip_witness(inputs)
    for lanes, nb, proof in ((w.lanes, w.nb_target_validators, w.validators_hash_proof),
                             (w.trusted_lanes, w.nb_trusted_validators, w.trusted_vh_proof)):
        root = g.validator_root(lanes.leaf_bytes, lanes.leaf_len, nb)
        assert torch.equal(root, proof.leaf_bytes[0, 3:35])
        assert torch.equal(root, g.merkle_root_dynamic(g.hash_validator_leaves(lanes.leaf_bytes, lanes.leaf_len), nb))


def _proofs(k: int, seed: int):
    data, lens = _leaves(k, seed, width=PROOF_WIDTH, max_len=PROOF_WIDTH)
    lens[0] = 119  # two blocks, the last 46 bytes past the row zero
    if k > 1:
        lens[1] = 55  # the most one block holds
    rng = np.random.default_rng(seed + 1)
    aunts = rng.integers(0, 256, size=(k, 4, 32), dtype=np.uint8)
    bits = rng.integers(0, 2, size=(k, 4)).astype(np.int64)
    bits[0] = [0, 0, 0, 0]
    if k > 1:
        bits[1] = [1, 1, 1, 1]
    if k > 2:
        bits[2] = [1, 0, 2, 1]  # 2 is not 1: a left child
    return data, lens, aunts, bits


@functools.cache
def _jax_proofs(k: int = 9):
    """k proofs (_proofs) and the JAX package's roots of them: one jit."""
    data, lens, aunts, bits = _proofs(k, seed=19)
    want = np.asarray(jax.jit(jg.header_proof_root)(
        jnp.asarray(data), jnp.asarray(lens.astype(np.int32)), jnp.asarray(aunts),
        jnp.asarray(bits.astype(np.uint32))))
    return data, lens, aunts, bits, want


@pytest.mark.parametrize("k", [1, 4, 5, 9])
def test_header_proof_twin_matches_jax_and_hashlib(k):
    """The twin over the first k of nine proofs (a proof's root depends on
    its row alone) against the JAX package's roots of all nine."""
    data, lens, aunts, bits, want = (a[:k] for a in _jax_proofs())
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (data, lens, aunts, bits)]
    got = g.header_proof_root(*args)
    assert got.dtype == torch.uint8 and got.shape == (k, 32)
    assert got.numpy().tolist() == want.tolist()
    for p in range(k):
        leaf = bytes(data[p, : min(lens[p], PROOF_WIDTH)]) + bytes(max(int(lens[p]) - PROOF_WIDTH, 0))
        node = hashlib.sha256(leaf).digest()
        for d in range(4):
            aunt = bytes(aunts[p, d])
            node = hashlib.sha256(b"\x01" + (aunt + node if bits[p, d] == 1 else node + aunt)).digest()
        assert bytes(got[p].numpy()) == node


# ---------------------------------------------------------------------------
# csrc/sha.cu's tree and proof kernels, modelled: the words they build and
# the tree's in-place levels (the compression itself is sha256_blocks')
# ---------------------------------------------------------------------------


def _kernel_message_words(row: bytes, width: int, length: int, nb: int) -> list[list[int]]:
    """sha256_bytes<NB>'s blocks: the length clamped to [0, 64 nb - 9],
    byte p the row's below it (zero past the width), 0x80 at it, the last
    active block's word 15 the bit length."""
    length = min(max(length, 0), 64 * nb - 9)
    have, active = min(length, width), (length + 72) // 64
    blocks = []
    for b in range(active):
        words = []
        for t in range(16):
            word = 0
            for j in range(4):
                p = 64 * b + 4 * t + j
                word |= (row[p] if p < have else 0x80 if p == length else 0) << (24 - 8 * j)
            words.append(word)
        if b == active - 1:
            words[15] = length * 8
        blocks.append(words)
    return blocks


def _kernel_pair_words(left: list[int], right: list[int]) -> list[list[int]]:
    """sha256_pair's two blocks from the digest words of the children."""
    first = [0x01000000 | (left[0] >> 8)] + [((left[k - 1] << 24) | (left[k] >> 8)) & 0xFFFFFFFF for k in range(1, 8)]
    first += [((left[7] << 24) | (right[0] >> 8)) & 0xFFFFFFFF]
    first += [((right[k - 1] << 24) | (right[k] >> 8)) & 0xFFFFFFFF for k in range(1, 8)]
    return [first, [((right[7] << 24) & 0xFFFFFFFF) | 0x00800000] + [0] * 14 + [65 * 8]]


def test_kernel_words_are_the_padded_messages():
    """The leaf blocks the kernels build equal bytes_to_blocks' (lengths 0
    to the cap, past the row's width too; a length outside the contract is
    clamped into it), and a pair's blocks equal the padding of 0x01 || L ||
    R."""
    rng = np.random.default_rng(7)
    for nb, width in ((1, LEAF_WIDTH), (2, PROOF_WIDTH)):
        data = rng.integers(0, 256, size=(64 * nb - 8, width), dtype=np.uint8)
        lens = np.arange(64 * nb - 8)  # 0 .. the cap
        blocks, n_active = g.bytes_to_blocks(torch.from_numpy(data), torch.from_numpy(lens), nb)
        for i, n in enumerate(lens.tolist()):
            got = _kernel_message_words(bytes(data[i]), width, n, nb)
            assert len(got) == int(n_active[i]) and got == blocks[i, : len(got)].tolist()
        assert _kernel_message_words(bytes(data[0]), width, -5, nb) == _kernel_message_words(bytes(data[0]), width, 0, nb)
        cap = 64 * nb - 9
        assert (_kernel_message_words(bytes(data[0]), width, 10**6, nb)
                == _kernel_message_words(bytes(data[0]), width, cap, nb))
    for seed in range(4):
        l, r = (np.random.default_rng(seed + k).integers(0, 256, 32, dtype=np.uint8).tobytes() for k in (0, 9))
        words = lambda d: [int.from_bytes(d[4 * k: 4 * k + 4], "big") for k in range(8)]
        blocks, _ = sha256.pad_messages([b"\x01" + l + r])
        assert _kernel_pair_words(words(l), words(r)) == blocks[0].tolist()


def _kernel_root(leaf_digests: list[bytes], n: int) -> bytes:
    """tmx_sha256_root_kernel's levels: B' threads, the padding rows zero,
    node i of the next level H(node 2i, node 2i + 1) for i < n >> 1 (and
    below half), node min(n - 1, size - 1) promoted at i = n >> 1 when n & 1,
    else zeros, written in place after every thread's read."""
    Bp = 1 << max(len(leaf_digests) - 1, 0).bit_length()
    node = list(leaf_digests) + [bytes(32)] * (Bp - len(leaf_digests))
    size = Bp
    while size > 1:
        half, pairs, odd = size >> 1, n >> 1, n & 1
        new = []
        for i in range(half):
            if i < pairs:
                new.append(hashlib.sha256(b"\x01" + node[2 * i] + node[2 * i + 1]).digest())
            elif i == pairs and odd:
                new.append(node[min(n - 1, size - 1)])
            else:
                new.append(bytes(32))
        node[:half] = new
        n = pairs + odd
        size = half
    return node[0]


@pytest.mark.parametrize("B", [1, 3, 5, 8])
def test_kernel_tree_levels_equal_the_twin(B):
    """The kernel's level loop equals the twin at every n_enabled the twin
    takes, -3 to B' (negative counts floor as torch's do); past B' the
    kernel clamps the promoted row, which the twin cannot index."""
    data, lens = _leaves(B, seed=20 + B)
    leaves = g.hash_validator_leaves(torch.from_numpy(data), torch.from_numpy(lens))
    digests = [bytes(d) for d in leaves.numpy()]
    Bp = 1 << max(B - 1, 0).bit_length()
    for n in range(-3, Bp + 1):
        want = g.merkle_root_dynamic(leaves, n)  # the twin's levels over its leaves
        assert _kernel_root(digests, n) == bytes(want.numpy()), f"B={B} n={n}"
    assert len(_kernel_root(digests, 4 * Bp + 1)) == 32


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _launches():
    return (sha256.sha256_kernel_launches, g.validator_root_kernel_launches, g.header_proofs_kernel_launches)


def test_cpu_tensors_take_the_twins_and_count_no_launch(monkeypatch):
    data, lens = _leaves(5, seed=3)
    pdata, plens, aunts, bits = (torch.from_numpy(a) for a in _proofs(3, seed=4))
    calls = []
    for name in ("validator_root_plain", "header_proof_root_plain"):
        twin = getattr(g, name)
        monkeypatch.setattr(g, name, lambda *a, twin=twin, name=name: calls.append(name) or twin(*a))
    before = _launches()
    g.validator_root(torch.from_numpy(data), torch.from_numpy(lens), 3)
    g.header_proof_root(pdata, plens, aunts, bits)
    assert calls == ["validator_root_plain", "header_proof_root_plain"]
    assert _launches() == before == (0, 0, 0)


@pytest.mark.parametrize("fn", ["validator_root", "header_proof_root"])
def test_dispatchers_refuse_other_devices(fn):
    meta = lambda *shape, dtype=torch.int64: torch.empty(shape, dtype=dtype, device="meta")
    call = {
        "validator_root": lambda: g.validator_root(meta(4, LEAF_WIDTH, dtype=torch.uint8), meta(4), meta()),
        "header_proof_root": lambda: g.header_proof_root(meta(2, PROOF_WIDTH, dtype=torch.uint8), meta(2),
                                                         meta(2, 4, 32, dtype=torch.uint8), meta(2, 4)),
    }[fn]
    before = _launches()
    with pytest.raises(ValueError):
        call()
    assert _launches() == before


def test_card_wrappers_refuse_cpu_tensors():
    """The card entries take CUDA tensors only: a CPU tensor is refused
    before any library is loaded (no nvcc here)."""
    data, lens = (torch.from_numpy(a) for a in _leaves(4, seed=5))
    pdata, plens, aunts, bits = (torch.from_numpy(a) for a in _proofs(2, seed=6))
    with pytest.raises(TypeError):
        g.validator_root_cuda(data, lens, torch.tensor(2))
    with pytest.raises(TypeError):
        g.header_proofs_cuda(pdata, plens, aunts, bits)
