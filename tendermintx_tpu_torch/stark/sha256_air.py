"""Batched multi-block SHA-256 compression AIR.

Counterpart of ``tendermintx_tpu/stark/sha256_air.py`` (the constraint
program is algebra-generic and unchanged; the trace generator returns a torch
``GF`` on a chosen device). The trace is a sequence of
64-row segments, one compression each; all selectors have period 64, so the
same constraints govern every segment. Segments chain: a segment may either
start from the standard IV or continue from the previous segment's digest
(Merkle-Damgård chaining), so messages longer than one block — validator
messages (~120 B) and 65-byte Merkle inner nodes — prove too.

Per row t of a segment: bits of schedule word w(t) and of the state words
a(t), e(t) produced BY round t (b..d / f..h live on earlier rows), plus
carry bits for the modular additions. Rows 0..3 additionally hold the bits
of the segment's IV words (a-side in IVA, e-side in IVE): round t reads
A[t-j]; for t-j < 0 that resolves to IVA row (j-t-1). 170 columns.

Public inputs per segment: 16 message words ‖ 8 digest words ‖ chain flag.
They are bound through four *public columns* (verifier-interpolated,
uncommitted): pc_a / pc_b carry message words (rows 0..15) and digest words
(rows 60..63); pc_iv_a / pc_iv_e carry the IV words — the standard H
constants when chain = 0, the previous segment's digest publics when
chain = 1 — at rows 0..3 (forward order, for the IV bit binding) and rows
60..63 (reversed, for the digest addition).
"""

from __future__ import annotations

import numpy as np

from ..ops.goldilocks import GF
from ..ops.sha256 import _H0, _K
from .air import Air, Frame

SEGMENT = 64
# column layout
COL_W = 0
COL_A = 32
COL_E = 64
COL_CW = 96  # 2 schedule-carry bits
COL_CE = 98  # 3 new_e carry bits
COL_CA = 101  # 3 new_a carry bits
COL_CDIG_A = 104  # digest carry (a..d side), rows 60..63
COL_CDIG_E = 105  # digest carry (e..h side), rows 60..63
COL_IVA = 106  # IV bits, a-side: row r (0..3) holds bits of IV[r]
COL_IVE = 138  # IV bits, e-side: row r (0..3) holds bits of IV[4+r]
N_COLS = 170

PUB_PER_SEGMENT = 25  # 16 msg words + 8 digest words + chain flag

H = [int(x) for x in _H0]
K = [int(x) for x in _K]


def _bits(v: int) -> list[int]:
    return [(v >> i) & 1 for i in range(32)]


class Sha256Air(Air):
    """One or more (optionally chained) SHA-256 compressions; construct with
    the segment count."""

    n_cols = N_COLS
    n_public_cols = 4
    constraint_degree = 4
    frame_offsets = [0, 1, 2, 3, 4, 9, 14, 16]

    def __init__(self, n_blocks: int = 1):
        self.n_blocks = n_blocks
        self.n_public = PUB_PER_SEGMENT * n_blocks

    def cache_key(self):
        return (self.n_blocks,)

    # -- periodic selectors ---------------------------------------------------

    def periodic_columns(self):
        sel_main = [1 if s < 60 else 0 for s in range(SEGMENT)]
        sel_sched = [1 if s < 48 else 0 for s in range(SEGMENT)]
        sel_init = [1 if s == 0 else 0 for s in range(SEGMENT)]
        sel_msg = [1 if s < 16 else 0 for s in range(SEGMENT)]
        sel_dig = [1 if 60 <= s else 0 for s in range(SEGMENT)]
        sel_iv = [1 if s < 4 else 0 for s in range(SEGMENT)]
        k_shift = [K[(s + 4) % SEGMENT] for s in range(SEGMENT)]
        return [
            sel_main, sel_sched, sel_init, sel_msg, sel_dig, sel_iv, k_shift,
        ]

    # -- public-input validation (untrusted proofs) ---------------------------

    def validate_publics(self, publics) -> bool:
        if len(publics) != self.n_public:
            return False
        for s in range(self.n_blocks):
            base = PUB_PER_SEGMENT * s
            words = publics[base : base + 24]
            if any(not (0 <= int(v) < (1 << 32)) for v in words):
                return False
            chain = int(publics[base + 24])
            if chain not in (0, 1):
                return False
            if s == 0 and chain != 0:
                return False
        return True

    # -- public columns -------------------------------------------------------

    def _segment_ivs(self, publics):
        """Per-segment IV words (8 each), derived from the chain flags."""
        ivs = []
        for s in range(self.n_blocks):
            base = PUB_PER_SEGMENT * s
            chain = int(publics[base + 24])
            if chain == 0:
                ivs.append(list(H))
            else:
                prev = PUB_PER_SEGMENT * (s - 1)
                ivs.append([int(v) for v in publics[prev + 16 : prev + 24]])
        return ivs

    def public_columns(self, publics, n_rows):
        assert n_rows == SEGMENT * self.n_blocks
        assert self.validate_publics(publics), "invalid public inputs"
        pc_a = [0] * n_rows
        pc_b = [0] * n_rows
        pc_iv_a = [0] * n_rows
        pc_iv_e = [0] * n_rows
        ivs = self._segment_ivs(publics)
        for s in range(self.n_blocks):
            base = PUB_PER_SEGMENT * s
            msg = publics[base : base + 16]
            digest = publics[base + 16 : base + 24]
            iv = ivs[s]
            for i in range(16):
                pc_a[SEGMENT * s + i] = msg[i]
            for r in range(4):
                pc_a[SEGMENT * s + 60 + r] = digest[3 - r]
                pc_b[SEGMENT * s + 60 + r] = digest[7 - r]
                pc_iv_a[SEGMENT * s + r] = iv[r]
                pc_iv_e[SEGMENT * s + r] = iv[4 + r]
                pc_iv_a[SEGMENT * s + 60 + r] = iv[3 - r]
                pc_iv_e[SEGMENT * s + 60 + r] = iv[7 - r]
        return [pc_a, pc_b, pc_iv_a, pc_iv_e]

    # -- helpers over the algebra (vectorized: a 32-bit word is one k=32
    # stacked vector, so σ/Σ/ch/maj are single wide array ops) --------------

    WEIGHTS = [1 << i for i in range(32)]

    @classmethod
    def _val(cls, vec, alg):
        return alg.weighted_sum(vec, cls.WEIGHTS)

    @staticmethod
    def _xor2(x, y, alg):
        # x + y - 2xy
        return x + y - alg.vcmul(2, x * y)

    @classmethod
    def _xor3(cls, x, y, z, alg):
        # two chained xor2 (degree 3)
        return cls._xor2(cls._xor2(x, y, alg), z, alg)

    @staticmethod
    def _ch(e, f, g, alg):
        return g + e * (f - g)

    @staticmethod
    def _maj(a, b, c, alg):
        ab = a * b
        return ab + c * (a + b) - alg.vcmul(2, ab * c)

    @classmethod
    def _sigma0_small(cls, v, alg):
        return cls._xor3(alg.rot(v, 7), alg.rot(v, 18), alg.shift_down(v, 3), alg)

    @classmethod
    def _sigma1_small(cls, v, alg):
        return cls._xor3(alg.rot(v, 17), alg.rot(v, 19), alg.shift_down(v, 10), alg)

    @classmethod
    def _Sigma0(cls, v, alg):
        return cls._xor3(alg.rot(v, 2), alg.rot(v, 13), alg.rot(v, 22), alg)

    @classmethod
    def _Sigma1(cls, v, alg):
        return cls._xor3(alg.rot(v, 6), alg.rot(v, 11), alg.rot(v, 25), alg)

    def _cols(self, frame: Frame, offset: int, start: int, count: int, alg):
        return alg.col_range(frame, self.frame_offsets.index(offset), start, count)

    def _felt(self, frame: Frame, offset: int, col: int):
        return frame.at_offset(offset, self)[col]

    def _a_bits(self, frame, m, alg):
        if m < 0:
            # A[m] for m in -1..-4 is IV word (-m)-1, whose bits live in the
            # IVA columns of row (-m)-1 of the segment
            return self._cols(frame, (-m) - 1, COL_IVA, 32, alg)
        return self._cols(frame, m, COL_A, 32, alg)

    def _e_bits(self, frame, m, alg):
        if m < 0:
            return self._cols(frame, (-m) - 1, COL_IVE, 32, alg)
        return self._cols(frame, m, COL_E, 32, alg)

    # -- constraints ----------------------------------------------------------

    def eval_cyclic(self, frame: Frame, alg):
        (
            sel_main, sel_sched, sel_init, sel_msg, sel_dig, sel_iv, k_shift,
        ) = frame.periodic
        pc_a, pc_b, pc_iv_a, pc_iv_e = frame.public_cols
        out = []

        # 1. booleanity of every column (all are bits): one stacked op
        all_cols = alg.col_range(frame, 0, 0, N_COLS)
        bool_vec = all_cols * all_cols - all_cols
        out.extend(alg.unstack(bool_vec))

        # 2. message binding: rows 0..15 of each segment
        w_val0 = self._val(self._cols(frame, 0, COL_W, 32, alg), alg)
        out.append(sel_msg * (w_val0 - pc_a))

        # 3. IV binding: rows 0..3, the committed IV bits must recompose to
        #    the public-column IV words (H constants or the previous
        #    segment's digest publics, per the chain flag)
        iva_val = self._val(self._cols(frame, 0, COL_IVA, 32, alg), alg)
        ive_val = self._val(self._cols(frame, 0, COL_IVE, 32, alg), alg)
        out.append(sel_iv * (iva_val - pc_iv_a))
        out.append(sel_iv * (ive_val - pc_iv_e))

        # 4. schedule recurrence: w(s+16) = σ1(w(s+14)) + w(s+9) +
        #    σ0(w(s+1)) + w(s)  (carries at row s+16)
        w0 = self._cols(frame, 0, COL_W, 32, alg)
        w1 = self._cols(frame, 1, COL_W, 32, alg)
        w9 = self._cols(frame, 9, COL_W, 32, alg)
        w14 = self._cols(frame, 14, COL_W, 32, alg)
        w16 = self._cols(frame, 16, COL_W, 32, alg)
        lhs = (
            self._val(self._sigma1_small(w14, alg), alg)
            + self._val(w9, alg)
            + self._val(self._sigma0_small(w1, alg), alg)
            + self._val(w0, alg)
        )
        carry = self._felt(frame, 16, COL_CW) + alg.cmul(
            2, self._felt(frame, 16, COL_CW + 1)
        )
        out.append(
            sel_sched * (lhs - self._val(w16, alg) - alg.cmul(1 << 32, carry))
        )

        # 5. generic round t = s+4 (anchor s)
        out.extend(
            self._round_constraints(
                frame, alg, sel_main, t_rel=4, k_val=k_shift,
            )
        )

        # 6. initial rounds t = 0..3 (anchor row 0): negative round indices
        #    resolve to the committed IV bits
        for t in range(4):
            out.extend(
                self._round_constraints(
                    frame, alg, sel_init, t_rel=t, k_val=alg.const(K[t]),
                )
            )

        # 7. digest binding on rows 60..63: IV word + state word =
        #    digest + c*2^32 (the IV word comes from the public column, in
        #    reversed order)
        a_val0 = self._val(self._cols(frame, 0, COL_A, 32, alg), alg)
        e_val0 = self._val(self._cols(frame, 0, COL_E, 32, alg), alg)
        cdig_a = frame.rows[0][COL_CDIG_A]
        cdig_e = frame.rows[0][COL_CDIG_E]
        out.append(sel_dig * (pc_iv_a + a_val0 - pc_a - alg.cmul(1 << 32, cdig_a)))
        out.append(sel_dig * (pc_iv_e + e_val0 - pc_b - alg.cmul(1 << 32, cdig_e)))
        return out

    def _round_constraints(self, frame, alg, sel, t_rel, k_val):
        a_in = self._a_bits(frame, t_rel - 1, alg)
        b = self._a_bits(frame, t_rel - 2, alg)
        c = self._a_bits(frame, t_rel - 3, alg)
        d_bits = self._a_bits(frame, t_rel - 4, alg)
        e_in = self._e_bits(frame, t_rel - 1, alg)
        f = self._e_bits(frame, t_rel - 2, alg)
        g = self._e_bits(frame, t_rel - 3, alg)
        h_bits = self._e_bits(frame, t_rel - 4, alg)

        w_bits = self._cols(frame, t_rel, COL_W, 32, alg)
        new_a = self._val(self._cols(frame, t_rel, COL_A, 32, alg), alg)
        new_e = self._val(self._cols(frame, t_rel, COL_E, 32, alg), alg)
        ce = [self._felt(frame, t_rel, COL_CE + j) for j in range(3)]
        ca = [self._felt(frame, t_rel, COL_CA + j) for j in range(3)]

        t1 = (
            self._val(h_bits, alg)
            + self._val(self._Sigma1(e_in, alg), alg)
            + self._val(self._ch(e_in, f, g, alg), alg)
            + k_val
            + self._val(w_bits, alg)
        )
        t2 = self._val(self._Sigma0(a_in, alg), alg) + self._val(
            self._maj(a_in, b, c, alg), alg
        )
        carry_e = ce[0] + alg.cmul(2, ce[1]) + alg.cmul(4, ce[2])
        carry_a = ca[0] + alg.cmul(2, ca[1]) + alg.cmul(4, ca[2])
        c_new_e = self._val(d_bits, alg) + t1 - new_e - alg.cmul(1 << 32, carry_e)
        c_new_a = t1 + t2 - new_a - alg.cmul(1 << 32, carry_a)
        return [sel * c_new_e, sel * c_new_a]


# ---------------------------------------------------------------------------
# Trace generation (host, numpy-vectorized over segments)
# ---------------------------------------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)


def _rotr_np(x, r):
    return ((x >> np.uint64(r)) | (x << np.uint64(32 - r))) & _M32


def _compress_batch(msg_words: np.ndarray, iv: np.ndarray):
    """Vectorized compression of B blocks with per-block IVs.

    msg_words: (B, 16) uint64 (values < 2^32); iv: (B, 8) uint64.
    Returns (w, cw, A, E, ce, ca, digest, cdig_a, cdig_e) — all uint64
    numpy arrays; A/E are (B, 64) round outputs, carries as in the AIR."""
    B = msg_words.shape[0]
    w = np.zeros((B, 64), dtype=np.uint64)
    cw = np.zeros((B, 64), dtype=np.uint64)
    w[:, :16] = msg_words
    for t in range(16, 64):
        x15 = w[:, t - 15]
        x2 = w[:, t - 2]
        s0 = _rotr_np(x15, 7) ^ _rotr_np(x15, 18) ^ (x15 >> np.uint64(3))
        s1 = _rotr_np(x2, 17) ^ _rotr_np(x2, 19) ^ (x2 >> np.uint64(10))
        full = w[:, t - 16] + s0 + w[:, t - 7] + s1
        w[:, t] = full & _M32
        cw[:, t] = full >> np.uint64(32)

    A = np.zeros((B, 68), dtype=np.uint64)  # A[:, 4+t] = round-t output
    E = np.zeros((B, 68), dtype=np.uint64)
    A[:, 3::-1] = iv[:, :4]  # A[:, 3]=iv0, A[:, 2]=iv1, ...
    E[:, 3::-1] = iv[:, 4:]
    ce = np.zeros((B, 64), dtype=np.uint64)
    ca = np.zeros((B, 64), dtype=np.uint64)
    K64 = np.array(K, dtype=np.uint64)
    for t in range(64):
        a_in, b, c, d = A[:, t + 3], A[:, t + 2], A[:, t + 1], A[:, t]
        e_in, f, g, h = E[:, t + 3], E[:, t + 2], E[:, t + 1], E[:, t]
        S1 = _rotr_np(e_in, 6) ^ _rotr_np(e_in, 11) ^ _rotr_np(e_in, 25)
        ch = (e_in & f) ^ (~e_in & g & _M32)
        t1 = h + S1 + ch + K64[t] + w[:, t]
        S0 = _rotr_np(a_in, 2) ^ _rotr_np(a_in, 13) ^ _rotr_np(a_in, 22)
        maj = (a_in & b) ^ (a_in & c) ^ (b & c)
        full_e = d + t1
        E[:, t + 4] = full_e & _M32
        ce[:, t] = full_e >> np.uint64(32)
        full_a = t1 + S0 + maj
        A[:, t + 4] = full_a & _M32
        ca[:, t] = full_a >> np.uint64(32)

    digest = np.zeros((B, 8), dtype=np.uint64)
    cdig_a = np.zeros((B, 4), dtype=np.uint64)
    cdig_e = np.zeros((B, 4), dtype=np.uint64)
    for i in range(4):
        full = iv[:, i] + A[:, 67 - i]
        digest[:, i] = full & _M32
        cdig_a[:, 3 - i] = full >> np.uint64(32)  # stored at row 60 + (3-i)
        full = iv[:, 4 + i] + E[:, 67 - i]
        digest[:, 4 + i] = full & _M32
        cdig_e[:, 3 - i] = full >> np.uint64(32)
    return w, cw, A[:, 4:], E[:, 4:], ce, ca, digest, cdig_a, cdig_e


def sha256_batch_trace(blocks: list[bytes], chain: list[int] | None = None, device=None):
    """blocks: list of 64-byte blocks; chain[s] = 1 means block s continues
    the compression of block s-1 (same message), 0 means it starts fresh
    from the standard IV. Returns (trace_cols GF (170, 64*B) on `device`,
    publics (25*B ints: msg words ‖ digest words ‖ chain flag per
    segment))."""
    B = len(blocks)
    if chain is None:
        chain = [0] * B
    assert len(chain) == B and (B == 0 or chain[0] == 0)
    msg_words = np.zeros((B, 16), dtype=np.uint64)
    for s, block in enumerate(blocks):
        assert len(block) == 64
        msg_words[s] = np.frombuffer(block, dtype=">u4").astype(np.uint64)

    # resolve per-segment IVs sequentially (chained segments need the
    # previous digest); compress run-by-run, vectorized within each run of
    # equal chain depth — in practice we just iterate chain positions
    iv = np.zeros((B, 8), dtype=np.uint64)
    H64 = np.array(H, dtype=np.uint64)
    results = [None] * B
    pending = [s for s in range(B) if chain[s] == 0]
    for s in pending:
        iv[s] = H64
    pos = 0
    todo = list(range(B))
    while todo:
        # all segments whose IV is known can compress together
        ready = [s for s in todo if chain[s] == 0 or results[s - 1] is not None]
        assert ready, "chain flags form no valid schedule"
        batch = _compress_batch(msg_words[ready], iv[ready])
        for bi, s in enumerate(ready):
            results[s] = tuple(arr[bi] for arr in batch)
            if s + 1 < B and chain[s + 1] == 1:
                iv[s + 1] = batch[6][bi]  # digest
        todo = [s for s in todo if results[s] is None]
        pos += 1

    # assemble the trace: vectorized bit extraction
    rows = np.zeros((SEGMENT * B, N_COLS), dtype=np.uint32)
    publics = []
    t_idx = np.arange(64)
    bit_idx = np.arange(32, dtype=np.uint64)
    for s in range(B):
        w, cw, A, E, ce, ca, digest, cdig_a, cdig_e = results[s]
        base = SEGMENT * s
        seg = rows[base : base + 64]
        seg[:, COL_W : COL_W + 32] = (w[:, None] >> bit_idx[None, :]) & 1
        seg[:, COL_A : COL_A + 32] = (A[:, None] >> bit_idx[None, :]) & 1
        seg[:, COL_E : COL_E + 32] = (E[:, None] >> bit_idx[None, :]) & 1
        seg[:, COL_CW] = cw & 1
        seg[:, COL_CW + 1] = (cw >> np.uint64(1)) & 1
        for j in range(3):
            seg[:, COL_CE + j] = (ce >> np.uint64(j)) & 1
            seg[:, COL_CA + j] = (ca >> np.uint64(j)) & 1
        seg[60:64, COL_CDIG_A] = cdig_a
        seg[60:64, COL_CDIG_E] = cdig_e
        seg[:4, COL_IVA : COL_IVA + 32] = (iv[s, :4, None] >> bit_idx[None, :]) & 1
        seg[:4, COL_IVE : COL_IVE + 32] = (iv[s, 4:, None] >> bit_idx[None, :]) & 1
        publics.extend(int(v) for v in msg_words[s])
        publics.extend(int(v) for v in digest)
        publics.append(int(chain[s]))
    return GF.from_small(rows.T, device), publics


def sha256_publics(blocks: list[bytes], chain: list[int] | None = None) -> list[int]:
    """The publics sha256_batch_trace would emit, WITHOUT building the
    trace: per segment 16 message words + 8 (chained) digest words + the
    chain flag. A deterministic host computation over the blocks, mirroring
    sha512_air.sha512_publics — the composite wire (v4) drops the hash
    statement's publics and rebuilds them here from the plan's free data
    at deserialization time."""
    B = len(blocks)
    if chain is None:
        chain = [0] * B
    if len(chain) != B or (B and chain[0] != 0):
        raise ValueError("chain flags form no valid schedule")
    msg_words = np.zeros((B, 16), dtype=np.uint64)
    for s, block in enumerate(blocks):
        if len(block) != 64:
            raise ValueError("SHA-256 block must be 64 bytes")
        msg_words[s] = np.frombuffer(block, dtype=">u4").astype(np.uint64)
    iv = np.zeros((B, 8), dtype=np.uint64)
    H64 = np.array(H, dtype=np.uint64)
    digests = [None] * B
    for s in range(B):
        if chain[s] == 0:
            iv[s] = H64
    todo = list(range(B))
    while todo:
        ready = [s for s in todo if chain[s] == 0 or digests[s - 1] is not None]
        if not ready:
            raise ValueError("chain flags form no valid schedule")
        batch = _compress_batch(msg_words[ready], iv[ready])
        for bi, s in enumerate(ready):
            digests[s] = batch[6][bi]
            if s + 1 < B and chain[s + 1] == 1:
                iv[s + 1] = batch[6][bi]
        todo = [s for s in todo if digests[s] is None]
    publics: list[int] = []
    for s in range(B):
        publics.extend(int(v) for v in msg_words[s])
        publics.extend(int(v) for v in digests[s])
        publics.append(int(chain[s]))
    return publics


def digest_words_to_bytes(words: list[int]) -> bytes:
    return b"".join(int(wd).to_bytes(4, "big") for wd in words)


def pad_message(message: bytes) -> list[bytes]:
    """Standard SHA-256 padding into 64-byte blocks (any length)."""
    p = message + b"\x80"
    while (len(p) + 8) % 64:
        p += b"\x00"
    p += (len(message) * 8).to_bytes(8, "big")
    return [p[i : i + 64] for i in range(0, len(p), 64)]


def pad_single_block(message: bytes) -> bytes:
    """SHA-256 padding for messages <= 55 bytes (single block)."""
    assert len(message) <= 55
    (block,) = pad_message(message)
    return block


def schedule_messages(messages: list[bytes]):
    """Pad each message and lay the blocks out as one chained schedule.

    Returns (blocks, chain, spans) where spans[i] = (first_segment,
    n_segments) of message i — the digest of message i is the digest
    publics of its last segment."""
    blocks: list[bytes] = []
    chain: list[int] = []
    spans: list[tuple[int, int]] = []
    for m in messages:
        bs = pad_message(m)
        spans.append((len(blocks), len(bs)))
        for j, b in enumerate(bs):
            blocks.append(b)
            chain.append(0 if j == 0 else 1)
    return blocks, chain, spans
