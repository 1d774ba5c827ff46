"""Batched multi-block SHA-512 compression AIR.

Counterpart of ``tendermintx_tpu/stark/sha512_air.py`` (the constraint
program is algebra-generic and unchanged; the trace generator returns a torch
``GF`` on a chosen device). It proves the Ed25519 challenge hash
k = SHA-512(R ‖ A ‖ M) inside the composite proof.

Same shape as stark/sha256_air.py with 64-bit words: the trace is a
sequence of 80-row segments (one compression each; all selectors have
period 80), segments optionally chain (Merkle-Damgård) so multi-block
messages — R‖A‖M is 96+ bytes = at least one 128-byte padded block —
prove too. A 64-bit word is committed as 64 bit columns; every modular
addition is constrained on (lo, hi) 32-bit halves, because a full 64-bit
word sum does not fit the Goldilocks field (p = 2^64 - 2^32 + 1): lo-half
sums of <= 7 terms stay < 2^35 < p, with explicit carry bits into the hi
half and a discarded hi overflow.

Per row t of a segment: bits of schedule word w(t) and of the state words
a(t), e(t) produced BY round t (b..d / f..h live on earlier rows), plus
carry bits. Rows 0..3 additionally hold the bits of the segment's IV words
(a-side in IVA, e-side in IVE): round t reads A[t-j]; for t-j < 0 that
resolves to IVA row (j-t-1). 340 columns.

Public inputs per segment: 16 message words as 32 (lo, hi) halves ‖
8 digest words as 16 halves ‖ chain flag = 49 field elements. They bind
through eight public columns (verifier-interpolated, uncommitted):
pc_a/pc_b carry message halves (rows 0..15) and a-side digest halves
(rows 76..79, reversed), pc_c/pc_d the e-side digest halves, and
pc_iv_{a,e}_{lo,hi} the IV halves (H constants when chain = 0, the
previous segment's digest publics when chain = 1).
"""

from __future__ import annotations

import numpy as np

from ..ops.goldilocks import GF
from ..ops.sha512 import _H0, _K
from .air import Air, Frame

ROUNDS = 80
# Trace lengths must be powers of two and the selector period must divide
# them, so each 80-round compression occupies a 128-row segment: rows
# 0..79 are the rounds (digest binding on 76..79), rows 80..127 are idle
# zero rows with every selector off.
SEGMENT = 128
WORD = 64
# column layout
COL_W = 0
COL_A = 64
COL_E = 128
COL_CW = 192  # schedule carries: 2 lo bits + 2 hi bits
COL_CE = 196  # new_e carries: 3 lo bits + 3 hi bits
COL_CA = 202  # new_a carries: 3 lo bits + 3 hi bits
COL_CDIG = 208  # digest carries (rows 76..79): a_lo, a_hi, e_lo, e_hi
COL_IVA = 212  # IV bits, a-side: row r (0..3) holds bits of IV[r]
COL_IVE = 276  # IV bits, e-side: row r (0..3) holds bits of IV[4+r]
N_COLS = 340

PUB_PER_SEGMENT = 49  # 32 msg halves + 16 digest halves + chain flag

H = [int(x) for x in _H0]
K = [int(x) for x in _K]

_M32 = (1 << 32) - 1


class Sha512Air(Air):
    """One or more (optionally chained) SHA-512 compressions; construct
    with the segment count."""

    n_cols = N_COLS
    n_public_cols = 8
    constraint_degree = 4
    frame_offsets = [0, 1, 2, 3, 4, 9, 14, 16]

    def __init__(self, n_blocks: int = 1):
        self.n_blocks = n_blocks
        self.n_public = PUB_PER_SEGMENT * n_blocks

    def cache_key(self):
        return (self.n_blocks,)

    # -- periodic selectors ---------------------------------------------------

    def periodic_columns(self):
        sel_main = [1 if s < ROUNDS - 4 else 0 for s in range(SEGMENT)]
        sel_sched = [1 if s < ROUNDS - 16 else 0 for s in range(SEGMENT)]
        sel_init = [1 if s == 0 else 0 for s in range(SEGMENT)]
        sel_msg = [1 if s < 16 else 0 for s in range(SEGMENT)]
        sel_dig = [1 if s >= ROUNDS - 4 else 0 for s in range(SEGMENT)]
        sel_iv = [1 if s < 4 else 0 for s in range(SEGMENT)]
        # K only matters where sel_main = 1 (s < 76 -> round t = s+4 < 80);
        # the wrapped values elsewhere are never selected
        k_lo = [K[(s + 4) % ROUNDS] & _M32 for s in range(SEGMENT)]
        k_hi = [K[(s + 4) % ROUNDS] >> 32 for s in range(SEGMENT)]
        return [
            sel_main, sel_sched, sel_init, sel_msg, sel_dig, sel_iv,
            k_lo, k_hi,
        ]

    # -- public-input validation (untrusted proofs) ---------------------------

    def validate_publics(self, publics) -> bool:
        if len(publics) != self.n_public:
            return False
        for s in range(self.n_blocks):
            base = PUB_PER_SEGMENT * s
            halves = publics[base : base + 48]
            if any(not (0 <= int(v) < (1 << 32)) for v in halves):
                return False
            chain = int(publics[base + 48])
            if chain not in (0, 1):
                return False
            if s == 0 and chain != 0:
                return False
        return True

    # -- public columns -------------------------------------------------------

    def _segment_ivs(self, publics):
        """Per-segment IV halves (16 each: [lo0, hi0, lo1, hi1, ...]),
        derived from the chain flags."""
        ivs = []
        h_halves = []
        for v in H:
            h_halves += [v & _M32, v >> 32]
        for s in range(self.n_blocks):
            base = PUB_PER_SEGMENT * s
            chain = int(publics[base + 48])
            if chain == 0:
                ivs.append(list(h_halves))
            else:
                prev = PUB_PER_SEGMENT * (s - 1)
                ivs.append([int(v) for v in publics[prev + 32 : prev + 48]])
        return ivs

    def public_columns(self, publics, n_rows):
        assert n_rows == SEGMENT * self.n_blocks
        assert self.validate_publics(publics), "invalid public inputs"
        cols = [[0] * n_rows for _ in range(8)]
        (
            pc_a, pc_b, pc_c, pc_d,
            pc_iva_lo, pc_iva_hi, pc_ive_lo, pc_ive_hi,
        ) = cols
        ivs = self._segment_ivs(publics)
        for s in range(self.n_blocks):
            base = PUB_PER_SEGMENT * s
            msg = publics[base : base + 32]  # [lo0, hi0, lo1, hi1, ...]
            digest = publics[base + 32 : base + 48]
            iv = ivs[s]
            for i in range(16):
                pc_a[SEGMENT * s + i] = msg[2 * i]
                pc_b[SEGMENT * s + i] = msg[2 * i + 1]
            for r in range(4):
                row = SEGMENT * s + (ROUNDS - 4) + r
                pc_a[row] = digest[2 * (3 - r)]
                pc_b[row] = digest[2 * (3 - r) + 1]
                pc_c[row] = digest[2 * (7 - r)]
                pc_d[row] = digest[2 * (7 - r) + 1]
                pc_iva_lo[row] = iv[2 * (3 - r)]
                pc_iva_hi[row] = iv[2 * (3 - r) + 1]
                pc_ive_lo[row] = iv[2 * (7 - r)]
                pc_ive_hi[row] = iv[2 * (7 - r) + 1]
                top = SEGMENT * s + r
                pc_iva_lo[top] = iv[2 * r]
                pc_iva_hi[top] = iv[2 * r + 1]
                pc_ive_lo[top] = iv[2 * (4 + r)]
                pc_ive_hi[top] = iv[2 * (4 + r) + 1]
        return cols

    # -- helpers over the algebra (a 64-bit word is one k=64 stacked
    # vector; σ/Σ/ch/maj are single wide array ops) --------------------------

    W_LO = [1 << i for i in range(32)]

    @classmethod
    def _val_lo(cls, vec, alg):
        return alg.weighted_sum(vec[0:32], cls.W_LO)

    @classmethod
    def _val_hi(cls, vec, alg):
        return alg.weighted_sum(vec[32:64], cls.W_LO)

    @staticmethod
    def _xor2(x, y, alg):
        return x + y - alg.vcmul(2, x * y)

    @classmethod
    def _xor3(cls, x, y, z, alg):
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
        return cls._xor3(alg.rot(v, 1), alg.rot(v, 8), alg.shift_down(v, 7), alg)

    @classmethod
    def _sigma1_small(cls, v, alg):
        return cls._xor3(
            alg.rot(v, 19), alg.rot(v, 61), alg.shift_down(v, 6), alg
        )

    @classmethod
    def _Sigma0(cls, v, alg):
        return cls._xor3(alg.rot(v, 28), alg.rot(v, 34), alg.rot(v, 39), alg)

    @classmethod
    def _Sigma1(cls, v, alg):
        return cls._xor3(alg.rot(v, 14), alg.rot(v, 18), alg.rot(v, 41), alg)

    def _cols(self, frame: Frame, offset: int, start: int, count: int, alg):
        return alg.col_range(frame, self.frame_offsets.index(offset), start, count)

    def _felt(self, frame: Frame, offset: int, col: int):
        return frame.at_offset(offset, self)[col]

    def _a_bits(self, frame, m, alg):
        if m < 0:
            return self._cols(frame, (-m) - 1, COL_IVA, WORD, alg)
        return self._cols(frame, m, COL_A, WORD, alg)

    def _e_bits(self, frame, m, alg):
        if m < 0:
            return self._cols(frame, (-m) - 1, COL_IVE, WORD, alg)
        return self._cols(frame, m, COL_E, WORD, alg)

    # -- constraints ----------------------------------------------------------

    def eval_cyclic(self, frame: Frame, alg):
        (
            sel_main, sel_sched, sel_init, sel_msg, sel_dig, sel_iv,
            k_lo, k_hi,
        ) = frame.periodic
        (
            pc_a, pc_b, pc_c, pc_d,
            pc_iva_lo, pc_iva_hi, pc_ive_lo, pc_ive_hi,
        ) = frame.public_cols
        out = []

        # 1. booleanity of every column: one stacked op
        all_cols = alg.col_range(frame, 0, 0, N_COLS)
        bool_vec = all_cols * all_cols - all_cols
        out.extend(alg.unstack(bool_vec))

        # 2. message binding: rows 0..15 of each segment
        w0 = self._cols(frame, 0, COL_W, WORD, alg)
        out.append(sel_msg * (self._val_lo(w0, alg) - pc_a))
        out.append(sel_msg * (self._val_hi(w0, alg) - pc_b))

        # 3. IV binding: rows 0..3 — committed IV bits recompose to the
        #    public-column IV halves
        iva = self._cols(frame, 0, COL_IVA, WORD, alg)
        ive = self._cols(frame, 0, COL_IVE, WORD, alg)
        out.append(sel_iv * (self._val_lo(iva, alg) - pc_iva_lo))
        out.append(sel_iv * (self._val_hi(iva, alg) - pc_iva_hi))
        out.append(sel_iv * (self._val_lo(ive, alg) - pc_ive_lo))
        out.append(sel_iv * (self._val_hi(ive, alg) - pc_ive_hi))

        # 4. schedule recurrence: w(s+16) = σ1(w(s+14)) + w(s+9) +
        #    σ0(w(s+1)) + w(s)  (half-split, carries at row s+16)
        w1 = self._cols(frame, 1, COL_W, WORD, alg)
        w9 = self._cols(frame, 9, COL_W, WORD, alg)
        w14 = self._cols(frame, 14, COL_W, WORD, alg)
        w16 = self._cols(frame, 16, COL_W, WORD, alg)
        s0 = self._sigma0_small(w1, alg)
        s1 = self._sigma1_small(w14, alg)
        lhs_lo = (
            self._val_lo(s1, alg)
            + self._val_lo(w9, alg)
            + self._val_lo(s0, alg)
            + self._val_lo(w0, alg)
        )
        lhs_hi = (
            self._val_hi(s1, alg)
            + self._val_hi(w9, alg)
            + self._val_hi(s0, alg)
            + self._val_hi(w0, alg)
        )
        cw_lo = self._felt(frame, 16, COL_CW) + alg.cmul(
            2, self._felt(frame, 16, COL_CW + 1)
        )
        cw_hi = self._felt(frame, 16, COL_CW + 2) + alg.cmul(
            2, self._felt(frame, 16, COL_CW + 3)
        )
        out.append(
            sel_sched
            * (lhs_lo - self._val_lo(w16, alg) - alg.cmul(1 << 32, cw_lo))
        )
        out.append(
            sel_sched
            * (
                lhs_hi
                + cw_lo
                - self._val_hi(w16, alg)
                - alg.cmul(1 << 32, cw_hi)
            )
        )

        # 5. generic round t = s+4 (anchor s)
        out.extend(
            self._round_constraints(
                frame, alg, sel_main, t_rel=4, k_lo=k_lo, k_hi=k_hi,
            )
        )

        # 6. initial rounds t = 0..3 (anchor row 0): negative round indices
        #    resolve to the committed IV bits
        for t in range(4):
            out.extend(
                self._round_constraints(
                    frame, alg, sel_init, t_rel=t,
                    k_lo=alg.const(K[t] & _M32), k_hi=alg.const(K[t] >> 32),
                )
            )

        # 7. digest binding on rows 76..79: IV word + state word = digest
        #    word + carry·2^64, on halves (the IV comes from the public
        #    columns in reversed order)
        a0 = self._cols(frame, 0, COL_A, WORD, alg)
        e0 = self._cols(frame, 0, COL_E, WORD, alg)
        cd_a_lo = frame.rows[0][COL_CDIG]
        cd_a_hi = frame.rows[0][COL_CDIG + 1]
        cd_e_lo = frame.rows[0][COL_CDIG + 2]
        cd_e_hi = frame.rows[0][COL_CDIG + 3]
        out.append(
            sel_dig
            * (
                pc_iva_lo
                + self._val_lo(a0, alg)
                - pc_a
                - alg.cmul(1 << 32, cd_a_lo)
            )
        )
        out.append(
            sel_dig
            * (
                pc_iva_hi
                + self._val_hi(a0, alg)
                + cd_a_lo
                - pc_b
                - alg.cmul(1 << 32, cd_a_hi)
            )
        )
        out.append(
            sel_dig
            * (
                pc_ive_lo
                + self._val_lo(e0, alg)
                - pc_c
                - alg.cmul(1 << 32, cd_e_lo)
            )
        )
        out.append(
            sel_dig
            * (
                pc_ive_hi
                + self._val_hi(e0, alg)
                + cd_e_lo
                - pc_d
                - alg.cmul(1 << 32, cd_e_hi)
            )
        )
        return out

    def _round_constraints(self, frame, alg, sel, t_rel, k_lo, k_hi):
        a_in = self._a_bits(frame, t_rel - 1, alg)
        b = self._a_bits(frame, t_rel - 2, alg)
        c = self._a_bits(frame, t_rel - 3, alg)
        d_bits = self._a_bits(frame, t_rel - 4, alg)
        e_in = self._e_bits(frame, t_rel - 1, alg)
        f = self._e_bits(frame, t_rel - 2, alg)
        g = self._e_bits(frame, t_rel - 3, alg)
        h_bits = self._e_bits(frame, t_rel - 4, alg)

        w_bits = self._cols(frame, t_rel, COL_W, WORD, alg)
        new_a = self._cols(frame, t_rel, COL_A, WORD, alg)
        new_e = self._cols(frame, t_rel, COL_E, WORD, alg)
        ce = [self._felt(frame, t_rel, COL_CE + j) for j in range(6)]
        ca = [self._felt(frame, t_rel, COL_CA + j) for j in range(6)]

        S1 = self._Sigma1(e_in, alg)
        ch = self._ch(e_in, f, g, alg)
        S0 = self._Sigma0(a_in, alg)
        maj = self._maj(a_in, b, c, alg)

        t1_lo = (
            self._val_lo(h_bits, alg)
            + self._val_lo(S1, alg)
            + self._val_lo(ch, alg)
            + k_lo
            + self._val_lo(w_bits, alg)
        )
        t1_hi = (
            self._val_hi(h_bits, alg)
            + self._val_hi(S1, alg)
            + self._val_hi(ch, alg)
            + k_hi
            + self._val_hi(w_bits, alg)
        )
        t2_lo = self._val_lo(S0, alg) + self._val_lo(maj, alg)
        t2_hi = self._val_hi(S0, alg) + self._val_hi(maj, alg)

        ce_lo = ce[0] + alg.cmul(2, ce[1]) + alg.cmul(4, ce[2])
        ce_hi = ce[3] + alg.cmul(2, ce[4]) + alg.cmul(4, ce[5])
        ca_lo = ca[0] + alg.cmul(2, ca[1]) + alg.cmul(4, ca[2])
        ca_hi = ca[3] + alg.cmul(2, ca[4]) + alg.cmul(4, ca[5])

        c_e_lo = (
            self._val_lo(d_bits, alg)
            + t1_lo
            - self._val_lo(new_e, alg)
            - alg.cmul(1 << 32, ce_lo)
        )
        c_e_hi = (
            self._val_hi(d_bits, alg)
            + t1_hi
            + ce_lo
            - self._val_hi(new_e, alg)
            - alg.cmul(1 << 32, ce_hi)
        )
        c_a_lo = (
            t1_lo + t2_lo - self._val_lo(new_a, alg) - alg.cmul(1 << 32, ca_lo)
        )
        c_a_hi = (
            t1_hi
            + t2_hi
            + ca_lo
            - self._val_hi(new_a, alg)
            - alg.cmul(1 << 32, ca_hi)
        )
        return [sel * c_e_lo, sel * c_e_hi, sel * c_a_lo, sel * c_a_hi]


# ---------------------------------------------------------------------------
# Trace generation (host, numpy-vectorized over segments)
# ---------------------------------------------------------------------------

_U64M = np.uint64(0xFFFFFFFFFFFFFFFF)
_LOM = np.uint64(0xFFFFFFFF)


def _rotr(x, r):
    return (x >> np.uint64(r)) | (x << np.uint64(64 - r))


def _split_add(terms, extra=None):
    """Sum 64-bit words on (lo, hi) halves. terms: list of uint64 arrays
    (full words); extra: optional uint64 carry-in added to the lo half.
    Returns (word, carry_lo, carry_hi) with word = sum mod 2^64."""
    lo = sum((t & _LOM) for t in terms)
    if extra is not None:
        lo = lo + extra
    c_lo = lo >> np.uint64(32)
    hi = sum((t >> np.uint64(32)) for t in terms) + c_lo
    c_hi = hi >> np.uint64(32)
    word = (lo & _LOM) | ((hi & _LOM) << np.uint64(32))
    return word, c_lo, c_hi


def _compress_batch(msg_words: np.ndarray, iv: np.ndarray):
    """Vectorized SHA-512 compression of B blocks with per-block IVs.

    msg_words: (B, 16) uint64; iv: (B, 8) uint64. Returns
    (w, cw_lo, cw_hi, A, E, ce_lo, ce_hi, ca_lo, ca_hi, digest,
    cdig) — A/E are (B, 80) round outputs; cdig is (B, 4, 4) carries
    [a_lo, a_hi, e_lo, e_hi] stored per digest row 76+r."""
    B = msg_words.shape[0]
    w = np.zeros((B, ROUNDS), dtype=np.uint64)
    cw_lo = np.zeros((B, ROUNDS), dtype=np.uint64)
    cw_hi = np.zeros((B, ROUNDS), dtype=np.uint64)
    w[:, :16] = msg_words
    for t in range(16, ROUNDS):
        x15 = w[:, t - 15]
        x2 = w[:, t - 2]
        s0 = _rotr(x15, 1) ^ _rotr(x15, 8) ^ (x15 >> np.uint64(7))
        s1 = _rotr(x2, 19) ^ _rotr(x2, 61) ^ (x2 >> np.uint64(6))
        w[:, t], cw_lo[:, t], cw_hi[:, t] = _split_add(
            [s1, w[:, t - 7], s0, w[:, t - 16]]
        )

    A = np.zeros((B, ROUNDS + 4), dtype=np.uint64)
    E = np.zeros((B, ROUNDS + 4), dtype=np.uint64)
    A[:, 3::-1] = iv[:, :4]
    E[:, 3::-1] = iv[:, 4:]
    ce_lo = np.zeros((B, ROUNDS), dtype=np.uint64)
    ce_hi = np.zeros((B, ROUNDS), dtype=np.uint64)
    ca_lo = np.zeros((B, ROUNDS), dtype=np.uint64)
    ca_hi = np.zeros((B, ROUNDS), dtype=np.uint64)
    K64 = np.array(K, dtype=np.uint64)
    for t in range(ROUNDS):
        a_in, b_, c_, d = A[:, t + 3], A[:, t + 2], A[:, t + 1], A[:, t]
        e_in, f, g, h = E[:, t + 3], E[:, t + 2], E[:, t + 1], E[:, t]
        S1 = _rotr(e_in, 14) ^ _rotr(e_in, 18) ^ _rotr(e_in, 41)
        ch = (e_in & f) ^ (~e_in & g)
        S0 = _rotr(a_in, 28) ^ _rotr(a_in, 34) ^ _rotr(a_in, 39)
        maj = (a_in & b_) ^ (a_in & c_) ^ (b_ & c_)
        kb = np.broadcast_to(K64[t], (B,))
        E[:, t + 4], ce_lo[:, t], ce_hi[:, t] = _split_add(
            [d, h, S1, ch, kb, w[:, t]]
        )
        A[:, t + 4], ca_lo[:, t], ca_hi[:, t] = _split_add(
            [h, S1, ch, kb, w[:, t], S0, maj]
        )

    digest = np.zeros((B, 8), dtype=np.uint64)
    cdig = np.zeros((B, 4, 4), dtype=np.uint64)
    for i in range(4):
        word, clo, chi = _split_add([iv[:, i], A[:, ROUNDS + 3 - i]])
        digest[:, i] = word
        cdig[:, 3 - i, 0] = clo
        cdig[:, 3 - i, 1] = chi
        word, clo, chi = _split_add([iv[:, 4 + i], E[:, ROUNDS + 3 - i]])
        digest[:, 4 + i] = word
        cdig[:, 3 - i, 2] = clo
        cdig[:, 3 - i, 3] = chi
    return (
        w, cw_lo, cw_hi, A[:, 4:], E[:, 4:],
        ce_lo, ce_hi, ca_lo, ca_hi, digest, cdig,
    )


def sha512_batch_trace(blocks: list[bytes], chain: list[int] | None = None, device=None):
    """blocks: list of 128-byte blocks; chain[s] = 1 continues block s-1's
    compression. Returns (trace_cols GF (340, 128*B) on `device`, publics
    (49*B))."""
    B = len(blocks)
    if chain is None:
        chain = [0] * B
    assert len(chain) == B and (B == 0 or chain[0] == 0)
    msg_words = np.zeros((B, 16), dtype=np.uint64)
    for s, block in enumerate(blocks):
        assert len(block) == 128
        msg_words[s] = np.frombuffer(block, dtype=">u8")

    iv = np.zeros((B, 8), dtype=np.uint64)
    H64 = np.array(H, dtype=np.uint64)
    results = [None] * B
    for s in range(B):
        if chain[s] == 0:
            iv[s] = H64
    todo = list(range(B))
    while todo:
        ready = [s for s in todo if chain[s] == 0 or results[s - 1] is not None]
        assert ready, "chain flags form no valid schedule"
        batch = _compress_batch(msg_words[ready], iv[ready])
        for bi, s in enumerate(ready):
            results[s] = tuple(arr[bi] for arr in batch)
            if s + 1 < B and chain[s + 1] == 1:
                iv[s + 1] = batch[9][bi]  # digest
        todo = [s for s in todo if results[s] is None]

    rows = np.zeros((SEGMENT * B, N_COLS), dtype=np.uint32)
    publics = []
    bit_idx = np.arange(WORD, dtype=np.uint64)
    for s in range(B):
        (
            w, cw_lo, cw_hi, A, E, ce_lo, ce_hi, ca_lo, ca_hi, digest, cdig,
        ) = results[s]
        base = SEGMENT * s
        seg = rows[base : base + SEGMENT]
        rr = slice(0, ROUNDS)  # rows 80..127 stay zero (idle pad rows)
        seg[rr, COL_W : COL_W + WORD] = (w[:, None] >> bit_idx[None, :]) & 1
        seg[rr, COL_A : COL_A + WORD] = (A[:, None] >> bit_idx[None, :]) & 1
        seg[rr, COL_E : COL_E + WORD] = (E[:, None] >> bit_idx[None, :]) & 1
        seg[rr, COL_CW] = cw_lo & 1
        seg[rr, COL_CW + 1] = (cw_lo >> np.uint64(1)) & 1
        seg[rr, COL_CW + 2] = cw_hi & 1
        seg[rr, COL_CW + 3] = (cw_hi >> np.uint64(1)) & 1
        for j in range(3):
            seg[rr, COL_CE + j] = (ce_lo >> np.uint64(j)) & 1
            seg[rr, COL_CE + 3 + j] = (ce_hi >> np.uint64(j)) & 1
            seg[rr, COL_CA + j] = (ca_lo >> np.uint64(j)) & 1
            seg[rr, COL_CA + 3 + j] = (ca_hi >> np.uint64(j)) & 1
        seg[ROUNDS - 4 : ROUNDS, COL_CDIG : COL_CDIG + 4] = cdig
        seg[:4, COL_IVA : COL_IVA + WORD] = (
            iv[s, :4, None] >> bit_idx[None, :]
        ) & 1
        seg[:4, COL_IVE : COL_IVE + WORD] = (
            iv[s, 4:, None] >> bit_idx[None, :]
        ) & 1
        for v in msg_words[s]:
            publics += [int(v) & _M32, int(v) >> 32]
        for v in digest:
            publics += [int(v) & _M32, int(v) >> 32]
        publics.append(int(chain[s]))
    return GF.from_small(rows.T, device), publics


def sha512_publics(blocks: list[bytes], chain: list[int] | None = None) -> list[int]:
    """The publics sha512_batch_trace would emit, WITHOUT building the
    trace: message words + per-block (chained) digest halves + chain flag.
    All of it is a deterministic host computation over the blocks, so the
    composite serializer drops the SHA-512 publics from the proof bytes
    and rebuilds them here at verify time."""
    B = len(blocks)
    if chain is None:
        chain = [0] * B
    assert len(chain) == B and (B == 0 or chain[0] == 0)
    msg_words = np.zeros((B, 16), dtype=np.uint64)
    for s, block in enumerate(blocks):
        assert len(block) == 128
        msg_words[s] = np.frombuffer(block, dtype=">u8")
    iv = np.zeros((B, 8), dtype=np.uint64)
    H64 = np.array(H, dtype=np.uint64)
    digests = [None] * B
    for s in range(B):
        if chain[s] == 0:
            iv[s] = H64
    todo = list(range(B))
    while todo:
        ready = [s for s in todo if chain[s] == 0 or digests[s - 1] is not None]
        assert ready, "chain flags form no valid schedule"
        batch = _compress_batch(msg_words[ready], iv[ready])
        for bi, s in enumerate(ready):
            digests[s] = batch[9][bi]
            if s + 1 < B and chain[s + 1] == 1:
                iv[s + 1] = batch[9][bi]
        todo = [s for s in todo if digests[s] is None]
    publics: list[int] = []
    for s in range(B):
        for v in msg_words[s]:
            publics += [int(v) & _M32, int(v) >> 32]
        for v in digests[s]:
            publics += [int(v) & _M32, int(v) >> 32]
        publics.append(int(chain[s]))
    return publics


def digest_halves_to_bytes(halves: list[int]) -> bytes:
    """16 (lo, hi) halves -> 64 digest bytes."""
    out = b""
    for i in range(8):
        word = int(halves[2 * i]) | (int(halves[2 * i + 1]) << 32)
        out += word.to_bytes(8, "big")
    return out


def pad_message_512(message: bytes) -> list[bytes]:
    """Standard SHA-512 padding into 128-byte blocks (any length)."""
    p = message + b"\x80"
    while (len(p) + 16) % 128:
        p += b"\x00"
    p += (len(message) * 8).to_bytes(16, "big")
    return [p[i : i + 128] for i in range(0, len(p), 128)]


def schedule_messages_512(messages: list[bytes]):
    """Pad each message and lay the blocks out as one chained schedule.

    Returns (blocks, chain, spans) with spans[i] = (first_segment,
    n_segments) of message i."""
    blocks: list[bytes] = []
    chain: list[int] = []
    spans: list[tuple[int, int]] = []
    for m in messages:
        bs = pad_message_512(m)
        spans.append((len(blocks), len(bs)))
        for j, b in enumerate(bs):
            blocks.append(b)
            chain.append(0 if j == 0 else 1)
    return blocks, chain, spans
