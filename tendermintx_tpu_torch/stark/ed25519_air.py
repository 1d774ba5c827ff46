"""Ed25519 verification AIR: the Straus ladder under full constraints.

Counterpart of ``tendermintx_tpu/stark/ed25519_air.py``: the constraint
program and the host trace generator are the reference's; the batched device
form of the multiplication constraints is written with torch ops. Each
signature occupies one 256-row segment; row r holds
ALL the non-native field multiplications of ladder step r (double + unified
mixed addition over GF(2^255-19) in 20x13-bit limbs), with every mul proven
by a committed (result, quotient, carry) witness:

    A(x)·B(x) − R(x) − (Q(x) − QOFS)·P(x) = C(x)·(x − 2^13)

checked coefficient-wise (exact over ℤ because every committed limb is
13-bit range-checked through the LogUp argument — stark/lookup.py — and the
carries are bias-committed). The per-step table selection [identity, B, −A,
B−A] is constrained from the committed scalar bits; the scalar bits, the
per-signature table, and the final projective state are bound to the PUBLIC
inputs through verifier-interpolated public columns, so a verified proof
establishes exactly:

    Q = [s]B + [k](−A)   with s, k, A from the public inputs,

and the (host) composition verifier finishes with the O(1) checks the
reference's gadget wiring does natively: s/k/table values match the
signature bytes and SHA-512 challenge, and Q == R projectively.

Layout per row (first the range-checked block, contiguous for the stacked
LogUp path):

  15 × [R(20) | Q(21) | CLO(39) | CHI(39)]   mul witnesses      0..1784
  3 zero pad columns (batch alignment)                        1785..1787
  sel_s, sel_k            scalar bits of this step            1788..1789
  SELV ymx/ypx/t2d        selected table entry (60)           1790..1849
  TAB  slot2, slot3 forms (120, constant per segment)         1850..1969
  FIN  final X, Y, Z      (60, constant per segment)          1970..2029
  MULT lookup multiplicities (table-width columns)            2030..

The mul schedule (extended-coordinate double then madd, matching
ops/ed25519._pt_double/_pt_madd bit for bit):
  m0=X², m1=Y², m2=Z², m3=(X+Y)², m4=E·F, m5=G·H, m6=F·G, m7=E·H   (dbl)
  m8=(Y1−X1)·ymx, m9=(Y1+X1)·ypx, m10=T1·t2d,
  m11=E2·F2, m12=G2·H2, m13=F2·G2, m14=E2·H2                       (madd)
with state (X,Y,Z,T) = previous row's (m11,m12,m13,m14) results, and the
identity point for step 0.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..ops.ed25519 import (  # host integer curve arithmetic
    BASE_POINT,
    D2_ED,
    D_ED,
    L_ORDER,
    N_BITS,
    N_LIMBS,
    P25519,
    decompress,
    int_to_limbs,
    pt_add,
    pt_neg,
)
import torch

from ..ops.goldilocks import GF, add
from .air import Air, DeviceAlgebra, Frame
from .lookup import RangeLookup

# --------------------------------------------------------------------------
# Native ladder replay (lane finals and publics)
# --------------------------------------------------------------------------

N_COORD_COLS = 4 * N_LIMBS
SEGMENT = 256


def _dbl_ext(X, Y, Z, _T):
    """Extended-coordinates doubling, mirroring ops/ed25519._pt_double."""
    A = X * X % P25519
    B = Y * Y % P25519
    C = 2 * Z * Z % P25519
    G = (B - A) % P25519
    F = (G - C) % P25519
    H = (-(A + B)) % P25519
    E = ((X + Y) * (X + Y) - A - B) % P25519
    return (E * F % P25519, G * H % P25519, F * G % P25519, E * H % P25519)


def _madd_ext(X1, Y1, Z1, T1, x2, y2):
    """Unified mixed addition, mirroring ops/ed25519._pt_madd."""
    t2 = x2 * y2 % P25519
    A = (Y1 - X1) * ((y2 - x2) % P25519) % P25519
    B = (Y1 + X1) * ((y2 + x2) % P25519) % P25519
    C = T1 * D2_ED % P25519 * t2 % P25519
    D = 2 * Z1 % P25519
    E = (B - A) % P25519
    F = (D - C) % P25519
    G = (D + C) % P25519
    H = (B + A) % P25519
    return (E * F % P25519, G * H % P25519, F * G % P25519, E * H % P25519)


def ladder_rows(pubkey: bytes, msg: bytes, sig: bytes):
    """All 253 ladder states + selection bits for one signature."""
    A = decompress(pubkey)
    R = decompress(sig[:32])
    if A is None or R is None:
        raise ValueError("invalid point encoding")
    s = int.from_bytes(sig[32:], "little")
    if s >= L_ORDER:
        raise ValueError("scalar out of range")
    k = (
        int.from_bytes(hashlib.sha512(sig[:32] + pubkey + msg).digest(), "little")
        % L_ORDER
    )
    negA = pt_neg(A)
    table = [(0, 1), BASE_POINT, negA, pt_add(BASE_POINT, negA)]

    Q = (0, 1, 1, 0)
    states = [Q]
    sels = []
    for b in range(N_BITS):
        pos = N_BITS - 1 - b
        s_bit = (s >> pos) & 1
        k_bit = (k >> pos) & 1
        Q = _dbl_ext(*Q)
        x2, y2 = table[2 * k_bit + s_bit]
        Q = _madd_ext(*Q, x2, y2)
        states.append(Q)
        sels.append((s_bit, k_bit))
    return states, sels, table, R


def derive_lane_final(pubkey: bytes, msg: bytes, sig: bytes) -> list[int] | None:
    """The 60 final-state limbs (X, Y, Z at base 2^13) the prover's ladder
    emits for this lane — a NATIVE replay of the exact double-and-add
    schedule, so the composite wire (v4) ships no final-state data at all:
    the verifier recomputes the expected publics and the STARK transcript
    binds them. ~2-3 ms per lane of host bigint work. None on malformed
    encodings (from_dict's failure contract)."""
    try:
        states, _, _, _R = ladder_rows(pubkey, msg, sig)
    except ValueError:
        return None
    X, Y, Z, _ = states[-1]
    out: list[int] = []
    for v in (X, Y, Z):
        out.extend(_limbs_list(v))
    return out


# --------------------------------------------------------------------------
# Constraint AIR
# --------------------------------------------------------------------------

LIMB = N_LIMBS  # 20
QLIMB = 21
CARN = 39
MUL_BLOCK = LIMB + QLIMB + 2 * CARN  # 119
N_MULS = 15
MUL_COLS = N_MULS * MUL_BLOCK  # 1785
PAD_COLS = 3  # pad the checked block to a multiple of the lookup batch
CHECKED_COLS = MUL_COLS + PAD_COLS  # 1788
COL_SEL0 = CHECKED_COLS
COL_SEL1 = CHECKED_COLS + 1
COL_SELV = CHECKED_COLS + 2  # ymx(20) ypx(20) t2d(20)
COL_TAB = COL_SELV + 60  # slot2 forms (60) + slot3 forms (60)
COL_FIN = COL_TAB + 120  # final X(20) Y(20) Z(20)
N_BIND = 180  # TAB + FIN, bound to pc_tab rows 0..179
COL_MULT = COL_FIN + 60

QOFS = 1 << 269  # quotient bias (q can be negative for signed operands)
COFS = 1 << 21  # carry bias
PUB_PER_SIG = 220  # s(20) k(20) slot2(60) slot3(60) final(60)

_P_LIMBS = [int(v) for v in int_to_limbs(P25519)]
# (QOFS * P)(x) limb coefficients: QOFS = 2^9 * x^20 at base 2^13
_QOFSP40 = [0] * 20 + [(1 << 9) * v for v in _P_LIMBS]


def _form(pt) -> tuple[int, int, int]:
    x, y = pt
    return ((y - x) % P25519, (y + x) % P25519, 2 * D_ED % P25519 * x % P25519 * y % P25519)


ID_FORM = (1, 1, 0)
B_FORM = _form(BASE_POINT)


def _limbs_list(v: int, n: int = LIMB) -> list[int]:
    out = []
    for _ in range(n):
        out.append(v & 0x1FFF)
        v >>= 13
    assert v == 0
    return out


def _conv(alg, a, b, out_len: int):
    """Coefficient convolution of two limb stacks -> (out_len, N)."""
    ka = alg.stack_len(a)
    acc = None
    for i in range(ka):
        term = alg.shift_up(b * a[i], i, out_len)
        acc = term if acc is None else acc + term
    return acc


def _conv_const(alg, a, const_vals: list[int], out_len: int):
    acc = None
    for j, cj in enumerate(const_vals):
        if cj == 0:
            continue
        term = alg.shift_up(alg.vcmul(cj, a), j, out_len)
        acc = term if acc is None else acc + term
    return acc


class Ed25519Air(Air):
    """n_sigs Ed25519 scalar-multiplication proofs, one 256-row segment
    each. Construct with the segment count (a power of two)."""

    n_public_cols = 3
    constraint_degree = 5  # lookup batch of 4 dominates
    frame_offsets = [0, 1]

    def __init__(self, n_sigs: int):
        self.n_sigs = n_sigs
        self.n_rows = SEGMENT * n_sigs
        self.lookup = RangeLookup(
            checked_cols=list(range(CHECKED_COLS)),
            mult_base=COL_MULT,
            n_rows=self.n_rows,
            table_bits=13,
        )
        self.n_cols = COL_MULT + self.lookup.width
        self.lookup.aux_base = self.n_cols
        self.n_aux_cols = self.lookup.n_aux_cols
        self.n_challenges = 1
        self.n_public = PUB_PER_SIG * n_sigs

    def cache_key(self):
        return (self.n_sigs,)

    # -- periodic selectors ----------------------------------------------------

    def periodic_columns(self):
        sel_init = [1 if s == 0 else 0 for s in range(SEGMENT)]
        sel_steps = [1 if s < N_BITS - 1 else 0 for s in range(SEGMENT)]
        sel_ladder = [1 if s < N_BITS else 0 for s in range(SEGMENT)]
        sel_const = [1 if s < SEGMENT - 1 else 0 for s in range(SEGMENT)]
        sel_bindmask = [1 if s < N_BIND else 0 for s in range(SEGMENT)]
        out = [sel_init, sel_steps, sel_ladder, sel_const, sel_bindmask]
        for j in range(N_BIND):
            out.append([1 if s == j else 0 for s in range(SEGMENT)])
        out.append([1 if s == N_BITS - 1 else 0 for s in range(SEGMENT)])
        out.extend(self.lookup.table_patterns())
        return out

    _LOOKUP_PERIODIC_BASE = 5 + N_BIND + 1

    # -- publics ----------------------------------------------------------------

    def validate_publics(self, publics) -> bool:
        if len(publics) != self.n_public:
            return False
        for i, v in enumerate(publics):
            if not (0 <= int(v) < (1 << 13)):
                return False
        for sgi in range(self.n_sigs):
            base = PUB_PER_SIG * sgi
            s_val = sum(int(publics[base + i]) << (13 * i) for i in range(20))
            k_val = sum(
                int(publics[base + 20 + i]) << (13 * i) for i in range(20)
            )
            if s_val >= (1 << N_BITS) or k_val >= (1 << N_BITS):
                return False
        return True

    def public_columns(self, publics, n_rows):
        assert n_rows == self.n_rows
        pc_tab = [0] * n_rows
        pc_s = [0] * n_rows
        pc_k = [0] * n_rows
        for sgi in range(self.n_sigs):
            base = PUB_PER_SIG * sgi
            row0 = SEGMENT * sgi
            s_val = sum(int(publics[base + i]) << (13 * i) for i in range(20))
            k_val = sum(
                int(publics[base + 20 + i]) << (13 * i) for i in range(20)
            )
            tabfin = publics[base + 40 : base + 220]
            for j in range(N_BIND):
                pc_tab[row0 + j] = int(tabfin[j])
            for r in range(N_BITS):
                pos = N_BITS - 1 - r
                pc_s[row0 + r] = (s_val >> pos) & 1
                pc_k[row0 + r] = (k_val >> pos) & 1
        return [pc_tab, pc_s, pc_k]

    # -- aux --------------------------------------------------------------------

    def aux_columns(self, trace, challenges, publics):
        return self.lookup.build_aux(trace, challenges[0])

    # -- constraint helpers -------------------------------------------------------

    def _mul_operands(self, frame: Frame, alg, off_idx: int, init: bool):
        cr = lambda base, cnt: alg.col_range(frame, off_idx, base, cnt)
        R = lambda i: cr(i * MUL_BLOCK, LIMB)
        if init:
            zero = alg.vconst([0] * LIMB)
            one = alg.vconst(_limbs_list(1))
            X0, Y0, Z0, T0 = zero, one, one, zero
        else:
            prev = lambda i: alg.col_range(frame, 0, i * MUL_BLOCK, LIMB)
            X0, Y0, Z0, T0 = prev(11), prev(12), prev(13), prev(14)
        selv = lambda g: cr(COL_SELV + 20 * g, LIMB)
        XY = X0 + Y0
        ops = [(X0, X0), (Y0, Y0), (Z0, Z0), (XY, XY)]
        E = R(3) - R(0) - R(1)
        G = R(1) - R(0)
        F = G - alg.vcmul(2, R(2))
        H = alg.vcmul(P_MINUS_1, R(0) + R(1))
        ops += [(E, F), (G, H), (F, G), (E, H)]
        ops += [
            (R(5) - R(4), selv(0)),
            (R(5) + R(4), selv(1)),
            (R(7), selv(2)),
        ]
        E2 = R(9) - R(8)
        D2 = alg.vcmul(2, R(6))
        F2 = D2 - R(10)
        G2 = D2 + R(10)
        H2 = R(9) + R(8)
        ops += [(E2, F2), (G2, H2), (F2, G2), (E2, H2)]
        return ops

    def _mul_constraints(self, frame: Frame, alg, sel, off_idx: int, init: bool):
        if isinstance(alg, DeviceAlgebra):
            return [
                self._mul_constraints_device(frame, alg, sel, off_idx, init)
            ]
        ops = self._mul_operands(frame, alg, off_idx, init)
        cofs = alg.vconst([COFS] * CARN)
        qofsp = alg.vconst(_QOFSP40)
        out = []
        for i, (a, b) in enumerate(ops):
            base = i * MUL_BLOCK
            Rr = alg.col_range(frame, off_idx, base, LIMB)
            Qq = alg.col_range(frame, off_idx, base + LIMB, QLIMB)
            CLO = alg.col_range(frame, off_idx, base + LIMB + QLIMB, CARN)
            CHI = alg.col_range(
                frame, off_idx, base + LIMB + QLIMB + CARN, CARN
            )
            conv_ab = _conv(alg, a, b, 40)
            conv_qp = _conv_const(alg, Qq, _P_LIMBS, 40)
            c = CLO + alg.vcmul(1 << 13, CHI) - cofs
            rhs = alg.shift_up(c, 1, 40) - alg.vcmul(
                1 << 13, alg.pad_stack(c, 40)
            )
            lhs = conv_ab - alg.pad_stack(Rr, 40) - conv_qp + qofsp
            out.append((lhs - rhs) * sel)
        return out

    def _mul_constraints_device(
        self, frame: Frame, alg, sel, off_idx: int, init: bool
    ):
        """Batched form of _mul_constraints for the device quotient: all 15
        muls' (R, Q, C) witnesses gathered as (15, k, N) tensors and the limb
        convolutions accumulated into (15, 40, N) coefficient slices with 20
        wide tensor ops instead of ~1200 per-limb ones. Returns ONE (600, N)
        constraint block in the host path's flatten order (mul-major, then
        coefficient)."""
        x = frame.rows_stacked.v[off_idx]
        N = x.shape[-1]
        dev = x.device

        def gather(col: int, cnt: int) -> GF:
            idx = torch.tensor(
                [[m * MUL_BLOCK + col + j for j in range(cnt)] for m in range(N_MULS)],
                device=dev,
            )
            return GF(x[idx])  # (15, cnt, N)

        Rst = gather(0, LIMB)
        Qst = gather(LIMB, QLIMB)
        CLOs = gather(LIMB + QLIMB, CARN)
        CHIs = gather(LIMB + QLIMB + CARN, CARN)

        ops = self._mul_operands(frame, alg, off_idx, init)
        A = GF.stack([a.broadcast_to((LIMB, N)) for a, _ in ops], axis=0)
        Bst = GF.stack([b.broadcast_to((LIMB, N)) for _, b in ops], axis=0)

        def accumulate(acc: torch.Tensor, term: GF, at: int):
            # acc[:, at:at+w] += term; the reference adds the zero-padded
            # term over all 40 coefficients, which gives the same values
            w = term.shape[1]
            acc[:, at : at + w] = add(acc[:, at : at + w], term.v)

        conv_ab = torch.zeros((N_MULS, 40, N), dtype=torch.int64, device=dev)
        for i in range(LIMB):
            accumulate(conv_ab, Bst * A[:, i : i + 1, :], i)
        conv_qp = torch.zeros((N_MULS, 40, N), dtype=torch.int64, device=dev)
        for j, pj in enumerate(_P_LIMBS):
            accumulate(conv_qp, Qst.cmul(pj), j)

        r_pad = torch.zeros((N_MULS, 40, N), dtype=torch.int64, device=dev)
        r_pad[:, :LIMB] = Rst.v
        qofsp = GF.from_ints(np.array(_QOFSP40, dtype=object), dev).reshape(1, 40, 1)
        lhs = GF(conv_ab) - GF(r_pad) - GF(conv_qp) + qofsp

        cofs = GF.from_ints(np.array([COFS], dtype=object), dev).reshape(1, 1, 1)
        c = CLOs + CHIs.cmul(1 << 13) - cofs  # (15, 39, N)
        shifted = torch.zeros((N_MULS, 40, N), dtype=torch.int64, device=dev)
        shifted[:, 1:] = c.v
        scaled = torch.zeros((N_MULS, 40, N), dtype=torch.int64, device=dev)
        scaled[:, :CARN] = c.cmul(1 << 13).v
        rhs = GF(shifted) - GF(scaled)

        out = (lhs - rhs) * GF(sel.v[None, None, :])
        return out.reshape(N_MULS * 40, N)

    # -- constraints ----------------------------------------------------------------

    def eval_cyclic(self, frame: Frame, alg):
        per = frame.periodic
        sel_init, sel_steps, sel_ladder, sel_const, sel_bindmask = per[:5]
        onehots = per[5 : 5 + N_BIND]
        oh_final = per[5 + N_BIND]
        pc_tab, pc_s, pc_k = frame.public_cols
        row0 = frame.rows[0]
        out = []

        # scalar-bit booleanity + binding to the public scalar bits
        s0 = row0[COL_SEL0]
        s1 = row0[COL_SEL1]
        out.append(sel_ladder * (s0 * s0 - s0))
        out.append(sel_ladder * (s1 * s1 - s1))
        out.append(sel_ladder * (s0 - pc_s))
        out.append(sel_ladder * (s1 - pc_k))

        # table-entry selection: SELV == one-hot(sel bits) over
        # [identity, B, slot2, slot3]
        one = alg.const(1)
        o0 = (one - s0) * (one - s1)
        o1 = s0 * (one - s1)
        o2 = (one - s0) * s1
        o3 = s0 * s1
        for g in range(3):
            selv = alg.col_range(frame, 0, COL_SELV + 20 * g, LIMB)
            tab2 = alg.col_range(frame, 0, COL_TAB + 20 * g, LIMB)
            tab3 = alg.col_range(frame, 0, COL_TAB + 60 + 20 * g, LIMB)
            expect = (
                alg.vconst(_limbs_list(ID_FORM[g])) * o0
                + alg.vconst(_limbs_list(B_FORM[g])) * o1
                + tab2 * o2
                + tab3 * o3
            )
            out.append((selv - expect) * sel_ladder)

        # per-segment constancy of TAB + FIN
        tf0 = alg.col_range(frame, 0, COL_TAB, N_BIND)
        tf1 = alg.col_range(frame, 1, COL_TAB, N_BIND)
        out.append((tf1 - tf0) * sel_const)

        # binding of TAB + FIN to the public column (rows 0..179)
        if isinstance(alg, DeviceAlgebra):
            tf = alg.col_range(frame, 0, COL_TAB, N_BIND)  # (180, N)
            oh = GF.stack(onehots, axis=0)  # (180, N)
            acc = (tf * oh).sum(axis=0)
        else:
            acc = None
            for j in range(N_BIND):
                term = row0[COL_TAB + j] * onehots[j]
                acc = term if acc is None else acc + term
        out.append(acc - pc_tab * sel_bindmask)

        # final-state copy: FIN == (m11, m12, m13) results at the last
        # ladder row
        fin = alg.col_range(frame, 0, COL_FIN, 60)
        outs = alg.vconcat(
            [
                alg.col_range(frame, 0, 11 * MUL_BLOCK, LIMB),
                alg.col_range(frame, 0, 12 * MUL_BLOCK, LIMB),
                alg.col_range(frame, 0, 13 * MUL_BLOCK, LIMB),
            ]
        )
        out.append((fin - outs) * oh_final)

        # the ladder itself
        out.extend(
            self._mul_constraints(frame, alg, sel_steps, off_idx=1, init=False)
        )
        out.extend(
            self._mul_constraints(frame, alg, sel_init, off_idx=0, init=True)
        )

        # range-check lookup
        cyc, _, _, _ = self.lookup.eval_lookup(
            frame, alg, self._LOOKUP_PERIODIC_BASE
        )
        out.extend(cyc)
        return out

    def eval_first(self, frame, alg):
        return self.lookup.eval_lookup(frame, alg, self._LOOKUP_PERIODIC_BASE)[1]

    def eval_transition(self, frame, alg):
        return self.lookup.eval_lookup(frame, alg, self._LOOKUP_PERIODIC_BASE)[2]

    def eval_last(self, frame, alg):
        return self.lookup.eval_lookup(frame, alg, self._LOOKUP_PERIODIC_BASE)[3]


P_MINUS_1 = (2**64 - 2**32 + 1) - 1  # Goldilocks p - 1 (negation scalar)


# --------------------------------------------------------------------------
# Trace generation (host, numpy-vectorized over signatures)
# --------------------------------------------------------------------------


def _limbs_obj(vals: np.ndarray, n: int) -> np.ndarray:
    """(B,) object ints -> (B, n) int64 13-bit limbs.

    One int.to_bytes per element + a vectorized unpackbits/weighted-sum —
    the per-limb object-dtype shift loop this replaces was the hottest
    host term of trace generation."""
    B = vals.shape[0]
    nbytes = (13 * n + 7) // 8
    buf = np.empty((B, nbytes), dtype=np.uint8)
    for i, v in enumerate(vals):
        # to_bytes raises OverflowError when v exceeds the limb capacity
        buf[i] = np.frombuffer(int(v).to_bytes(nbytes, "little"), np.uint8)
    bits = np.unpackbits(buf, axis=1, bitorder="little")[:, : 13 * n]
    w = (np.int64(1) << np.arange(13, dtype=np.int64))
    return (bits.reshape(B, n, 13) * w).sum(axis=2, dtype=np.int64)


def _conv_np(a: np.ndarray, b: np.ndarray, out_len: int) -> np.ndarray:
    """(B, ka) x (B, kb) int64 -> (B, out_len) coefficient convolution."""
    B, ka = a.shape
    kb = b.shape[1]
    acc = np.zeros((B, out_len), dtype=np.int64)
    for i in range(ka):
        acc[:, i : i + kb] += a[:, i : i + 1] * b
    return acc


class _Wire:
    """A field value tracked as (exact integer, signed int64 limbs)."""

    __slots__ = ("val", "limbs")

    def __init__(self, val, limbs):
        self.val = val
        self.limbs = limbs

    def __add__(self, o):
        return _Wire(self.val + o.val, self.limbs + o.limbs)

    def __sub__(self, o):
        return _Wire(self.val - o.val, self.limbs - o.limbs)

    def scale(self, c: int):
        return _Wire(self.val * c, self.limbs * c)


def ed25519_air_trace(pubkeys: list[bytes], msgs: list[bytes], sigs: list[bytes], device=None):
    """Full constraint-AIR trace for a batch of signatures.

    Returns (trace GF (n_cols, 256*B) on `device`, publics). B should be a power of two
    (pad with any valid dummy triple). Raises ValueError on malformed
    signatures (callers pre-verify natively)."""
    B = len(pubkeys)
    air = Ed25519Air(B)
    n_rows = air.n_rows

    s_vals = np.zeros((B,), dtype=object)
    k_vals = np.zeros((B,), dtype=object)
    forms2 = np.zeros((B, 3), dtype=object)
    forms3 = np.zeros((B, 3), dtype=object)
    for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
        A = decompress(pk)
        R = decompress(sig[:32])
        if A is None or R is None:
            raise ValueError(f"lane {i}: invalid point encoding")
        s = int.from_bytes(sig[32:], "little")
        if s >= L_ORDER:
            raise ValueError(f"lane {i}: scalar out of range")
        k = (
            int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little")
            % L_ORDER
        )
        s_vals[i] = s
        k_vals[i] = k
        negA = pt_neg(A)
        forms2[i] = _form(negA)
        forms3[i] = _form(pt_add(BASE_POINT, negA))

    sbits = np.zeros((B, N_BITS), dtype=np.uint32)
    kbits = np.zeros((B, N_BITS), dtype=np.uint32)
    for r in range(N_BITS):
        pos = N_BITS - 1 - r
        sbits[:, r] = [(int(v) >> pos) & 1 for v in s_vals]
        kbits[:, r] = [(int(v) >> pos) & 1 for v in k_vals]

    # selected form values per (lane, row): slot = 2*kbit + sbit
    slot_vals = np.zeros((B, 4, 3), dtype=object)
    for i in range(B):
        slot_vals[i, 0] = ID_FORM
        slot_vals[i, 1] = B_FORM
        slot_vals[i, 2] = forms2[i]
        slot_vals[i, 3] = forms3[i]

    trace = np.zeros((air.n_cols, B, SEGMENT), dtype=np.uint32)
    p_l = np.asarray(_P_LIMBS, dtype=np.int64)[None, :]
    qofsp = np.asarray(_QOFSP40, dtype=np.int64)[None, :]

    def wire_const(c: int) -> _Wire:
        return _Wire(
            np.full((B,), c, dtype=object),
            np.tile(np.asarray(_limbs_list(c), dtype=np.int64), (B, 1)),
        )

    state = [wire_const(0), wire_const(1), wire_const(1), wire_const(0)]

    def do_mul(mi: int, a: _Wire, b: _Wire, row: int) -> _Wire:
        ab = a.val * b.val
        r_ = ab % P25519
        q = (ab - r_) // P25519 + QOFS
        r_limbs = _limbs_obj(r_, LIMB)
        q_limbs = _limbs_obj(q, QLIMB)
        conv_ab = _conv_np(a.limbs, b.limbs, 40)
        conv_qp = _conv_np(q_limbs, np.broadcast_to(p_l, (B, LIMB)), 40)
        E = conv_ab - conv_qp + qofsp
        E[:, :LIMB] -= r_limbs
        # E_k = c_{k-1} - 2^13 c_k  ->  c_k = (c_{k-1} - E_k) / 2^13
        c = np.zeros((B, CARN), dtype=np.int64)
        prev = np.zeros((B,), dtype=np.int64)
        for kk in range(CARN):
            c[:, kk] = (prev - E[:, kk]) >> 13
            prev = c[:, kk]
        cb = c + COFS
        base = mi * MUL_BLOCK
        trace[base : base + LIMB, :, row] = r_limbs.T
        trace[base + LIMB : base + LIMB + QLIMB, :, row] = q_limbs.T
        trace[base + LIMB + QLIMB : base + LIMB + QLIMB + CARN, :, row] = (
            cb & 0x1FFF
        ).T
        trace[base + LIMB + QLIMB + CARN : base + MUL_BLOCK, :, row] = (
            cb >> 13
        ).T
        return _Wire(r_, r_limbs)

    for r in range(N_BITS):
        X0, Y0, Z0, T0 = state
        slot = (2 * kbits[:, r] + sbits[:, r]).astype(np.int64)
        lanes = np.arange(B)
        sel_form = [
            _Wire(slot_vals[lanes, slot, g], None) for g in range(3)
        ]
        for g in range(3):
            sel_form[g].limbs = _limbs_obj(sel_form[g].val, LIMB)
            trace[COL_SELV + 20 * g : COL_SELV + 20 * (g + 1), :, r] = (
                sel_form[g].limbs.T
            )
        trace[COL_SEL0, :, r] = sbits[:, r]
        trace[COL_SEL1, :, r] = kbits[:, r]

        m = {}
        m[0] = do_mul(0, X0, X0, r)
        m[1] = do_mul(1, Y0, Y0, r)
        m[2] = do_mul(2, Z0, Z0, r)
        XY = X0 + Y0
        m[3] = do_mul(3, XY, XY, r)
        E = m[3] - m[0] - m[1]
        G = m[1] - m[0]
        F = G - m[2].scale(2)
        H = (m[0] + m[1]).scale(-1)
        m[4] = do_mul(4, E, F, r)
        m[5] = do_mul(5, G, H, r)
        m[6] = do_mul(6, F, G, r)
        m[7] = do_mul(7, E, H, r)
        m[8] = do_mul(8, m[5] - m[4], sel_form[0], r)
        m[9] = do_mul(9, m[5] + m[4], sel_form[1], r)
        m[10] = do_mul(10, m[7], sel_form[2], r)
        E2 = m[9] - m[8]
        D2 = m[6].scale(2)
        F2 = D2 - m[10]
        G2 = D2 + m[10]
        H2 = m[9] + m[8]
        m[11] = do_mul(11, E2, F2, r)
        m[12] = do_mul(12, G2, H2, r)
        m[13] = do_mul(13, F2, G2, r)
        m[14] = do_mul(14, E2, H2, r)
        state = [m[11], m[12], m[13], m[14]]

    finals = state  # X, Y, Z, T after step 252

    # per-segment-constant columns: table forms and the final state
    for g in range(3):
        t2 = _limbs_obj(forms2[:, g], LIMB)
        t3 = _limbs_obj(forms3[:, g], LIMB)
        trace[COL_TAB + 20 * g : COL_TAB + 20 * (g + 1), :, :] = t2.T[:, :, None]
        trace[COL_TAB + 60 + 20 * g : COL_TAB + 60 + 20 * (g + 1), :, :] = (
            t3.T[:, :, None]
        )
    for g in range(3):
        fl = finals[g].limbs.astype(np.int64)
        trace[COL_FIN + 20 * g : COL_FIN + 20 * (g + 1), :, :] = fl.T[:, :, None]

    flat = trace.reshape(air.n_cols, n_rows)
    mult = air.lookup.multiplicity_columns(flat[:CHECKED_COLS])
    flat[COL_MULT : COL_MULT + air.lookup.width] = mult.astype(np.uint32)

    publics: list[int] = []
    for i in range(B):
        publics.extend(_limbs_list(int(s_vals[i])))
        publics.extend(_limbs_list(int(k_vals[i])))
        for g in range(3):
            publics.extend(_limbs_list(int(forms2[i, g])))
        for g in range(3):
            publics.extend(_limbs_list(int(forms3[i, g])))
        for g in range(3):
            publics.extend(int(v) for v in finals[g].limbs[i])
    return GF.from_small(flat, device), publics


# --------------------------------------------------------------------------
# Verifier-side lane checks (host, O(1) bigint work per signature)
# --------------------------------------------------------------------------


def derive_lane_publics(pubkey: bytes, msg: bytes, sig: bytes) -> list[int] | None:
    """The first 160 of a lane's 220 publics — s(20) k(20) slot2(60)
    slot3(60) — are a deterministic function of (pubkey, msg, sig); only
    the 60 final-state limbs (projective, free Z scale) are not. The
    composite serializer therefore ships ONLY the final 60 per lane and
    reconstructs the rest here (a 160/220 cut of the Ed25519 publics from
    the proof bytes). None if the pubkey/signature don't decompress."""
    A = decompress(pubkey)
    R = decompress(sig[:32])
    if A is None or R is None:
        return None
    s = int.from_bytes(sig[32:], "little")
    if s >= L_ORDER:
        return None
    k = (
        int.from_bytes(hashlib.sha512(sig[:32] + pubkey + msg).digest(), "little")
        % L_ORDER
    )
    negA = pt_neg(A)
    return (
        _limbs_list(s)
        + _limbs_list(k)
        + [v for g in _form(negA) for v in _limbs_list(g)]
        + [v for g in _form(pt_add(BASE_POINT, negA)) for v in _limbs_list(g)]
    )


def check_lane_publics(
    seg_publics: list[int], pubkey: bytes, msg: bytes, sig: bytes
) -> bool:
    """Given one segment's 220 public values from a VERIFIED Ed25519Air
    proof, check they are exactly the values derived from (pubkey, msg,
    sig) — and that the proven final state equals R projectively. With
    this, the proof establishes the full Ed25519 verification equation."""
    if len(seg_publics) != PUB_PER_SIG:
        return False
    A = decompress(pubkey)
    R = decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L_ORDER:
        return False
    k = (
        int.from_bytes(hashlib.sha512(sig[:32] + pubkey + msg).digest(), "little")
        % L_ORDER
    )
    negA = pt_neg(A)
    expect = (
        _limbs_list(s)
        + _limbs_list(k)
        + [v for g in _form(negA) for v in _limbs_list(g)]
        + [v for g in _form(pt_add(BASE_POINT, negA)) for v in _limbs_list(g)]
    )
    if [int(v) for v in seg_publics[:160]] != expect:
        return False
    fin = [
        sum(int(seg_publics[160 + 20 * g + i]) << (13 * i) for i in range(20))
        for g in range(3)
    ]
    X, Y, Z = fin
    if Z % P25519 == 0:
        return False
    if (X - R[0] * Z) % P25519 != 0:
        return False
    if (Y - R[1] * Z) % P25519 != 0:
        return False
    return True
