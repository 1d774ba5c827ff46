"""Recursive wrapper STARK: ONE near-constant-size proof for a whole batch.

Counterpart of ``tendermintx_tpu/stark/recursion.py``, whose wrapped proof
is the system's deliverable. A **wrapper AIR** (WrapAir) replays the query
phase of the batch-STARK verifier (stark/batch.py): every Merkle opening,
the DEEP combination of every opened row and every FRI fold. An EvalAir
statement (stark/evalair.py) proves each wrapped statement's OOD
composition identity. The serialized proof drops the openings and query
rounds; what remains is caps, OOD values, the final polynomial and one
two-statement wrap batch ([WrapAir, EvalAir]).

Split of labor (soundness):
  * The OUTER verifier (verify_wrapped_batch) replays the shared
    Fiat-Shamir transcript over the small wire data and derives every
    challenge and query index. It evaluates no wrapped statement's
    constraint system.
  * WrapAir proves that the openings hash to the caps and that the DEEP
    values recomputed from them feed FRI folds ending in the final
    polynomial, at exactly the transcript-sampled query indices.
  * EvalAir proves the wrapped statements' constraint systems at z.
  * The outer verifier rebuilds BOTH statements' public-input vectors
    from its own replay and verifies the wrap batch with the ordinary
    batch verifier.

Wrapper AIR layout, ONE Poseidon permutation per row:

  columns [0,12)    `in`   permutation input state
  columns [12,48)   S1..S3 state before full rounds 1..3
  columns [48,70)   p4..p25 lane-0 pre-S-box value of each partial round
  columns [70,118)  w26..w29 state before full rounds 26..29
  columns [118,..)  extension-field accumulators (2 base cols each):
                    hh (row Horner H), qq (quotient Horner Q), ff (DEEP
                    group sum F), sv/sw (FRI leaf value stashes), fd
                    (running fold), st_s (per-statement DEEP value stash)

The 22 partial rounds collapse through their affine structure
(_partial_affine). Row-to-row routing, Horner coefficients, domain points
and every compare are PUBLIC schedule columns derived from the wrapper's
public inputs (_Walk), computed identically by prover and verifier.

Device work: the witness trace is built on the given torch device
(expand_perm_states: csrc/poseidon.cu's round-state kernel on a card, the
plain round pieces on the CPU) and the wrap batch is an ordinary
prove_batch, so its Merkle trees, FRI layers and grinding go through the
Poseidon kernels on a CUDA device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import ntt as nttmod
from ..ops import poseidon as ps
from ..ops.ext import W, ext_add, ext_inv, ext_mul, ext_sub
from ..ops.goldilocks import GF, P, tensor_from_u64
from .air import Air, Frame

# ---------------------------------------------------------------------------
# Column layout
# ---------------------------------------------------------------------------

COL_IN = 0  # 12 lanes
COL_S = 12  # S1, S2, S3 (12 each)
COL_P = 48  # p4..p25 (22)
COL_W = 70  # w26..w29 (12 each)
N_PERM_COLS = 118

A_HH = N_PERM_COLS + 0  # 2
A_QQ = N_PERM_COLS + 2
A_FF = N_PERM_COLS + 4
A_SV = N_PERM_COLS + 6
A_SW = N_PERM_COLS + 8
A_FD = N_PERM_COLS + 10
A_ST = N_PERM_COLS + 12  # 2 per wrapped statement
N_FIXED_COLS = N_PERM_COLS + 12


def n_wrap_cols(n_statements: int) -> int:
    return N_FIXED_COLS + 2 * n_statements


# ---------------------------------------------------------------------------
# Poseidon partial-round affine machinery (host precompute)
# ---------------------------------------------------------------------------
# Basis: [S4_0..S4_11, q_4..q_25, 1] (35 entries). Every state lane during
# the partial rounds is affine over this basis because only lane 0 passes
# an S-box (its output becomes a fresh basis symbol q_r).

_BASIS = 12 + ps.PARTIAL_ROUNDS + 1  # 35


def _aff_unit(i: int) -> list[int]:
    v = [0] * _BASIS
    v[i] = 1
    return v


def _aff_const(c: int) -> list[int]:
    v = [0] * _BASIS
    v[-1] = c % P
    return v


def _aff_add(a: list[int], b: list[int]) -> list[int]:
    return [(x + y) % P for x, y in zip(a, b)]


@lru_cache(maxsize=1)
def _partial_affine():
    """Returns (p_rows, w26_rows): affine coefficient vectors (len 35 each)
    for the 22 partial-round lane-0 pre-S-box values p_r and the 12 lanes
    of the state entering round 26, over [S4 lanes, q symbols, 1]."""
    rc = ps.round_constants()
    mds = ps.mds_matrix()
    state = [_aff_unit(i) for i in range(ps.WIDTH)]
    p_rows = []
    for ri, r in enumerate(range(4, 4 + ps.PARTIAL_ROUNDS)):
        pre = [_aff_add(state[j], _aff_const(rc[r][j])) for j in range(ps.WIDTH)]
        p_rows.append(pre[0])
        pre[0] = _aff_unit(12 + ri)  # q_r replaces the S-boxed lane
        state = [
            [sum(mds[i][j] * pre[j][k] for j in range(ps.WIDTH)) % P for k in range(_BASIS)]
            for i in range(ps.WIDTH)
        ]
    return p_rows, state


# ---------------------------------------------------------------------------
# Algebra-generic Poseidon expressions (device prover and host verifier)
# ---------------------------------------------------------------------------


def _sbox_expr(x):
    x2 = x * x
    x3 = x2 * x
    x4 = x2 * x2
    return x3 * x4


def _mds_expr(alg, vec12):
    mds = ps.mds_matrix()
    sv = alg.stack(vec12)
    return [alg.weighted_sum(sv, mds[i]) for i in range(ps.WIDTH)]


def _full_round_expr(alg, state, r: int):
    rc = ps.round_constants()[r]
    pre = [state[j] + alg.const(rc[j]) for j in range(ps.WIDTH)]
    return _mds_expr(alg, [_sbox_expr(x) for x in pre])


def _perm_constraints_and_output(frame: Frame, alg):
    """Per-row permutation constraints + the output-state expression O
    (degree 7 in this row's columns). 106 constraints."""
    local = frame.local
    constraints = []
    s = [local[COL_IN + j] for j in range(ps.WIDTH)]
    for k in range(3):  # witnessed S1, S2, S3
        target = [local[COL_S + 12 * k + j] for j in range(ps.WIDTH)]
        expr = _full_round_expr(alg, s, k)
        constraints.extend(t - e for t, e in zip(target, expr))
        s = target
    s4 = _full_round_expr(alg, s, 3)
    q = [_sbox_expr(local[COL_P + r]) for r in range(ps.PARTIAL_ROUNDS)]
    basis = alg.stack(s4 + q + [alg.const(1)])
    p_rows, w26_rows = _partial_affine()
    for r in range(ps.PARTIAL_ROUNDS):
        constraints.append(local[COL_P + r] - alg.weighted_sum(basis, p_rows[r]))
    w26 = [local[COL_W + j] for j in range(ps.WIDTH)]
    for j in range(ps.WIDTH):
        constraints.append(w26[j] - alg.weighted_sum(basis, w26_rows[j]))
    s = w26
    for k in range(1, 4):  # witnessed w27, w28, w29
        target = [local[COL_W + 12 * k + j] for j in range(ps.WIDTH)]
        expr = _full_round_expr(alg, s, 25 + k)
        constraints.extend(t - e for t, e in zip(target, expr))
        s = target
    out = _full_round_expr(alg, s, 29)
    return constraints, out


# ---------------------------------------------------------------------------
# Batched expansion: permutation input states -> witness columns
# ---------------------------------------------------------------------------


def expand_perm_states(states: GF) -> GF:
    """(R, 12) permutation input states -> (106, R) witness columns
    [S1 ‖ S2 ‖ S3 ‖ p4..p25 ‖ w26..w29] matching the AIR layout (columns
    COL_S..N_PERM_COLS), the states the AIR witnesses (the reference's
    jitted lax.scan): ops/poseidon.py's plain round pieces for CPU states,
    its round-state kernel for CUDA ones."""
    x = states.v
    if x.device.type == "cpu":
        return GF(ps.expand_plain(x))
    if x.device.type == "cuda":
        return GF(ps.expand_cuda(x))
    raise ValueError(f"no Poseidon round states for device {x.device}")


# ---------------------------------------------------------------------------
# Shape: everything the wrapper's structure depends on
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StmtShape:
    n_rows: int
    n_cols: int
    n_aux: int
    n_chunks: int
    offsets: tuple[int, ...]

    @property
    def pt(self) -> int:  # padded trace section width
        return -(-self.n_cols // 8) * 8

    @property
    def pa(self) -> int:
        return -(-self.n_aux // 8) * 8


@dataclass(frozen=True)
class WrapShape:
    statements: tuple[StmtShape, ...]
    rate_bits: int
    cap_bits: int
    n_queries: int
    final_poly_len: int
    shift: int

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(st.n_rows << self.rate_bits for st in self.statements)

    @property
    def n_max(self) -> int:
        return max(self.sizes)

    @property
    def n_layers(self) -> int:
        from .fri import FriConfig, _batch_layer_count

        cfg = FriConfig(
            rate_bits=self.rate_bits,
            n_queries=self.n_queries,
            final_poly_len=self.final_poly_len,
            cap_bits=self.cap_bits,
        )
        return _batch_layer_count(list(self.sizes), cfg)

    def stmt_cap_len(self, s: int) -> int:
        N = self.sizes[s]
        return 1 << min(self.cap_bits, max(N.bit_length() - 1, 0))

    def stmt_levels(self, s: int) -> int:
        from ..ops.merkle import cap_levels

        return cap_levels(self.sizes[s], self.cap_bits)

    def layer_size(self, l: int) -> int:
        return self.n_max >> l

    def layer_cap_len(self, l: int) -> int:
        size = self.layer_size(l)
        return 1 << min(self.cap_bits, max(size.bit_length() - 1, 0))

    def layer_levels(self, l: int) -> int:
        from ..ops.merkle import cap_levels

        return cap_levels(self.layer_size(l), self.cap_bits)

    def entry_layers(self) -> dict[int, list[int]]:
        """layer index -> statement indices whose codeword enters there,
        in the verifier's (descending-size, stable) injection order."""
        from .fri import batch_entry_order

        sizes = list(self.sizes)
        order = batch_entry_order(sizes)
        entry: dict[int, list[int]] = {}
        oi = 0
        cur = self.n_max
        for l in range(self.n_layers + 1):
            while oi < len(order) and sizes[order[oi]] == cur:
                entry.setdefault(l, []).append(order[oi])
                oi += 1
            cur //= 2
        if oi != len(order):
            raise ValueError("inconsistent batch sizes")
        return entry


def wrap_shape(airs, config, n_rows_list) -> WrapShape:
    """Shape from the wrapped batch's AIRs + StarkConfig + statement trace
    lengths (batch order)."""
    return WrapShape(
        statements=tuple(
            StmtShape(
                n_rows=int(n),
                n_cols=air.n_cols,
                n_aux=air.n_aux_cols,
                n_chunks=air.constraint_degree - 1,
                offsets=tuple(air.frame_offsets),
            )
            for air, n in zip(airs, n_rows_list)
        ),
        rate_bits=config.rate_bits,
        cap_bits=config.cap_bits,
        n_queries=config.n_queries,
        final_poly_len=config.final_poly_len,
        shift=config.shift,
    )


# ---------------------------------------------------------------------------
# Public-input vector layout
# ---------------------------------------------------------------------------


@dataclass
class WrapPublics:
    """Parsed wrapper public inputs. The outer verifier assembles the same
    vector from its native transcript replay; build_publics/parse_publics
    define the canonical order."""

    trace_caps: list  # per stmt: list of 4-int digests
    aux_caps: list  # per stmt: digests | None
    quot_caps: list
    betas: list  # per stmt ext
    zs: list  # per stmt ext
    g0s: list  # per stmt: per offset group ext
    layer_caps: list  # per layer: digests
    lambdas: list  # per stmt ext
    layer_betas: list  # per layer ext
    query_indices: list  # ints
    final_vals: list  # per query ext


def publics_len(shape: WrapShape) -> int:
    total = 0
    for s, st in enumerate(shape.statements):
        trees = 2 + (1 if st.n_aux else 0)
        total += trees * shape.stmt_cap_len(s) * 4
        total += 4  # beta, z
        total += 2 * len(st.offsets)  # G0 per group
    for l in range(shape.n_layers):
        total += shape.layer_cap_len(l) * 4
    total += 2 * len(shape.statements)  # lambdas
    total += 2 * shape.n_layers  # layer betas
    total += shape.n_queries
    total += 2 * shape.n_queries  # final values
    return total


def build_publics(shape: WrapShape, pub: WrapPublics) -> list[int]:
    out: list[int] = []
    for s, st in enumerate(shape.statements):
        for d in pub.trace_caps[s]:
            out.extend(int(v) % P for v in d)
        if st.n_aux:
            for d in pub.aux_caps[s]:
                out.extend(int(v) % P for v in d)
        for d in pub.quot_caps[s]:
            out.extend(int(v) % P for v in d)
        out.extend(int(v) % P for v in pub.betas[s])
        out.extend(int(v) % P for v in pub.zs[s])
        for g in pub.g0s[s]:
            out.extend(int(v) % P for v in g)
    for l in range(shape.n_layers):
        for d in pub.layer_caps[l]:
            out.extend(int(v) % P for v in d)
    for lam in pub.lambdas:
        out.extend(int(v) % P for v in lam)
    for b in pub.layer_betas:
        out.extend(int(v) % P for v in b)
    out.extend(int(v) for v in pub.query_indices)
    for fv in pub.final_vals:
        out.extend(int(v) % P for v in fv)
    if len(out) != publics_len(shape):
        raise ValueError("publics layout mismatch")
    return out


def parse_publics(shape: WrapShape, publics: list[int]) -> WrapPublics:
    if len(publics) != publics_len(shape):
        raise ValueError("bad wrapper publics length")
    vals = [int(v) for v in publics]
    if any(not 0 <= v < P for v in vals):
        raise ValueError("wrapper public out of range")
    pos = 0

    def take(k):
        nonlocal pos
        out = vals[pos : pos + k]
        pos += k
        return out

    def take_cap(k):
        flat = take(4 * k)
        return [flat[4 * i : 4 * i + 4] for i in range(k)]

    tc, ac, qc, betas, zs, g0s = [], [], [], [], [], []
    for s, st in enumerate(shape.statements):
        cl = shape.stmt_cap_len(s)
        tc.append(take_cap(cl))
        ac.append(take_cap(cl) if st.n_aux else None)
        qc.append(take_cap(cl))
        betas.append(tuple(take(2)))
        zs.append(tuple(take(2)))
        g0s.append([tuple(take(2)) for _ in st.offsets])
    lc = [take_cap(shape.layer_cap_len(l)) for l in range(shape.n_layers)]
    lambdas = [tuple(take(2)) for _ in shape.statements]
    lbetas = [tuple(take(2)) for _ in range(shape.n_layers)]
    qidx = take(shape.n_queries)
    if any(not 0 <= q < shape.n_max for q in qidx):
        raise ValueError("query index out of range")
    fvals = [tuple(take(2)) for _ in range(shape.n_queries)]
    return WrapPublics(
        trace_caps=tc, aux_caps=ac, quot_caps=qc, betas=betas, zs=zs,
        g0s=g0s, layer_caps=lc, lambdas=lambdas, layer_betas=lbetas,
        query_indices=qidx, final_vals=fvals,
    )


# ---------------------------------------------------------------------------
# Public schedule columns
# ---------------------------------------------------------------------------

# Default-1 columns: accumulator keep gates. All are zeroed on the LAST
# row so the cyclic wrap resets every accumulator into row 0 (whose
# values eval_first pins to zero). kst guards the stashes (st/sv/sw),
# which otherwise carry unconditionally.
_KEEP_COLS = ("kh", "kq", "kf", "kfd", "kst")


@lru_cache(maxsize=8)
def _pub_names(n_statements: int) -> tuple[str, ...]:
    names = [
        "dL", "dR", "g_cc", "g_fc", "g_cmp",
        "gcapv0", "gcapv1", "gcapv2", "gcapv3",
        "kh", "kq", "kf", "kfd",
        "A1_0", "A1_1", "A2_0", "A2_1", "A3_0", "A3_1",
        "gsv", "gsw", "gfoldh", "fB_0", "fB_1", "gpick", "gpickn",
        "gfin", "gfv_0", "gfv_1", "kst",
    ]
    names += [f"cH{j}_{c}" for j in range(8) for c in (0, 1)]
    names += [f"cQ{j}_{c}" for j in range(8) for c in (0, 1)]
    names += [f"gst{s}" for s in range(n_statements)]
    names += [f"ginj{s}_{c}" for s in range(n_statements) for c in (0, 1)]
    return tuple(names)


def schedule_len(shape: WrapShape) -> int:
    """Scheduled row count (before pow-2 padding): a function of the shape
    ONLY (never of the concrete indices), so the verifier knows n_rows."""
    per_q = 0
    for s, st in enumerate(shape.statements):
        lv = shape.stmt_levels(s)
        per_q += st.pt // 8 + lv
        if st.n_aux:
            per_q += st.pa // 8 + lv
        per_q += 1 + lv  # quotient leaf is a single chunk
        per_q += len(st.offsets) + 1  # group transitions + stash row
    for l in range(shape.n_layers):
        per_q += 2 * (1 + shape.layer_levels(l)) + 1  # two openings + fold row
    per_q += 1  # final compare row
    return 1 + shape.n_queries * per_q + 1  # leading idle + trailing idle


def wrap_n_rows(shape: WrapShape) -> int:
    n = schedule_len(shape)
    return 1 << max(n - 1, 3).bit_length()


class _Walk:
    """Single-source schedule walk. Emits the public schedule columns
    always; when given the batch proof, also emits the witness (permutation
    input states + accumulator columns), mirroring the constraint system
    transition by transition so prover and verifier can never drift."""

    def __init__(self, shape: WrapShape, pub: WrapPublics, proof=None):
        self.shape = shape
        self.pub = pub
        self.proof = proof
        self.wit = proof is not None
        self.names = _pub_names(len(shape.statements))
        self.sparse: dict[str, dict[int, int]] = {m: {} for m in self.names}
        self.n = 0
        self.pending: dict[str, int] = {}
        if self.wit:
            k = len(shape.statements)
            self.states: list[list[int]] = []
            self.prev_out: list[int] | None = None
            self.acc = {
                "hh": (0, 0), "qq": (0, 0), "ff": (0, 0),
                "sv": (0, 0), "sw": (0, 0), "fd": (0, 0),
                "st": [(0, 0)] * k,
            }
            self.acc_rows: list[list[int]] = []

    # -- low-level emission --

    def _set(self, row: int, name: str, val: int):
        if row < 0:
            raise ValueError("transition gate before row 0")
        self.sparse[name][row] = val % P

    def _new_row(self, trans: dict, in_state=None, local: dict | None = None):
        merged = dict(self.pending)
        for k, v in trans.items():
            if k in merged:
                raise ValueError(f"conflicting gate {k}")
            merged[k] = v
        self.pending = {}
        if self.n == 0:
            if merged:
                raise ValueError("row 0 cannot receive a transition")
        else:
            for k, v in merged.items():
                self._set(self.n - 1, k, v)
        r = self.n
        self.n += 1
        if local:
            for k, v in local.items():
                self._set(r, k, v)
        if self.wit:
            if in_state is None:
                in_state = [0] * 12
            self._acc_step(merged, in_state)
            self.states.append([v % P for v in in_state])
            self.prev_out = ps.permute_ints(in_state)
            a = self.acc
            self.acc_rows.append(
                [*a["hh"], *a["qq"], *a["ff"], *a["sv"], *a["sw"], *a["fd"]]
                + [v for stv in a["st"] for v in stv]
            )
        return r

    def _acc_step(self, g: dict, next_in: list[int]):
        """Mirror of the accumulator transition constraints (R4-R10)."""
        if self.n == 0:
            return  # row 0 accumulators start at zero
        a = self.acc
        kh = g.get("kh", 1)
        kq = g.get("kq", 1)
        kf = g.get("kf", 1)
        kfd = g.get("kfd", 1)
        kst = g.get("kst", 1)
        ssh = [0, 0]
        ssq = [0, 0]
        for j in range(8):
            v = next_in[j] % P
            ssh[0] = (ssh[0] + g.get(f"cH{j}_0", 0) * v) % P
            ssh[1] = (ssh[1] + g.get(f"cH{j}_1", 0) * v) % P
            ssq[0] = (ssq[0] + g.get(f"cQ{j}_0", 0) * v) % P
            ssq[1] = (ssq[1] + g.get(f"cQ{j}_1", 0) * v) % P
        hh = a["hh"]
        qq = a["qq"]
        ff = a["ff"]
        new_hh = ((kh * hh[0] + ssh[0]) % P, (kh * hh[1] + ssh[1]) % P)
        new_qq = ((kq * qq[0] + ssq[0]) % P, (kq * qq[1] + ssq[1]) % P)
        A1 = (g.get("A1_0", 0), g.get("A1_1", 0))
        A2 = (g.get("A2_0", 0), g.get("A2_1", 0))
        A3 = (g.get("A3_0", 0), g.get("A3_1", 0))
        new_ff = ext_add(
            (kf * ff[0] % P, kf * ff[1] % P),
            ext_sub(ext_add(ext_mul(A1, hh), ext_mul(A2, qq)), A3),
        )
        new_st = []
        for s, st in enumerate(a["st"]):
            gs = g.get(f"gst{s}", 0)
            new_st.append(
                (
                    kst * (st[0] + gs * (ff[0] - st[0])) % P,
                    kst * (st[1] + gs * (ff[1] - st[1])) % P,
                )
            )
        gsv = g.get("gsv", 0)
        gsw = g.get("gsw", 0)
        sv, sw, fd = a["sv"], a["sw"], a["fd"]
        new_sv = (
            kst * (sv[0] + gsv * (next_in[0] - sv[0])) % P,
            kst * (sv[1] + gsv * (next_in[1] - sv[1])) % P,
        )
        new_sw = (
            kst * (sw[0] + gsw * (next_in[0] - sw[0])) % P,
            kst * (sw[1] + gsw * (next_in[1] - sw[1])) % P,
        )
        gfo = g.get("gfoldh", 0)
        fB = (g.get("fB_0", 0), g.get("fB_1", 0))
        new_fd = ext_add(
            (kfd * fd[0] % P, kfd * fd[1] % P),
            ext_add(
                (gfo * (sv[0] + sw[0]) % P, gfo * (sv[1] + sw[1]) % P),
                ext_mul(fB, ext_sub(sv, sw)),
            ),
        )
        for s in range(len(a["st"])):
            lam = (g.get(f"ginj{s}_0", 0), g.get(f"ginj{s}_1", 0))
            new_fd = ext_add(new_fd, ext_mul(lam, a["st"][s]))
        a["hh"], a["qq"], a["ff"] = new_hh, new_qq, new_ff
        a["sv"], a["sw"], a["fd"], a["st"] = new_sv, new_sw, new_fd, new_st

    # -- block emitters --

    def absorb(self, data8, fresh: bool, trans: dict):
        t = dict(trans)
        t["g_fc" if fresh else "g_cc"] = 1
        in_state = None
        if self.wit:
            cap = [0] * 4 if fresh else list(self.prev_out[8:12])
            in_state = [v % P for v in data8] + cap
        self._new_row(t, in_state)

    def node(self, dirbit: int, sibling):
        t = {"g_fc": 1, ("dR" if dirbit else "dL"): 1}
        in_state = None
        if self.wit:
            dig = list(self.prev_out[:4])
            sib = [v % P for v in sibling]
            in_state = (sib + dig if dirbit else dig + sib) + [0] * 4
        self._new_row(t, in_state)

    def cmp_cap(self, digest4):
        r = self.n - 1
        self._set(r, "g_cmp", 1)
        for j in range(4):
            self._set(r, f"gcapv{j}", int(digest4[j]))
        if self.wit and list(self.prev_out[:4]) != [int(v) % P for v in digest4]:
            raise ValueError("witness digest does not match the cap")

    def open_block(
        self, leaf_row, path, levels: int, cap, idx: int,
        coefs=None, coef_kind: str = "cH", first_trans: dict | None = None,
    ):
        """Absorb a (pre-padded) leaf row, climb its path, compare to the
        cap slot. coefs: per-chunk list of 8 ext tuples (Horner weights)."""
        row = list(leaf_row) + [0] * ((-len(leaf_row)) % 8)
        for c in range(len(row) // 8):
            t = dict(first_trans) if (c == 0 and first_trans) else {}
            if coefs is not None:
                for j in range(8):
                    e = coefs[c][j]
                    t[f"{coef_kind}{j}_0"] = e[0]
                    t[f"{coef_kind}{j}_1"] = e[1]
            self.absorb(row[8 * c : 8 * c + 8], fresh=(c == 0), trans=t)
        cur = idx
        for lv in range(levels):
            self.node(cur & 1, path[lv] if self.wit else None)
            cur >>= 1
        self.cmp_cap(cap[idx >> levels])

    # -- full schedule --

    def run(self):
        shape, pub = self.shape, self.pub
        from .prover import _beta_powers, deep_power_layout

        self._new_row({})  # row 0: idle
        n_max = shape.n_max
        entry = shape.entry_layers()
        n_layers = shape.n_layers
        inv2 = pow(2, P - 2, P)

        # Per-statement precomputes.
        stmt_pows = []
        stmt_layout = []
        for s, st in enumerate(shape.statements):
            bases, chunk_base, _pos = deep_power_layout(
                st.n_cols, st.n_aux, st.n_chunks, len(st.offsets)
            )
            stmt_pows.append(_beta_powers(pub.betas[s], max(bases) + chunk_base + st.n_chunks + 1))
            stmt_layout.append((bases, chunk_base))

        for qi in range(shape.n_queries):
            q = pub.query_indices[qi]
            for s, st in enumerate(shape.statements):
                self._statement_block(s, st, q, stmt_pows[s], stmt_layout[s])
            # ---- batch FRI query walk ----
            idx = q
            cur_shift = shape.shift % P
            # entering layer 0: reset the fold accumulator + inject entrants
            self.pending["kfd"] = 0
            for si in entry.get(0, ()):
                lam = pub.lambdas[si]
                self.pending[f"ginj{si}_0"] = lam[0]
                self.pending[f"ginj{si}_1"] = lam[1]
            for l in range(n_layers):
                size = n_max >> l
                half = size // 2
                i = idx % half
                j = i + half
                lev = shape.layer_levels(l)
                cap = pub.layer_caps[l]
                vi = vj = pi = pj = None
                if self.wit:
                    vi, vj, pi, pj = self.proof.fri_proof.query_rounds[qi][l]
                self.open_block(
                    [vi[0], vi[1]] if self.wit else [0, 0],
                    pi, lev, cap, i, first_trans={"gsv": 1},
                )
                self.open_block(
                    [vj[0], vj[1]] if self.wit else [0, 0],
                    pj, lev, cap, j, first_trans={"gsw": 1},
                )
                # fold row: local compare of the running expected value
                # against the opened value at the running index, then the
                # fold transition rides into the next block.
                pick = 1 if idx < half else 0
                self._new_row({}, local={"gpick": pick, "gpickn": 1 - pick})
                if self.wit:
                    want = self.acc["sv"] if pick else self.acc["sw"]
                    if self.acc["fd"] != want:
                        raise ValueError("fold check fails on witness")
                w = nttmod.primitive_root_of_unity(size.bit_length() - 1)
                x_i = cur_shift * pow(w, i, P) % P
                inv2x = pow(2 * x_i % P, P - 2, P)
                bl = pub.layer_betas[l]
                self.pending["kfd"] = 0
                self.pending["gfoldh"] = inv2
                self.pending["fB_0"] = bl[0] * inv2x % P
                self.pending["fB_1"] = bl[1] * inv2x % P
                for si in entry.get(l + 1, ()):
                    lam = pub.lambdas[si]
                    self.pending[f"ginj{si}_0"] = lam[0]
                    self.pending[f"ginj{si}_1"] = lam[1]
                idx = i
                cur_shift = cur_shift * cur_shift % P
            # final compare row
            fv = pub.final_vals[qi]
            self._new_row({}, local={"gfin": 1, "gfv_0": fv[0], "gfv_1": fv[1]})
            if self.wit and self.acc["fd"] != (fv[0] % P, fv[1] % P):
                raise ValueError("final-poly check fails on witness")
        self._new_row({})  # trailing idle row
        if self.n != schedule_len(shape):
            raise AssertionError(f"schedule length drifted: {self.n} != {schedule_len(shape)}")

    def _statement_block(self, s, st: StmtShape, q: int, pows, layout):
        shape, pub = self.shape, self.pub
        bases, chunk_base = layout
        N_s = shape.sizes[s]
        idx = q % N_s
        lev = shape.stmt_levels(s)
        if self.wit:
            opening = self.proof.statements[s].openings.get(idx)
            if opening is None:
                raise ValueError("missing statement opening")
            trow, tpath, arow, apath, qrow, qpath = opening
            if len(trow) != st.n_cols or len(arow) != st.n_aux:
                raise ValueError("bad opening row width")
            if len(qrow) != 2 * st.n_chunks:
                raise ValueError("bad quotient row width")
        # trace leaf: H Horner restarts here
        tc = [[pows[8 * c + j] for j in range(8)] for c in range(st.pt // 8)]
        self.open_block(
            [v % P for v in trow] if self.wit else [0] * st.n_cols,
            tpath if self.wit else None, lev, pub.trace_caps[s], idx,
            coefs=tc, first_trans={"kh": 0},
        )
        if st.n_aux:
            ac = [[pows[st.pt + 8 * c + j] for j in range(8)] for c in range(st.pa // 8)]
            self.open_block(
                [v % P for v in arow] if self.wit else [0] * st.n_aux,
                apath if self.wit else None, lev, pub.aux_caps[s], idx,
                coefs=ac,
            )
        # quotient leaf: one chunk, ext-interleaved coefficients, Q restart
        u_pow = [(1, 0), (0, 1)]
        qc = [
            [
                ext_mul(pows[chunk_base + (j // 2)], u_pow[j & 1]) if j < 2 * st.n_chunks else (0, 0)
                for j in range(8)
            ]
        ]
        self.open_block(
            [v % P for v in qrow] if self.wit else [0] * (2 * st.n_chunks),
            qpath if self.wit else None, lev, pub.quot_caps[s], idx,
            coefs=qc, coef_kind="cQ", first_trans={"kq": 0},
        )
        # group transitions: ff += (beta^base_g (x) H + [g==0] Q - G0_g)
        #                          (x) inv(x - z_g)
        g_s = nttmod.primitive_root_of_unity(st.n_rows.bit_length() - 1)
        w_Ns = nttmod.primitive_root_of_unity(N_s.bit_length() - 1)
        shift_s = pow(shape.shift, shape.n_max // N_s, P)
        x = shift_s * pow(w_Ns, idx, P) % P
        z_s = pub.zs[s]
        for g, off in enumerate(st.offsets):
            zk = ext_mul(z_s, (pow(g_s, off, P), 0))
            inv = ext_inv(ext_sub((x, 0), zk))
            a1 = ext_mul(pows[bases[g]], inv)
            a3 = ext_mul(pub.g0s[s][g], inv)
            t = {"A1_0": a1[0], "A1_1": a1[1], "A3_0": a3[0], "A3_1": a3[1]}
            if g == 0:
                t["kf"] = 0
                t["A2_0"] = inv[0]
                t["A2_1"] = inv[1]
            self.pending.update(t)
            self._new_row({})
        self.pending[f"gst{s}"] = 1
        self._new_row({})  # stash row: st_s latches F_s on the transition out

    # -- outputs --

    def pub_columns(self, n: int) -> list[np.ndarray]:
        """The public schedule columns over n rows, as uint64 arrays of
        canonical values."""
        if self.n > n:
            raise ValueError("schedule does not fit the trace length")
        cols = []
        for name in self.names:
            keep = name in _KEEP_COLS
            col = np.full(n, 1 if keep else 0, dtype=np.uint64)
            sparse = self.sparse[name]
            if sparse:
                col[list(sparse)] = np.array(list(sparse.values()), dtype=np.uint64)
            if keep:
                col[n - 1] = 0  # cyclic wrap resets accumulators into row 0
            cols.append(col)
        return cols

    def witness_trace(self, n: int, device) -> GF:
        """The full (n_cols, n) committed trace on `device`."""
        if not self.wit:
            raise ValueError("walk ran without a proof")
        R = self.n
        st_arr = np.zeros((n, 12), dtype=np.uint64)
        st_arr[:R] = np.array(self.states, dtype=np.uint64)
        states = GF(tensor_from_u64(st_arr, device))
        with record_function("expand_perm_states"):  # a range for torch.profiler
            perm_cols = expand_perm_states(states)  # (106, n)
        acc_arr = np.zeros((n, len(self.acc_rows[0])), dtype=np.uint64)
        acc_arr[:R] = np.array(self.acc_rows, dtype=np.uint64)
        acc_arr[R:] = acc_arr[R - 1]  # idle tail: accumulators carry their last value
        acc_cols = tensor_from_u64(np.ascontiguousarray(acc_arr.T), device)
        return GF(torch.cat([states.v.t(), perm_cols.v, acc_cols], dim=0).contiguous())


# ---------------------------------------------------------------------------
# The wrapper AIR
# ---------------------------------------------------------------------------


def _pub_walk(shape: WrapShape, publics: list[int]) -> _Walk:
    w = _Walk(shape, parse_publics(shape, list(publics)))
    w.run()
    return w


class WrapAir(Air):
    """Constraint system for the schedule emitted by _Walk (see module
    docstring). One Poseidon permutation per row; routing, Horner
    accumulation, FRI folding and every compare are gated by PUBLIC
    schedule columns derived from the public inputs."""

    constraint_degree = 8
    frame_offsets = [0, 1]

    def __init__(self, shape: WrapShape):
        self.shape = shape
        k = len(shape.statements)
        self.n_cols = n_wrap_cols(k)
        self.n_public = publics_len(shape)
        self._names = _pub_names(k)
        self.n_public_cols = len(self._names)
        self._pi = {m: i for i, m in enumerate(self._names)}
        # at most two walks, keyed by the full publics vector; wrap_batch
        # primes it with the witness walk so the prover does not re-run it
        self._pub_cache: dict = {}

    def validate_publics(self, publics) -> bool:
        try:
            parse_publics(self.shape, list(publics))
        except (ValueError, TypeError, KeyError, IndexError):
            return False
        return True

    def public_columns(self, publics: list[int], n_rows: int):
        key = tuple(int(v) for v in publics)
        walk = self._pub_cache.get(key)
        if walk is None:
            walk = _pub_walk(self.shape, publics)
            if len(self._pub_cache) >= 2:
                self._pub_cache.clear()
            self._pub_cache[key] = walk
        return walk.pub_columns(n_rows)

    # -- constraint helpers --

    def _pc(self, frame, name):
        return frame.public_cols[self._pi[name]]

    @staticmethod
    def _emul_pp(alg, a, b):
        """(a0 + a1 u)(b0 + b1 u) with u^2 = W: returns component pair."""
        return (
            a[0] * b[0] + alg.cmul(W, a[1] * b[1]),
            a[0] * b[1] + a[1] * b[0],
        )

    def eval_cyclic(self, frame: Frame, alg):
        pc = lambda m: self._pc(frame, m)
        local, nxt = frame.local, frame.next
        cons, O = _perm_constraints_and_output(frame, alg)

        # R1: Merkle path digest routing (previous digest left or right)
        dL, dR = pc("dL"), pc("dR")
        for j in range(4):
            cons.append(dL * (nxt[COL_IN + j] - O[j]) + dR * (nxt[COL_IN + 4 + j] - O[j]))
        # R2: capacity lanes, carried (absorb continuation) or zeroed
        g_cc, g_fc = pc("g_cc"), pc("g_fc")
        for j in range(4):
            cons.append(g_cc * (nxt[COL_IN + 8 + j] - O[8 + j]) + g_fc * nxt[COL_IN + 8 + j])
        # R3: cap compare (digest of this row == public cap slot value)
        g_cmp = pc("g_cmp")
        for j in range(4):
            cons.append(g_cmp * O[j] - pc(f"gcapv{j}"))
        # R4/R5: DEEP row/quotient Horner accumulators over absorbed lanes
        for tgt, coef, keep in ((A_HH, "cH", "kh"), (A_QQ, "cQ", "kq")):
            kcol = pc(keep)
            for c in range(2):
                ss = None
                for j in range(8):
                    term = pc(f"{coef}{j}_{c}") * nxt[COL_IN + j]
                    ss = term if ss is None else ss + term
                cons.append(nxt[tgt + c] - kcol * local[tgt + c] - ss)
        # R6: DEEP group sum ff' = kf*ff + A1(x)hh + A2(x)qq - A3
        kf = pc("kf")
        a1 = (pc("A1_0"), pc("A1_1"))
        a2 = (pc("A2_0"), pc("A2_1"))
        a3 = (pc("A3_0"), pc("A3_1"))
        hh = (local[A_HH], local[A_HH + 1])
        qq = (local[A_QQ], local[A_QQ + 1])
        t1 = self._emul_pp(alg, a1, hh)
        t2 = self._emul_pp(alg, a2, qq)
        for c in range(2):
            cons.append(nxt[A_FF + c] - kf * local[A_FF + c] - t1[c] - t2[c] + a3[c])
        # R7: per-statement DEEP value stash (kst = 0 only on the last
        # row, resetting the stash into row 0 across the cyclic wrap)
        kst = pc("kst")
        for s in range(len(self.shape.statements)):
            gs = pc(f"gst{s}")
            for c in range(2):
                stc = local[A_ST + 2 * s + c]
                cons.append(nxt[A_ST + 2 * s + c] - kst * (stc + gs * (local[A_FF + c] - stc)))
        # R8/R9: FRI leaf value stashes (lanes 0/1 of the absorb row)
        for tgt, gate in ((A_SV, "gsv"), (A_SW, "gsw")):
            g = pc(gate)
            for c in range(2):
                cons.append(
                    nxt[tgt + c] - kst * (local[tgt + c] + g * (nxt[COL_IN + c] - local[tgt + c]))
                )
        # R10: fold accumulator
        kfd = pc("kfd")
        gfo = pc("gfoldh")
        fB = (pc("fB_0"), pc("fB_1"))
        sv = (local[A_SV], local[A_SV + 1])
        sw = (local[A_SW], local[A_SW + 1])
        diff = (sv[0] - sw[0], sv[1] - sw[1])
        tb = self._emul_pp(alg, fB, diff)
        inj = [None, None]
        for s in range(len(self.shape.statements)):
            lam = (pc(f"ginj{s}_0"), pc(f"ginj{s}_1"))
            stv = (local[A_ST + 2 * s], local[A_ST + 2 * s + 1])
            ti = self._emul_pp(alg, lam, stv)
            for c in range(2):
                inj[c] = ti[c] if inj[c] is None else inj[c] + ti[c]
        for c in range(2):
            cons.append(
                nxt[A_FD + c] - kfd * local[A_FD + c] - gfo * (sv[c] + sw[c]) - tb[c] - inj[c]
            )
        # R11: fold compare (opened value at the running index == expected)
        gp, gpn = pc("gpick"), pc("gpickn")
        for c in range(2):
            cons.append(gp * (sv[c] - local[A_FD + c]) + gpn * (sw[c] - local[A_FD + c]))
        # R12: final compare (fold value == final-poly evaluation)
        gfin = pc("gfin")
        for c in range(2):
            cons.append(gfin * local[A_FD + c] - pc(f"gfv_{c}"))
        return cons

    def eval_first(self, frame: Frame, alg):
        k = len(self.shape.statements)
        return [frame.local[N_PERM_COLS + c] for c in range(12 + 2 * k)]


# ---------------------------------------------------------------------------
# Wrapping a batch proof / verifying a wrapped batch
# ---------------------------------------------------------------------------


@dataclass
class WrappedBatchProof:
    """A BatchStarkProof with openings and FRI query rounds replaced by a
    two-statement wrap batch: the WrapAir query-phase proof and the
    EvalAir OOD-evaluation proof, sharing one transcript and one FRI.
    Everything remaining is independent of the wrapped statements' trace
    sizes."""

    statements: list  # batch.StatementProof, openings == {}
    layer_caps: list
    final_poly: list
    pow_nonce: int
    wrapper: object  # batch.BatchStarkProof for [WrapAir, EvalAir]


def _final_values(shape: WrapShape, final_poly, query_indices):
    """Final-polynomial evaluations at each query's residual domain point
    (the value fri_verify_batch compares the last fold against)."""
    n_layers = shape.n_layers
    size = shape.n_max >> n_layers
    shift_f = pow(shape.shift, 1 << n_layers, P)
    w = nttmod.primitive_root_of_unity(size.bit_length() - 1)
    out = []
    for q in query_indices:
        pt = shift_f * pow(w, q % size, P) % P
        acc = (0, 0)
        for c in reversed(final_poly):
            acc = ext_add(ext_mul(acc, (pt, 0)), tuple(c))
        out.append(acc)
    return out


def _assemble_publics(
    shape, statements, layer_caps, final_poly, ctxs, lambdas, layer_betas, query_indices,
) -> WrapPublics:
    return WrapPublics(
        trace_caps=[st.trace_cap for st in statements],
        aux_caps=[st.aux_cap for st in statements],
        quot_caps=[st.quotient_cap for st in statements],
        betas=[c.beta for c in ctxs],
        zs=[c.z for c in ctxs],
        g0s=[c.g0s for c in ctxs],
        layer_caps=layer_caps,
        lambdas=lambdas,
        layer_betas=layer_betas,
        query_indices=list(query_indices),
        final_vals=_final_values(shape, final_poly, query_indices),
    )


def wrap_batch(airs, proof, config, transcript_seed=None, wrap_config=None, *, device=None, mesh=None):
    """Prove the wrap batch ([WrapAir, EvalAir]) for a (valid)
    BatchStarkProof on `device` and return the WrappedBatchProof. Raises
    ValueError if the input proof does not verify: the witness walk
    re-checks every digest, fold and final value, and the eval tape
    reaches its asserted zeros only on a sound OOD identity. mesh:
    optional LaneMesh the wrap batch is proven over (prove_batch's mesh=;
    `device`, if given, must be its first device), to the same bytes."""
    from ..parallel.sharding import mesh_device

    device = mesh_device(device, mesh)
    from .batch import prove_batch
    from .challenger import Challenger
    from .evalair import EvalAir, assemble_inputs, tape_for
    from .fri import fri_replay_batch
    from .verifier import ood_identity, replay_statement

    if wrap_config is None:
        wrap_config = default_wrap_config()
    challenger = Challenger()
    if transcript_seed:
        challenger.observe_elements(transcript_seed)
    sizes = [st.n_rows << config.rate_bits for st in proof.statements]
    n_max = max(sizes)
    ctxs = []
    for air, stmt, N_i in zip(airs, proof.statements, sizes):
        shift_i = pow(config.shift, n_max // N_i, P)
        ctx = replay_statement(air, stmt, config, challenger, shift_i)
        if ctx is None or not ood_identity(air, stmt, ctx):
            raise ValueError("statement fails transcript/OOD checks")
        ctxs.append(ctx)
    replay = fri_replay_batch(proof.fri_proof, sizes, challenger, config.fri)
    if replay is None:
        raise ValueError("batch FRI replay fails")
    lambdas, _entry, layer_betas, query_indices, _nl = replay

    shape = wrap_shape(airs, config, [st.n_rows for st in proof.statements])
    pub = _assemble_publics(
        shape, proof.statements, proof.fri_proof.layer_caps, proof.fri_proof.final_poly,
        ctxs, lambdas, layer_betas, query_indices,
    )
    publics = build_publics(shape, pub)
    walk = _Walk(shape, pub, proof)
    walk.run()
    trace = walk.witness_trace(wrap_n_rows(shape), device)
    air_w = WrapAir(shape)
    # the witness walk's schedule IS the public-column walk
    air_w._pub_cache[tuple(publics)] = walk

    # EvalAir statement: the wrapped statements' OOD identities, in-circuit
    tape = tape_for(airs)
    air_e = EvalAir(tape)
    e_inputs = assemble_inputs(tape, ctxs)
    e_trace = air_e.witness_trace(e_inputs, device)

    wrapper = prove_batch([air_w, air_e], [trace, e_trace], [publics, e_inputs], wrap_config, mesh=mesh)
    return WrappedBatchProof(
        statements=[replace(st, openings={}) for st in proof.statements],
        layer_caps=[list(c) for c in proof.fri_proof.layer_caps],
        final_poly=[tuple(c) for c in proof.fri_proof.final_poly],
        pow_nonce=int(proof.fri_proof.pow_nonce),
        wrapper=wrapper,
    )


def default_wrap_config():
    """100 conjectured bits (4*21 + 16), tuned for wire size: the wrapper
    proof is the deliverable, so a higher rate buys fewer queries, a
    taller cap cuts a path level from every opening, and a longer final
    poly drops the two smallest FRI layers."""
    from .prover import StarkConfig

    return StarkConfig(
        rate_bits=4, n_queries=21, final_poly_len=64, proof_of_work_bits=16, cap_bits=5,
    )


def verify_wrapped_batch(airs, wrapped: WrappedBatchProof, config, transcript_seed=None, wrap_config=None) -> bool:
    """Outer verifier: native transcript replay over the wire header, then
    ONE wrap-batch verification standing in for every Merkle opening,
    DEEP recomputation, FRI fold and OOD identity. False on any failure,
    never an exception (same contract as batch.verify_batch)."""
    try:
        return _verify_wrapped_inner(airs, wrapped, config, transcript_seed, wrap_config)
    except (ValueError, AssertionError, KeyError, IndexError, TypeError, OverflowError, AttributeError):
        return False


def _verify_wrapped_inner(airs, wrapped, config, transcript_seed, wrap_config) -> bool:
    from .batch import BatchStarkProof, verify_batch
    from .challenger import Challenger
    from .evalair import EvalAir, assemble_inputs, tape_for
    from .fri import FriProof, fri_replay_batch
    from .verifier import replay_statement

    if wrap_config is None:
        wrap_config = default_wrap_config()
    if len(airs) != len(wrapped.statements) or not airs:
        return False
    for st in wrapped.statements:
        if st.openings:  # wrapped statements must not smuggle openings
            return False
    challenger = Challenger()
    if transcript_seed:
        challenger.observe_elements(transcript_seed)
    sizes = []
    for stmt in wrapped.statements:
        n = stmt.n_rows
        if n < 1 or n & (n - 1):
            return False
        sizes.append(n << config.rate_bits)
    n_max = max(sizes)
    # transcript replay ONLY: the OOD identities are proven by the EvalAir
    # statement below, never natively evaluated here
    ctxs = []
    for air, stmt, N_i in zip(airs, wrapped.statements, sizes):
        shift_i = pow(config.shift, n_max // N_i, P)
        ctx = replay_statement(air, stmt, config, challenger, shift_i)
        if ctx is None:
            return False
        ctxs.append(ctx)
    fri_like = FriProof(
        layer_caps=[list(c) for c in wrapped.layer_caps],
        final_poly=[tuple(c) for c in wrapped.final_poly],
        query_rounds=[],
        pow_nonce=int(wrapped.pow_nonce),
    )
    replay = fri_replay_batch(fri_like, sizes, challenger, config.fri)
    if replay is None:
        return False
    lambdas, _entry, layer_betas, query_indices, _nl = replay

    shape = wrap_shape(airs, config, [st.n_rows for st in wrapped.statements])
    pub = _assemble_publics(
        shape, wrapped.statements, wrapped.layer_caps, wrapped.final_poly,
        ctxs, lambdas, layer_betas, query_indices,
    )
    tape = tape_for(airs)
    air_e = EvalAir(tape)
    # expected publics for BOTH wrap-batch statements, fully
    # verifier-derived: the wire never ships either vector
    expected = [build_publics(shape, pub), assemble_inputs(tape, ctxs)]

    wb = wrapped.wrapper
    if not isinstance(wb, BatchStarkProof) or len(wb.statements) != 2:
        return False
    if int(wb.statements[0].n_rows) != wrap_n_rows(shape):
        return False
    if int(wb.statements[1].n_rows) != tape.n_rows:
        return False
    stmts = []
    for st, exp in zip(wb.statements, expected):
        if st.public_inputs:
            # in-memory proof objects still carry the prover's publics:
            # they must agree with the verifier-derived vector
            if [int(v) for v in st.public_inputs] != exp:
                return False
            stmts.append(st)
        else:
            # wire form: the publics never ship; verify against the
            # derived vector, the verifier's own statement of what must
            # be proven
            stmts.append(replace(st, public_inputs=exp))
    wb = BatchStarkProof(statements=stmts, fri_proof=wb.fri_proof)
    return verify_batch([WrapAir(shape), air_e], wb, wrap_config)
