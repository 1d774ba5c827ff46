"""EvalAir: the wrapped statements' OOD constraint evaluation, in-circuit.

Counterpart of ``tendermintx_tpu/stark/evalair.py``. The recursive wrapper
(stark/recursion.py) proves the batch verifier's query phase; EvalAir
proves the rest of what the wrapped verifier would do natively: each
statement's out-of-domain check (the full constraint system at z, the
alpha-Horner combination, the quotient recombination).

  * Each statement AIR's constraint evaluation is RECORDED once per shape
    as a static straight-line tape of extension-field ops (the AIR's
    ``eval_*`` methods run under a recording algebra), followed by the
    alpha-Horner combination per zerofier group and the final
    ``lhs - rhs`` against the quotient OOD values.
  * EvalAir proves the tape's execution: ONE op per row, operands fetched
    through a LogUp memory argument (write row r publishes (r, out_r) with
    its statically known read multiplicity; every operand read consumes
    (addr, value)). The tape (opcodes, operand addresses, multiplicities,
    constants) is PUBLIC schedule data; only the values are witnessed.
  * The tape's inputs (OOD values, periodic and public-column evaluations
    at z, challenges, alpha, zerofier inverses, z^{n·j}) are EvalAir's
    public inputs, derived by the outer verifier from its own transcript
    replay.

Op set (MAC fusion halves the raw tape; see ``_optimize``):

  LOAD   out = pv (public value: tape constant or tape input)
  ADD    out = a + b          SUB   out = a - b
  MUL    out = a * b          CMUL  out = pc * a        (pc public)
  MAC    out = a * b + c      MSUB  out = c - a * b
  CMAC   out = pc * a + c

Columns: committed OUT/AV/BV/CV (ext pairs, 8 base); aux TW/TA/TB/TC/S
(LogUp terms + running sum, 10 base); 20 public schedule columns.
Constraint degree 3. The aux columns are csrc/logup.cu's tmx_eval_aux on a
CUDA trace (one launch: the terms and their running sum) and their plain
torch twins on a CPU trace (the reference's jitted ``_eval_*_kernel``
programs).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from functools import cache

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.ext import GF2, W
from ..ops.goldilocks import GF, P, tensor_from_u64
from .air import Air, Frame
from .lookup import _logup_library, _prefix_sum

# opcodes
LOAD, ADD, SUB, MUL, CMUL, MAC, MSUB, CMAC = range(8)

_READS_A = frozenset({ADD, SUB, MUL, CMUL, MAC, MSUB, CMAC})
_READS_B = frozenset({ADD, SUB, MUL, MAC, MSUB})
_READS_C = frozenset({MAC, MSUB, CMAC})


# ---------------------------------------------------------------------------
# Recording algebra
# ---------------------------------------------------------------------------


class _RecFelt:
    __slots__ = ("alg", "i")

    def __init__(self, alg, i: int):
        self.alg = alg
        self.i = i

    def __add__(self, o):
        return self.alg._bin(ADD, self, o)

    def __sub__(self, o):
        return self.alg._bin(SUB, self, o)

    def __mul__(self, o):
        return self.alg._bin(MUL, self, o)

    def __neg__(self):
        return self.alg.cmul(P - 1, self)


class _RecVec:
    """HostVec mirror over recorded felts."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = list(items)

    def _zip(self, o, op):
        if isinstance(o, _RecVec):
            return _RecVec([op(a, b) for a, b in zip(self.items, o.items)])
        return _RecVec([op(a, o) for a in self.items])

    def __add__(self, o):
        return self._zip(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._zip(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._zip(o, lambda a, b: a * b)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return _RecVec(self.items[i])
        return self.items[i]


class _LazyInputs:
    """List-like view whose entries become tape inputs on first access."""

    def __init__(self, alg, n: int, kind: str):
        self.alg = alg
        self.n = n
        self.kind = kind
        self._cache: dict[int, _RecFelt] = {}

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self.n))]
        if not 0 <= i < self.n:
            raise IndexError(i)
        if i not in self._cache:
            self._cache[i] = self.alg.inp((self.kind, i))
        return self._cache[i]


class RecAlg:
    """HostAlgebra-compatible recording algebra: running an AIR's eval_*
    under it captures the constraint DAG as a straight-line tape."""

    def __init__(self):
        self.ops: list[tuple[int, int, int, int]] = []  # (op, a, b, const)
        self.input_tags: list[tuple] = []  # tag per INPUT load, tape order
        self.input_rows: list[int] = []
        self._const_cache: dict[int, _RecFelt] = {}
        self._cval: dict[int, int] = {}  # node -> known base-const value

    # -- emission --

    def _emit(self, op: int, a: int, b: int, c: int) -> _RecFelt:
        i = len(self.ops)
        self.ops.append((op, a, b, c))
        return _RecFelt(self, i)

    def inp(self, tag: tuple) -> _RecFelt:
        f = self._emit(LOAD, 0, 0, -1)  # const=-1 marks a dynamic input
        self.input_tags.append(tag)
        self.input_rows.append(f.i)
        return f

    def _bin(self, op: int, a: _RecFelt, b) -> _RecFelt:
        # record-time folding: constants originate in the base field (c, 0),
        # which ADD/SUB/MUL preserve, so folds stay base. Zero/one elision
        # removes the padding arithmetic of shift_up/pad_stack.
        av = self._cval.get(a.i)
        bv = self._cval.get(b.i)
        if av is not None and bv is not None:
            if op == ADD:
                return self.const(av + bv)
            if op == SUB:
                return self.const(av - bv)
            return self.const(av * bv)  # MUL
        if op == ADD:
            if av == 0:
                return b
            if bv == 0:
                return a
        elif op == SUB:
            if bv == 0:
                return a
            if av == 0:
                return self.cmul(P - 1, b)
        else:  # MUL
            if av == 0 or bv == 0:
                return self.const(0)
            if av is not None:
                return self.cmul(av, b)
            if bv is not None:
                return self.cmul(bv, a)
        return self._emit(op, a.i, b.i, 0)

    # -- HostAlgebra API --

    def const(self, c: int) -> _RecFelt:
        c = int(c) % P
        f = self._const_cache.get(c)
        if f is None:
            f = self._emit(LOAD, 0, 0, c)
            self._const_cache[c] = f
            self._cval[f.i] = c
        return f

    def cmul(self, c: int, x: _RecFelt) -> _RecFelt:
        c = int(c) % P
        if c == 0:
            return self.const(0)
        if c == 1:
            return x
        xv = self._cval.get(x.i)
        if xv is not None:
            return self.const(c * xv % P)
        return self._emit(CMUL, x.i, 0, c)

    def stack(self, felts):
        return _RecVec(felts)

    def rot(self, vec, r: int):
        k = len(vec)
        return _RecVec([vec[(i + r) % k] for i in range(k)])

    def shift_down(self, vec, r: int):
        k = len(vec)
        z = self.const(0)
        return _RecVec([vec[i + r] if i + r < k else z for i in range(k)])

    def weighted_sum(self, vec, weights):
        acc = None
        for w, x in zip(weights, vec.items):
            w = int(w) % P
            if w == 0:
                continue
            t = x if w == 1 else self.cmul(w, x)
            acc = t if acc is None else acc + t
        return acc if acc is not None else self.const(0)

    def vcmul(self, c: int, vec):
        return _RecVec([self.cmul(c, x) for x in vec.items])

    def unstack(self, vec):
        return list(vec.items)

    def vconst_bits(self, bits):
        return _RecVec([self.const(int(b)) for b in bits])

    def vconst(self, vals):
        return _RecVec([self.const(int(v)) for v in vals])

    def col_range(self, frame, offset_index: int, start: int, count: int):
        return _RecVec([frame.rows[offset_index][start + i] for i in range(count)])

    def vconcat(self, vecs):
        items = []
        for v in vecs:
            items.extend(v.items)
        return _RecVec(items)

    def stack_len(self, vec) -> int:
        return len(vec)

    def pad_stack(self, vec, out_len: int):
        z = self.const(0)
        items = (list(vec.items) + [z] * (out_len - len(vec)))[:out_len]
        return _RecVec(items)

    def shift_up(self, vec, r: int, out_len: int):
        z = self.const(0)
        items = [z] * r + list(vec.items)
        return _RecVec((items + [z] * (out_len - len(items)))[:out_len])


def _flatten_rec(constraints) -> list[_RecFelt]:
    out = []
    for c in constraints:
        if isinstance(c, _RecVec):
            out.extend(c.items)
        else:
            out.append(c)
    return out


# ---------------------------------------------------------------------------
# Tape: record per statement -> DCE -> MAC fusion -> compact
# ---------------------------------------------------------------------------


@dataclass
class Tape:
    """Static execution schedule, shared verbatim by prover and verifier.
    Arrays are length-T (one op per committed row)."""

    op: np.ndarray  # uint8
    a: np.ndarray  # uint32 operand row indices
    b: np.ndarray
    c: np.ndarray
    const: list[int]  # per-row constant (CMUL/CMAC coefficient, LOAD value)
    is_input: np.ndarray  # bool: LOAD rows whose value is a public input
    input_tags: list[tuple]  # (stmt, kind, i) per input, tape order
    assert_rows: np.ndarray  # rows whose out must equal zero
    m: np.ndarray  # uint32 read multiplicity per row
    # EvalAir.aux_rows' uploads, one a device
    device_rows: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_ops(self) -> int:
        return len(self.op)

    @property
    def n_rows(self) -> int:
        return 1 << max(self.n_ops - 1, 3).bit_length()

    @property
    def n_inputs(self) -> int:
        return len(self.input_tags)


def record_statement(air: Air, stmt_index: int, alg: RecAlg) -> int:
    """Record one statement's full OOD check into `alg`'s tape; returns the
    node index of (lhs - rhs), which must be zero. Input tags are
    namespaced by stmt_index."""
    n_total = air.n_cols + air.n_aux_cols
    offsets = list(air.frame_offsets)
    n_chunks = air.constraint_degree - 1

    def lazy(kind: str, n: int):
        return _LazyInputs(_TagAlg(alg, stmt_index), n, kind)

    frame = Frame(
        rows=[lazy(f"ood{oi}", n_total) for oi in range(len(offsets))],
        public=lazy("pub", air.n_public),
        periodic=lazy("per", len(air.periodic_columns())),
        public_cols=lazy("pcol", air.n_public_cols),
        challenges=lazy("chal", 2 * air.n_challenges),
    )
    groups = [
        air.eval_first(frame, alg),
        air.eval_transition(frame, alg),
        air.eval_cyclic(frame, alg),
        air.eval_last(frame, alg),
    ]
    tag = _TagAlg(alg, stmt_index)
    alpha = tag.inp(("alpha", 0))
    zinvs = [tag.inp(("zinv", g)) for g in range(4)]
    lhs = None
    a_pow = None  # lazily 1 -> skip the first two MULs
    for gi, cons in enumerate(groups):
        for cf in _flatten_rec(cons):
            u = cf * zinvs[gi]
            term = u if a_pow is None else u * a_pow
            lhs = term if lhs is None else lhs + term
            a_pow = alpha if a_pow is None else a_pow * alpha
    if lhs is None:
        raise ValueError("AIR has no constraints")
    # rhs = sum_j z^(n*j) * ood_quotient[j]
    rhs = tag.inp(("oodq", 0))
    for j in range(1, n_chunks):
        oq = tag.inp(("oodq", j))
        znj = tag.inp(("znj", j))
        rhs = rhs + oq * znj
    return (lhs - rhs).i


class _TagAlg:
    """Namespaces input tags with the statement index."""

    def __init__(self, alg: RecAlg, stmt: int):
        self.alg = alg
        self.stmt = stmt

    def inp(self, tag: tuple):
        return self.alg.inp((self.stmt,) + tag)


def build_tape(airs: list[Air]) -> Tape:
    """Record all statements into one combined tape; optimize."""
    alg = RecAlg()
    assert_nodes = [record_statement(air, s, alg) for s, air in enumerate(airs)]
    return _optimize(alg, assert_nodes)


def _optimize(alg: RecAlg, assert_nodes: list[int]) -> Tape:
    return optimize_with_remap(alg, assert_nodes)[0]


def optimize_with_remap(alg: RecAlg, assert_nodes: list[int]) -> tuple[Tape, dict[int, int]]:
    """DCE from the root nodes `assert_nodes`, MAC fusion, compaction.
    Returns the tape and the map from each kept recorded node to its tape
    row (roots are never fused away, so every root has a row)."""
    ops = alg.ops
    T = len(ops)
    input_rows = set(alg.input_rows)
    tag_of = dict(zip(alg.input_rows, alg.input_tags))

    # liveness: backward from assert roots
    live = np.zeros(T, dtype=bool)
    stack = list(assert_nodes)
    while stack:
        i = stack.pop()
        if live[i]:
            continue
        live[i] = True
        op, a, b, _c = ops[i]
        if op in _READS_A:
            stack.append(a)
        if op in _READS_B:
            stack.append(b)

    # use counts on the live graph
    uses = np.zeros(T, dtype=np.int64)
    for i in range(T):
        if not live[i]:
            continue
        op, a, b, _c = ops[i]
        if op in _READS_A:
            uses[a] += 1
        if op in _READS_B:
            uses[b] += 1

    # MAC fusion: ADD(x, MUL(a,b)) -> MAC(a,b,x); ADD(x, CMUL(c,a)) ->
    # CMAC(c,a,x); SUB(x, MUL(a,b)) -> MSUB(a,b,x). Only when the inner
    # node is live with exactly one use. Fused ops carry a third operand.
    assert_set = set(assert_nodes)
    fused_away = np.zeros(T, dtype=bool)

    def fusable(j, oj):
        return (
            uses[j] == 1
            and j not in assert_set
            and not fused_away[j]
            and oj[0] in (MUL, CMUL)
        )

    new_ops: list[tuple[int, int, int, int, int, int]] = []  # (old, op, a, b, c3, const)
    for i in range(T):
        if not live[i] or fused_away[i]:
            continue
        op, a, b, cst = ops[i]
        c3 = 0
        if op in (ADD, SUB):
            ia, ib = ops[a], ops[b]
            if op == ADD and fusable(b, ib):
                if ib[0] == MUL:
                    op, a2, b2, c3, cst = MAC, ib[1], ib[2], a, 0
                else:
                    op, a2, b2, c3, cst = CMAC, ib[1], 0, a, ib[3]
                fused_away[b] = True
                a, b = a2, b2
            elif op == ADD and fusable(a, ia):
                if ia[0] == MUL:
                    op, a2, b2, c3, cst = MAC, ia[1], ia[2], b, 0
                else:
                    op, a2, b2, c3, cst = CMAC, ia[1], 0, b, ia[3]
                fused_away[a] = True
                a, b = a2, b2
            elif op == SUB and fusable(b, ib):
                if ib[0] == MUL:
                    op, a2, b2, c3 = MSUB, ib[1], ib[2], a
                else:  # x - c*a == (P-c)*a + x
                    op, a2, b2, c3, cst = CMAC, ib[1], 0, a, (P - ib[3]) % P
                fused_away[b] = True
                a, b = a2, b2
        new_ops.append((i, op, a, b, c3, cst))

    # compact + remap (fused-away nodes vanish; their operands were
    # re-pointed at the fused row)
    remap = {old_i: new_i for new_i, (old_i, *_rest) in enumerate(new_ops)}
    T2 = len(new_ops)
    op_a = np.zeros(T2, dtype=np.uint8)
    a_a = np.zeros(T2, dtype=np.uint32)
    b_a = np.zeros(T2, dtype=np.uint32)
    c_a = np.zeros(T2, dtype=np.uint32)
    const_a: list[int] = [0] * T2
    is_inp = np.zeros(T2, dtype=bool)
    tags: list[tuple] = []
    for new_i, (old_i, op, a, b, c3, cst) in enumerate(new_ops):
        op_a[new_i] = op
        if op in _READS_A:
            a_a[new_i] = remap[a]
        if op in _READS_B:
            b_a[new_i] = remap[b]
        if op in _READS_C:
            c_a[new_i] = remap[c3]
        if op == LOAD:
            if old_i in input_rows:
                is_inp[new_i] = True
                tags.append(tag_of[old_i])
            else:
                const_a[new_i] = cst
        elif op in (CMUL, CMAC):
            const_a[new_i] = cst

    m = np.zeros(T2, dtype=np.uint32)
    for i in range(T2):
        op = int(op_a[i])
        if op in _READS_A:
            m[a_a[i]] += 1
        if op in _READS_B:
            m[b_a[i]] += 1
        if op in _READS_C:
            m[c_a[i]] += 1

    tape = Tape(
        op=op_a,
        a=a_a,
        b=b_a,
        c=c_a,
        const=const_a,
        is_input=is_inp,
        input_tags=tags,
        assert_rows=np.asarray(sorted(remap[i] for i in assert_nodes), dtype=np.uint32),
        m=m,
    )
    return tape, remap


def air_cache_key(air: Air) -> tuple:
    """Everything an AIR's constraint program depends on: its class, its
    shape attributes and its own ``cache_key()`` (the reference's
    ``prover._air_cache_key``)."""
    custom = getattr(air, "cache_key", None)
    extra = custom() if callable(custom) else ()
    return (
        type(air),
        air.n_cols,
        air.n_public,
        tuple(air.frame_offsets),
        air.constraint_degree,
        air.n_aux_cols,
        air.n_challenges,
        extra,
    )


_TAPE_CACHE: dict = {}


def tape_for(airs: list[Air]) -> Tape:
    """Memoized per statement-shape tuple (the tape is static per shape)."""
    key = tuple(air_cache_key(air) for air in airs)
    t = _TAPE_CACHE.get(key)
    if t is None:
        t = build_tape(airs)
        if len(_TAPE_CACHE) >= 4:
            _TAPE_CACHE.clear()
        _TAPE_CACHE[key] = t
    return t


# ---------------------------------------------------------------------------
# Input assembly + tape execution
# ---------------------------------------------------------------------------


def assemble_inputs(tape: Tape, ctxs: list) -> list[int]:
    """Flatten the tape's input values (EvalAir's public-input vector) from
    per-statement replay contexts (verifier.replay_statement). Order
    follows tape.input_tags; each ext value contributes (c0, c1)."""
    out: list[int] = []
    for stmt, kind, i in tape.input_tags:
        ctx = ctxs[stmt]
        if kind == "oodq":
            v = ctx.ood_quotient[i]
        elif kind.startswith("ood"):
            v = ctx.ood_trace[int(kind[3:])][i]
        elif kind == "per":
            v = ctx.periodic_at_z[i]
        elif kind == "pcol":
            v = ctx.public_cols_at_z[i]
        elif kind == "chal":
            v = (ctx.challenge_components[i], 0)
        elif kind == "pub":
            v = (ctx.public_inputs[i] % P, 0)
        elif kind == "alpha":
            v = ctx.alpha
        elif kind == "zinv":
            v = ctx.zinvs[i]
        elif kind == "znj":
            v = ctx.z_pows_n[i]
        else:  # pragma: no cover - tape tags are generated above
            raise ValueError(f"unknown input tag {(stmt, kind, i)}")
        out.extend((int(v[0]) % P, int(v[1]) % P))
    return out


def execute_tape(tape: Tape, inputs: list[int]):
    """Run the tape on host ints. Returns (out, av, bv, cv) as (T, 2)
    uint64 arrays (the committed witness columns), or raises ValueError
    if any assert row is nonzero (the statement's OOD identity fails)."""
    T = tape.n_ops
    if len(inputs) != 2 * tape.n_inputs:
        raise ValueError("bad eval input count")
    vals0 = [0] * T
    vals1 = [0] * T
    av = np.zeros((T, 2), dtype=np.uint64)
    bv = np.zeros((T, 2), dtype=np.uint64)
    cv = np.zeros((T, 2), dtype=np.uint64)
    inp_pos = 0
    op_arr, a_arr, b_arr, c_arr = tape.op, tape.a, tape.b, tape.c
    const = tape.const
    is_inp = tape.is_input
    for i in range(T):
        op = int(op_arr[i])
        if op == LOAD:
            if is_inp[i]:
                v0 = inputs[2 * inp_pos] % P
                v1 = inputs[2 * inp_pos + 1] % P
                inp_pos += 1
            else:
                v0, v1 = const[i] % P, 0
        else:
            ai = int(a_arr[i])
            x0, x1 = vals0[ai], vals1[ai]
            av[i, 0], av[i, 1] = x0, x1
            if op == CMUL:
                cc = const[i]
                v0, v1 = cc * x0 % P, cc * x1 % P
            elif op == CMAC:
                ci = int(c_arr[i])
                w0, w1 = vals0[ci], vals1[ci]
                cv[i, 0], cv[i, 1] = w0, w1
                cc = const[i]
                v0, v1 = (cc * x0 + w0) % P, (cc * x1 + w1) % P
            else:
                bi = int(b_arr[i])
                y0, y1 = vals0[bi], vals1[bi]
                bv[i, 0], bv[i, 1] = y0, y1
                if op == ADD:
                    v0, v1 = (x0 + y0) % P, (x1 + y1) % P
                elif op == SUB:
                    v0, v1 = (x0 - y0) % P, (x1 - y1) % P
                elif op == MUL:
                    v0 = (x0 * y0 + W * x1 * y1) % P
                    v1 = (x0 * y1 + x1 * y0) % P
                elif op in (MAC, MSUB):
                    ci = int(c_arr[i])
                    w0, w1 = vals0[ci], vals1[ci]
                    cv[i, 0], cv[i, 1] = w0, w1
                    p0 = (x0 * y0 + W * x1 * y1) % P
                    p1 = (x0 * y1 + x1 * y0) % P
                    if op == MAC:
                        v0, v1 = (p0 + w0) % P, (p1 + w1) % P
                    else:
                        v0, v1 = (w0 - p0) % P, (w1 - p1) % P
                else:  # pragma: no cover
                    raise ValueError(f"bad opcode {op}")
        vals0[i], vals1[i] = v0, v1
    for r in tape.assert_rows:
        if vals0[int(r)] or vals1[int(r)]:
            raise ValueError("OOD identity fails in the eval tape")
    out = np.zeros((T, 2), dtype=np.uint64)
    out[:, 0] = vals0
    out[:, 1] = vals1
    return out, av, bv, cv


# ---------------------------------------------------------------------------
# The AIR
# ---------------------------------------------------------------------------

# committed column indices (base pairs)
E_OUT = 0
E_AV = 2
E_BV = 4
E_CV = 6
N_MAIN = 8
# aux (within the combined [main ‖ aux] frame)
A_TW = N_MAIN + 0
A_TA = N_MAIN + 2
A_TB = N_MAIN + 4
A_TC = N_MAIN + 6
A_S = N_MAIN + 8
N_AUX = 10

_PUB_NAMES = (
    "g_load", "g_add", "g_sub", "g_mul", "g_cmul", "g_mac", "g_msub",
    "g_cmac", "g_az", "pc", "pv0", "pv1", "aw", "aa", "ab", "ac", "m",
    "g_ra", "g_rb", "g_rc",
)
# the public rows the aux columns read: each term's address, then its multiplicity
_AUX_ROWS = ("aw", "aa", "ab", "ac", "m", "g_ra", "g_rb", "g_rc")


class EvalAir(Air):
    """One tape op per row; operand routing via the LogUp memory argument
    (module docstring). Instances are per-Tape; the tape arrays become
    public schedule columns, the input values the publics."""

    n_cols = N_MAIN
    n_aux_cols = N_AUX
    n_challenges = 2  # gamma (memory), delta (tuple combiner)
    constraint_degree = 3
    frame_offsets = [0, 1]
    n_public_cols = len(_PUB_NAMES)

    def __init__(self, tape: Tape):
        self.tape = tape
        self.n_public = 2 * tape.n_inputs
        self._pi = {m: i for i, m in enumerate(_PUB_NAMES)}
        self._static_cols: np.ndarray | None = None

    def cache_key(self):
        # constraints are tape-independent, but the public-column COUNT
        # and schedule length are not; n_rows/n_public separate shapes
        return (self.tape.n_ops,)

    @property
    def n_rows(self) -> int:
        return self.tape.n_rows

    def validate_publics(self, publics) -> bool:
        return len(publics) == self.n_public and all(0 <= int(v) < P for v in publics)

    # -- public schedule columns --

    def _static(self, n_rows: int) -> np.ndarray:
        if self._static_cols is not None:
            return self._static_cols
        t = self.tape
        T = t.n_ops
        cols = np.zeros((len(_PUB_NAMES), n_rows), dtype=np.uint64)
        gate_row = {
            LOAD: "g_load", ADD: "g_add", SUB: "g_sub", MUL: "g_mul",
            CMUL: "g_cmul", MAC: "g_mac", MSUB: "g_msub", CMAC: "g_cmac",
        }
        pi = self._pi
        for opc, name in gate_row.items():
            cols[pi[name], :T][t.op == opc] = 1
        cols[pi["g_az"], t.assert_rows] = 1
        cols[pi["pc"], :T] = np.asarray([c % P for c in t.const], dtype=np.uint64)
        # pv: static constants here; input values overlaid per instance
        cols[pi["pv0"], :T] = cols[pi["pc"], :T] * (t.op == LOAD)
        cols[pi["aw"], :n_rows] = np.arange(n_rows, dtype=np.uint64)
        cols[pi["aa"], :T] = t.a
        cols[pi["ab"], :T] = t.b
        cols[pi["ac"], :T] = t.c
        cols[pi["m"], :T] = t.m
        cols[pi["g_ra"], :T][np.isin(t.op, list(_READS_A))] = 1
        cols[pi["g_rb"], :T][np.isin(t.op, list(_READS_B))] = 1
        cols[pi["g_rc"], :T][np.isin(t.op, list(_READS_C))] = 1
        self._static_cols = cols
        return cols

    def public_columns(self, publics: list[int], n_rows: int):
        t = self.tape
        if n_rows != t.n_rows:
            raise ValueError("EvalAir trace length mismatch")
        if len(publics) != self.n_public:
            raise ValueError("bad eval publics length")
        cols = self._static(n_rows).copy()
        inp_rows = np.flatnonzero(t.is_input)
        vals = np.asarray([int(v) % P for v in publics], dtype=np.uint64)
        cols[self._pi["pv0"], inp_rows] = vals[0::2]
        cols[self._pi["pv1"], inp_rows] = vals[1::2]
        return [cols[i] for i in range(len(_PUB_NAMES))]

    # -- witness --

    def witness_trace(self, inputs: list[int], device) -> GF:
        """(N_MAIN, n_rows) committed trace from the tape execution, on
        `device`."""
        out, av, bv, cv = execute_tape(self.tape, inputs)
        n = self.tape.n_rows
        T = self.tape.n_ops
        arr = np.zeros((N_MAIN, n), dtype=np.uint64)
        for base, vals in ((E_OUT, out), (E_AV, av), (E_BV, bv), (E_CV, cv)):
            arr[base, :T] = vals[:, 0]
            arr[base + 1, :T] = vals[:, 1]
        return GF(tensor_from_u64(arr, device))

    def aux_rows(self, device) -> torch.Tensor:
        """The (8, n) static rows the aux columns read: the addresses aw,
        aa, ab, ac, then the multiplicities m, g_ra, g_rb, g_rc; uploaded
        once per tape and device."""
        device = torch.device(device)
        rows = self.tape.device_rows.get(device)
        if rows is None:
            cols = self._static(self.tape.n_rows)
            rows = tensor_from_u64(cols[[self._pi[k] for k in _AUX_ROWS]], device)
            self.tape.device_rows[device] = rows
        return rows

    def aux_columns(self, trace: GF, challenges, publics):
        """LogUp terms tw/ta/tb/tc + running sum S: the plain torch
        programs for a CPU trace, csrc/logup.cu's tmx_eval_aux for a CUDA
        one."""
        gamma, delta = challenges
        t = trace.device.type
        if t == "cpu":
            return eval_aux_plain(trace, self.aux_rows(trace.device), gamma, delta)
        if t == "cuda":
            return eval_aux_cuda(trace, self.aux_rows(trace.device), gamma, delta)
        raise ValueError(f"no EvalAir aux columns for device {trace.device}")

    # -- constraints (shared host/device via the algebra) --

    def _pc(self, frame, name):
        return frame.public_cols[self._pi[name]]

    @staticmethod
    def _emul(alg, a, b):
        return (
            a[0] * b[0] + alg.cmul(W, a[1] * b[1]),
            a[0] * b[1] + a[1] * b[0],
        )

    def _delta2(self, frame, alg):
        d0, d1 = frame.challenges[2], frame.challenges[3]
        return (d0 * d0 + alg.cmul(W, d1 * d1), alg.cmul(2, d0 * d1))

    def _dterm(self, frame, alg, addr, v0, v1, e2):
        """gamma - (addr + delta*v0 + delta^2*v1), components."""
        g0, g1 = frame.challenges[0], frame.challenges[1]
        d0, d1 = frame.challenges[2], frame.challenges[3]
        return (
            g0 - addr - d0 * v0 - e2[0] * v1,
            g1 - d1 * v0 - e2[1] * v1,
        )

    def eval_cyclic(self, frame: Frame, alg):
        pc = lambda m: self._pc(frame, m)
        local = frame.local
        cons = []
        OUT = (local[E_OUT], local[E_OUT + 1])
        AV = (local[E_AV], local[E_AV + 1])
        BV = (local[E_BV], local[E_BV + 1])
        CV = (local[E_CV], local[E_CV + 1])
        mul = self._emul(alg, AV, BV)
        pcc = pc("pc")
        pv = (pc("pv0"), pc("pv1"))
        for comp in range(2):
            r_load = OUT[comp] - pv[comp]
            r_add = OUT[comp] - AV[comp] - BV[comp]
            r_sub = OUT[comp] - AV[comp] + BV[comp]
            r_mul = OUT[comp] - mul[comp]
            r_cmul = OUT[comp] - pcc * AV[comp]
            r_mac = OUT[comp] - mul[comp] - CV[comp]
            r_msub = OUT[comp] - CV[comp] + mul[comp]
            r_cmac = OUT[comp] - pcc * AV[comp] - CV[comp]
            cons.append(
                pc("g_load") * r_load
                + pc("g_add") * r_add
                + pc("g_sub") * r_sub
                + pc("g_mul") * r_mul
                + pc("g_cmul") * r_cmul
                + pc("g_mac") * r_mac
                + pc("g_msub") * r_msub
                + pc("g_cmac") * r_cmac
            )
        # memory-argument term columns: t * d == multiplicity
        e2 = self._delta2(frame, alg)
        for tbase, addr_name, vpair, mult_name in (
            (A_TW, "aw", OUT, "m"),
            (A_TA, "aa", AV, "g_ra"),
            (A_TB, "ab", BV, "g_rb"),
            (A_TC, "ac", CV, "g_rc"),
        ):
            t = (local[tbase], local[tbase + 1])
            d = self._dterm(frame, alg, pc(addr_name), vpair[0], vpair[1], e2)
            prod = self._emul(alg, t, d)
            cons.append(prod[0] - pc(mult_name))
            cons.append(prod[1])
        # assert rows: the statement's (lhs - rhs) must be zero
        cons.append(pc("g_az") * OUT[0])
        cons.append(pc("g_az") * OUT[1])
        return cons

    def _diff(self, frame, offset_index: int):
        row = frame.rows[offset_index]
        d0 = row[A_TW] - row[A_TA] - row[A_TB] - row[A_TC]
        d1 = row[A_TW + 1] - row[A_TA + 1] - row[A_TB + 1] - row[A_TC + 1]
        return d0, d1

    def eval_first(self, frame: Frame, alg):
        d0, d1 = self._diff(frame, 0)
        return [frame.local[A_S] - d0, frame.local[A_S + 1] - d1]

    def eval_transition(self, frame: Frame, alg):
        d0, d1 = self._diff(frame, 1)
        return [
            frame.next[A_S] - frame.local[A_S] - d0,
            frame.next[A_S + 1] - frame.local[A_S + 1] - d1,
        ]

    def eval_last(self, frame: Frame, alg):
        # total LogUp sum is zero: reads exactly consume the writes
        return [frame.local[A_S], frame.local[A_S + 1]]


# -- aux columns: the plain twins of the reference's jitted _eval_*_kernel
#    programs (torch ops, any device) ------------------------------------------


def eval_aux_plain(trace: GF, rows: torch.Tensor, gamma: GF2, delta: GF2) -> GF:
    """The (10, n) aux rows as torch ops, over the (8, n) trace and the
    aux_rows: the reference's three programs, one torch.profiler range
    each."""
    v0 = GF(trace.v[[E_OUT, E_AV, E_BV, E_CV]])
    v1 = GF(trace.v[[E_OUT + 1, E_AV + 1, E_BV + 1, E_CV + 1]])
    with record_function("eval_terms"):
        terms = _eval_terms(GF(rows[:4]), GF(rows[4:]), v0, v1, gamma, delta)
    with record_function("eval_scan"):
        S = _eval_scan(terms)
    with record_function("eval_assemble"):
        return _eval_assemble(terms, S)


def _eval_terms(addrs: GF, mults: GF, v0: GF, v1: GF, gamma: GF2, delta: GF2) -> GF2:
    """(4, n) LogUp terms t_k = mult_k / (gamma - (addr_k + delta*v0_k +
    delta^2*v1_k)): one elementwise GF(p^2) inversion per term."""
    d2 = delta * delta
    shape = v0.shape
    num = GF2(
        gamma.c0.broadcast_to(shape) - addrs - delta.c0.broadcast_to(shape) * v0
        - d2.c0.broadcast_to(shape) * v1,
        gamma.c1.broadcast_to(shape) - delta.c1.broadcast_to(shape) * v0
        - d2.c1.broadcast_to(shape) * v1,
    )
    inv = num.inv()
    return GF2(inv.c0 * mults, inv.c1 * mults)


def _eval_scan(terms: GF2) -> GF2:
    """Running sum S[i] = sum_{r<=i} (tw - ta - tb - tc)[r], component-wise
    mod p (exact, so equal to the reference's sequential lax.scan)."""
    c0, c1 = terms.c0, terms.c1
    d0 = c0[0] - c0[1] - c0[2] - c0[3]
    d1 = c1[0] - c1[1] - c1[2] - c1[3]
    return GF2(GF(_prefix_sum(d0.v)), GF(_prefix_sum(d1.v)))


def _eval_assemble(terms: GF2, S: GF2) -> GF:
    """(10, n) aux rows [tw.c0, tw.c1, ta.c0, ..., tc.c1, S.c0, S.c1]."""
    inter = torch.stack([terms.c0.v, terms.c1.v], dim=1).reshape(8, -1)
    return GF(torch.cat([inter, torch.stack([S.c0.v, S.c1.v])], dim=0))


# -- aux columns on the card: csrc/logup.cu's tmx_eval_aux ---------------------

# csrc/logup.cu: a block of EVAL_THREADS threads takes EVAL_ROWS rows a
# thread, a tile of EVAL_TILE rows; a launch takes at most EVAL_MAX_ROWS
EVAL_THREADS = 512
EVAL_ROWS = 2
EVAL_TILE = EVAL_THREADS * EVAL_ROWS
EVAL_MAX_ROWS = (1 << 31) - 1

# incremented exactly where eval_aux_cuda launches its kernel
eval_aux_kernel_launches = 0


class _EvalArgs(ctypes.Structure):
    """csrc/logup.cu's EvalArgs, field for field."""

    _fields_ = [
        ("trace", ctypes.c_void_p), ("trace_ld", ctypes.c_int64), ("rows", ctypes.c_void_p),
        ("gamma0", ctypes.c_void_p), ("gamma1", ctypes.c_void_p),
        ("delta0", ctypes.c_void_p), ("delta1", ctypes.c_void_p),
        ("n", ctypes.c_int64), ("out", ctypes.c_void_p),
        ("n_tiles", ctypes.c_int64), ("tiles", ctypes.c_void_p), ("sums", ctypes.c_void_p),
    ]


@cache
def _eval_library():
    lib = _logup_library()
    lib.tmx_eval_aux.restype = ctypes.c_int
    lib.tmx_eval_aux.argtypes = [ctypes.POINTER(_EvalArgs), ctypes.c_void_p]
    return lib


def _eval_launch(fn: str, args: _EvalArgs, dev):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_eval_library(), fn)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


# the look-back's scratch a (device, stream): (2 + capacity) int32 words, the
# tile counter, the done counter and each tile's status, zeroed once and left
# zeroed by every launch; and (capacity, 4) int64 words, each tile's sum and
# inclusive prefix. A stream's launches run in order, so they share it.
_LOOKBACK: dict = {}


def _lookback_scratch(dev, n_tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    got = _LOOKBACK.get(key)
    if got is None or got[1].shape[0] < n_tiles:
        cap = max(1024, 1 << (n_tiles - 1).bit_length())
        got = (torch.zeros(2 + cap, dtype=torch.int32, device=dev), torch.empty((cap, 4), dtype=torch.int64, device=dev))
        _LOOKBACK[key] = got
    return got


def _check_operand(t: torch.Tensor, dev, shape: tuple, what: str):
    if t.device != dev or t.dtype != torch.int64:
        raise TypeError(f"eval aux: {what} must be an int64 tensor on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"eval aux: {what} must be a contiguous {shape} tensor, got {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def eval_aux_cuda(trace: GF, rows: torch.Tensor, gamma: GF2, delta: GF2) -> GF:
    """The (10, n) aux rows on the card in one launch of tmx_eval_aux: the
    four terms' interleaved rows 0-7 and S in rows 8-9."""
    global eval_aux_kernel_launches
    v = trace.v
    dev = v.device
    if dev.type != "cuda" or v.dtype != torch.int64:
        raise TypeError(f"eval_aux_cuda takes an int64 CUDA trace, got {v.dtype} on {dev}")
    if v.dim() != 2 or int(v.shape[0]) != N_MAIN or not 1 <= int(v.shape[1]) <= EVAL_MAX_ROWS:
        raise ValueError(f"eval_aux_cuda: the trace is {tuple(v.shape)}; ({N_MAIN}, 1 <= n <= {EVAL_MAX_ROWS}) wanted")
    n = int(v.shape[1])
    if n > 1 and v.stride(1) != 1:
        raise ValueError("eval_aux_cuda: the trace must have unit stride along its rows")
    _check_operand(rows, dev, (len(_AUX_ROWS), n), "the static rows")
    for what, x in (("gamma c0", gamma.c0.v), ("gamma c1", gamma.c1.v), ("delta c0", delta.c0.v),
                    ("delta c1", delta.c1.v)):
        if x.device != dev or x.dtype != torch.int64 or x.numel() != 1:
            raise TypeError(f"eval_aux_cuda: {what} must be one int64 word on {dev}")
    out = torch.empty((N_AUX, n), dtype=torch.int64, device=dev)
    n_tiles = -(-n // EVAL_TILE)
    tiles, sums = _lookback_scratch(dev, n_tiles)
    args = _EvalArgs(trace=v.data_ptr(), trace_ld=int(v.stride(0)), rows=rows.data_ptr(),
                     gamma0=gamma.c0.v.data_ptr(), gamma1=gamma.c1.v.data_ptr(),
                     delta0=delta.c0.v.data_ptr(), delta1=delta.c1.v.data_ptr(),
                     n=n, out=out.data_ptr(), n_tiles=n_tiles, tiles=tiles.data_ptr(), sums=sums.data_ptr())
    with record_function("eval_aux"):
        _eval_launch("tmx_eval_aux", args, dev)
    eval_aux_kernel_launches += 1
    return GF(out)
