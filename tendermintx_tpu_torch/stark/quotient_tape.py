"""The constraint quotient as a recorded tape, run by a hand CUDA kernel.

Counterpart of the reference's XLA program for the quotient,
``tendermintx_tpu/stark/prover.py:293`` ``_build_quotient_fn`` (its
``jax.jit`` at ``:363-364``) over ``:379`` ``_eval_quotient_core``: per
LDE row, evaluate the AIR's first, transition, cyclic and last
constraints on the row's frame, scale each by its zerofier inverse and
sum alpha^k * c_k into GF(p^2).

Eager torch runs that program at ~45 launches per field multiply. Here
each AIR's ``eval_*`` methods are recorded once per AIR shape under the
recording algebra (``evalair.RecAlg``) into a straight-line tape of
base-field ops, which one generic kernel (``csrc/quotient.cu``) runs, one
LDE row per thread. No AIR has constraint code of its own in CUDA.

  * ``record_quotient`` records the four groups with the frame, publics,
    periodic and public columns and challenges as lazy tape inputs and
    runs ``evalair.optimize_with_remap`` with the flattened constraints
    as roots (dead-code elimination, MAC fusion).
  * ``_schedule`` orders the computed values: roots that share a computed
    value form a cluster (union-find over their cones), the clusters
    follow one another in tape order, and each is emitted depth-first
    from its roots, so a value's readers sit close behind it and every
    value of a cluster is dead once the cluster ends. Each root becomes a
    ROOT instruction right after the op that makes its value:
    ``acc += alpha^k * c * zinv_g``. The root table (alpha index k,
    group g) is the recording's; only the emission order changes.
  * Loads are operands, not instructions: a frame value, a periodic or
    public column, a public, a challenge or a constant is read by the
    instruction that uses it. Only computed values take value slots,
    allocated by liveness in the scheduled order (a slot is free again
    after its value's last read), so the slot count is the schedule's
    peak live set: small enough for the kernel to keep every slot of a
    row in shared memory.
  * ``_bundle`` groups independent instructions of one opcode (up to
    MAX_BUNDLE) so the kernel computes them side by side; ``_encode``
    cuts the stream into chunks (at most TAPE_CHUNK instructions and
    LOAD_CAP distinct per-row loads each): the kernel loads a chunk's
    frame and row-input values into a per-row load buffer while it runs
    the chunk before.
  * ``quotient_tape(air)`` caches the compiled tape per
    ``evalair.air_cache_key``; its device copy is uploaded once per
    device.
  * The frame is read straight from a shard's LDE row blocks
    (``LdeShard``): offset k of local row r is row r + k * blowup of the
    trace (or aux) block, and the halo (the right neighbour's leading
    rows, ``parallel/prover.py``) holds the rows past the block's end.
    Periodic, public and zerofier columns are the shard's own (rows,)
    slices of the whole columns, read at ``r``.
  * ``execute_plain`` runs the same chunks, load lists and instructions on
    the same inputs as int64 torch ops, vectorised over a row range (the
    CPU tests hold it against the DeviceAlgebra evaluation of
    ``stark/prover.py`` over the gathered frame); ``quotient_cuda``
    launches the kernel, once per shard.

Per-row words of a thread (the kernel keeps them in shared memory): the
four zerofier inverses (first, transition, cyclic, last), the n_slots
value slots, then two load buffers of LOAD_CAP words (chunk c uses
buffer c % 2). Uniform words: the constants, then the scalars the tape
reads (publics, then challenge components; ``scalar_index``).

Instruction encoding (int32 x 4 per instruction, one 16-byte fetch):

  word 0   op | (width - 1) << 3 | dst << 8: opcode, the bundle's width
           on its first instruction, and the value slot of the result
  ADD      a + b          SUB   a - b          MUL   a * b
  MAC      c + a * b      MSUB  c - a * b
  ROOT     acc += alpha^b * a * zinv_c  (b = k, c = g: plain ints)

An operand a, b, c is a byte offset into shared memory for the tape's
block size (``threads``): a per-row word p is p * 8 * threads + 1 (odd:
add the thread's own column), a uniform word i is 8 * i. A recorded
constant multiply (``CMUL``, ``CMAC``) is a MUL or MAC with a constant
operand. A load word, in a chunk's load list, is index << 3 | mode with
mode ROW (index: periodic, then public columns), TRACE or AUX (index =
column << 4 | offset k).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from functools import cache

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops.ext import GF2
from ..ops.goldilocks import GF, tensor_from_u64
from . import evalair as ev
from .air import Frame

ADD, SUB, MUL, MAC, MSUB, ROOT = range(6)
# the source of an operand (a load word in the load lists: index << 3 | mode)
SLOT, CONST, SCALAR, ROW, TRACE, AUX = range(6)
MODES = ("slot", "const", "scalar", "row", "trace", "aux")
# frame offsets a TRACE / AUX word can name (4 bits)
MAX_OFFSETS = 16
# per-row words before the value slots: the four zerofier inverses
ZINV_ROWS = 4
# instructions a chunk may have (each of the kernel's two tape buffers
# holds one chunk), and the distinct per-row loads it may read
TAPE_CHUNK = 32
LOAD_CAP = 8
# ALU instructions a bundle may have, and how far past the first
# unemitted instruction the bundler looks for members
MAX_BUNDLE = 4
BUNDLE_WINDOW = 64
# field multiplies per instruction (a ROOT scales by zinv, then by alpha's
# two components)
_MULS = {MUL: 1, MAC: 1, MSUB: 1, ROOT: 3}


@dataclass
class QuotientTape:
    """One AIR shape's compiled quotient program."""

    code: np.ndarray  # (T, 4) int32 instructions (module docstring)
    consts: np.ndarray  # uint64 constants (the uniform words before the scalars)
    n_slots: int
    threads: int  # rows a block of the kernel (launch_shape); per-row operands are byte offsets for it
    chunks: np.ndarray  # (n_chunks, 8) int32: first instruction, count, first load, count, first root, count, 0, 0
    loads: np.ndarray  # int32 load words (index << 3 | ROW / TRACE / AUX), chunk after chunk
    root_order: np.ndarray  # alpha index k of each ROOT, in tape order
    scalar_index: np.ndarray  # the scalars the tape reads (publics, then challenges), in uniform-word order
    # per root k (alpha power k): its constraint group, which is also its
    # zerofier inverse's index: 0 first, 1 transition, 2 cyclic, 3 last
    root_groups: np.ndarray
    # slots whose value is dead after instruction t (read for the last
    # time there): the plain executor's poisoning check reads them
    frees: list
    stats: dict  # operand reads and loads per row by source (counts())
    offsets: tuple  # the AIR's frame offsets
    n_cols: int  # trace columns (TRACE words); aux columns follow them in the frame
    n_aux: int
    n_periodic: int
    n_public_cols: int
    n_public: int
    n_chal: int
    recorded_ops: int  # rows of the optimised tape, before the schedule folds the loads
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def n_roots(self) -> int:
        return len(self.root_groups)

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def n_total(self) -> int:
        return self.n_cols + self.n_aux

    @property
    def zinv_base(self) -> int:
        return self.n_periodic + self.n_public_cols

    @property
    def n_rowvecs(self) -> int:
        return self.zinv_base + 4

    @property
    def n_uniform(self) -> int:
        """Uniform words: the constants, then the scalars the tape reads."""
        return len(self.consts) + len(self.scalar_index)

    @property
    def row_words(self) -> int:
        """Per-row words: zerofier inverses, value slots, two load buffers."""
        return ZINV_ROWS + self.n_slots + 2 * LOAD_CAP

    def counts(self) -> dict:
        """Tape rows, instructions, bundles and chunks after scheduling,
        field multiplies per row, roots, value slots; operand reads per row
        by source (total and distinct), and the device-memory loads per row
        that the chunks' load lists make of them."""
        ops = self.code[:, 0] & 7
        return {
            "tape_rows": self.recorded_ops,
            "instructions": int(len(ops)),
            "bundles": self.stats["bundles"],
            "chunks": self.stats["chunks"],
            "muls": int(sum(int((ops == o).sum()) * k for o, k in _MULS.items())),
            "roots": self.n_roots,
            "slots": self.n_slots,
            "reads": dict(self.stats["reads"]),
            "distinct_reads": dict(self.stats["distinct_reads"]),
            "loads": dict(self.stats["loads"]),
        }

    def on_device(self, device) -> dict:
        """The tape's tensors on `device`, uploaded once per device:
        instructions (T, 4) int32, chunk table (n_chunks, 8) int32, load
        words int32, constants int64, root order and scalar index int64."""
        key = str(torch.device(device))
        got = self._device.get(key)
        if got is None:
            nz = lambda a, dt: a if len(a) else np.zeros(1, dt)
            got = {
                "code": torch.from_numpy(self.code).to(device),
                "chunks": torch.from_numpy(self.chunks).to(device),
                "loads": torch.from_numpy(nz(self.loads, np.int32)).to(device),
                "consts": tensor_from_u64(nz(self.consts, np.uint64), device),
                "root_order": torch.from_numpy(self.root_order).to(device),
                "scalar_index": torch.from_numpy(nz(self.scalar_index, np.int64)).to(device),
            }
            self._device[key] = got
        return got


def record_quotient(air) -> QuotientTape:
    """Record, optimise, schedule and slot-allocate `air`'s constraint
    quotient."""
    alg = ev.RecAlg()
    n_total = air.n_cols + air.n_aux_cols
    n_off = len(air.frame_offsets)
    if n_off > MAX_OFFSETS:
        raise ValueError(f"{n_off} frame offsets; the instruction encoding names at most {MAX_OFFSETS}")
    n_per = len(air.periodic_columns())
    n_chal = 2 * air.n_challenges
    frame = Frame(
        rows=[ev._LazyInputs(alg, n_total, f"ood{oi}") for oi in range(n_off)],
        public=ev._LazyInputs(alg, air.n_public, "pub"),
        periodic=ev._LazyInputs(alg, n_per, "per"),
        public_cols=ev._LazyInputs(alg, air.n_public_cols, "pcol"),
        challenges=ev._LazyInputs(alg, n_chal, "chal"),
    )
    roots: list[int] = []
    groups: list[int] = []
    for g, fn in enumerate((air.eval_first, air.eval_transition, air.eval_cyclic, air.eval_last)):
        for c in ev._flatten_rec(fn(frame, alg)):
            roots.append(c.i)
            groups.append(g)
    if not roots:
        raise ValueError("AIR has no constraints")
    tape, remap = ev.optimize_with_remap(alg, roots)
    return _schedule(
        tape, [remap[r] for r in roots], groups,
        offsets=tuple(int(k) for k in air.frame_offsets), n_cols=air.n_cols, n_aux=air.n_aux_cols,
        n_periodic=n_per, n_public_cols=air.n_public_cols, n_public=air.n_public, n_chal=n_chal,
    )


def _operand(kind: str, i: int, n_cols: int, n_per: int, n_pub: int) -> int:
    """The mode-tagged operand of one tape input."""
    if kind.startswith("ood"):
        k = int(kind[3:])
        if i < n_cols:
            return ((i << 4 | k) << 3) | TRACE
        return (((i - n_cols) << 4 | k) << 3) | AUX
    if kind == "per":
        return i << 3 | ROW
    if kind == "pcol":
        return (n_per + i) << 3 | ROW
    if kind == "pub":
        return i << 3 | SCALAR
    if kind == "chal":
        return (n_pub + i) << 3 | SCALAR
    raise ValueError(f"unknown quotient input {kind!r}")


def _schedule(tape: ev.Tape, root_rows: list[int], groups: list[int], **shape) -> QuotientTape:
    """Instruction stream of the tape's computed rows in clustered
    depth-first order (module docstring), loads folded into operands, and
    value slots allocated by liveness (a LIFO free list; a slot returns to
    it after its value's last read, before the instruction's own result
    takes one)."""
    T = tape.n_ops
    consts: dict[int, int] = {}

    def const_operand(v: int) -> int:
        return consts.setdefault(int(v) % gl.P, len(consts)) << 3 | CONST

    # every LOAD row is an operand; every other row is a computed node
    # with its tape-row operands (a constant factor becomes a CONST operand)
    operand_of: dict[int, int] = {}
    tags = iter(tape.input_tags)
    op_l, a_l, b_l, c_l = tape.op.tolist(), tape.a.tolist(), tape.b.tolist(), tape.c.tolist()
    node: list = [None] * T  # row -> (opcode, [operand rows or ("k", operand)])
    for i in range(T):
        op = op_l[i]
        if op == ev.LOAD:
            if tape.is_input[i]:
                kind, idx = next(tags)
                operand_of[i] = _operand(kind, idx, shape["n_cols"], shape["n_periodic"], shape["n_public"])
            else:
                operand_of[i] = const_operand(tape.const[i])
        elif op == ev.ADD:
            node[i] = (ADD, (a_l[i], b_l[i]))
        elif op == ev.SUB:
            node[i] = (SUB, (a_l[i], b_l[i]))
        elif op == ev.MUL:
            node[i] = (MUL, (a_l[i], b_l[i]))
        elif op == ev.CMUL:
            node[i] = (MUL, (a_l[i], ~const_operand(tape.const[i])))
        elif op == ev.MAC:
            node[i] = (MAC, (a_l[i], b_l[i], c_l[i]))
        elif op == ev.CMAC:
            node[i] = (MAC, (a_l[i], ~const_operand(tape.const[i]), c_l[i]))
        elif op == ev.MSUB:
            node[i] = (MSUB, (a_l[i], b_l[i], c_l[i]))
        else:  # pragma: no cover - evalair emits only the ops above
            raise ValueError(f"bad tape op {op}")
    # operand lists hold tape rows (>= 0) or ~operand for a folded constant

    roots_at: dict[int, list[int]] = {}
    for k, row in enumerate(root_rows):
        roots_at.setdefault(row, []).append(k)

    # clusters: union-find over the computed nodes the roots reach
    parent = list(range(T))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    reached = bytearray(T)
    todo = [r for r in root_rows if node[r] is not None]
    while todo:
        i = todo.pop()
        if reached[i]:
            continue
        reached[i] = 1
        for x in node[i][1]:
            if x >= 0 and node[x] is not None:
                ra, rb = find(i), find(x)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
                todo.append(x)
    # each cluster's roots, the clusters in tape order of their first root
    clusters: dict[int, list[int]] = {}
    for row in sorted(roots_at):
        clusters.setdefault(find(row) if node[row] is not None else ~row, []).append(row)

    # emission: (opcode, def row | -1, operands as rows or ~operand, root k, group)
    stream: list[tuple] = []
    emitted = bytearray(T)

    def emit_roots(row: int, operand):
        for k in roots_at.get(row, ()):
            stream.append((ROOT, -1, (operand,), k, groups[k]))

    for rows in clusters.values():
        for r in rows:
            if node[r] is None:  # a root on a load: its ROOT reads the operand
                emit_roots(r, ~operand_of[r])
                continue
            stack = [(r, 0)]
            while stack:
                i, s = stack[-1]
                reads = node[i][1]
                if s < len(reads):
                    stack[-1] = (i, s + 1)
                    x = reads[s]
                    if x >= 0 and node[x] is not None and not emitted[x]:
                        stack.append((x, 0))
                    continue
                stack.pop()
                if emitted[i]:
                    continue
                emitted[i] = 1
                stream.append((node[i][0], i, reads, 0, 0))
                emit_roots(i, i)

    # operands: a computed node's row (>= 0, a value slot) or ~source
    # word (a load or a folded constant, read in place)
    def ref(x: int) -> int:
        if x < 0:
            return x
        if node[x] is None:
            return ~operand_of[x]
        return x

    stream = [(op, d, tuple(ref(x) for x in reads), k, g) for op, d, reads, k, g in stream]
    return _encode(_bundle(stream), consts, groups, recorded_ops=T, **shape)


def _bundle(stream: list) -> list:
    """Bundles of up to MAX_BUNDLE independent ALU instructions of one
    opcode: from the first instruction not yet emitted, the next ones
    (within BUNDLE_WINDOW of it) with its opcode whose operands are
    already computed join it. A bundle reads all its operands before it
    writes any result, so the kernel computes its members side by side,
    each with its opcode's arithmetic alone. Each ROOT follows the bundle
    that makes its value. Returns [(entries, ...)], one tuple per bundle
    or ROOT."""
    alu = [e for e in stream if e[0] != ROOT]
    roots_of: dict[int, list] = {}
    for e in stream:
        if e[0] == ROOT and e[2][0] >= 0:
            roots_of.setdefault(e[2][0], []).append(e)
    out = [(e,) for e in stream if e[0] == ROOT and e[2][0] < 0]  # roots on loads
    when: dict[int, int] = {}  # node row -> bundle number that computed it
    emitted = bytearray(len(alu))
    first = 0
    nb = 0
    while first < len(alu):
        op = alu[first][0]
        members = []
        loads: set = set()  # the bundle's per-row loads: one chunk's load buffer holds them
        j = first
        while j < len(alu) and j < first + BUNDLE_WINDOW and len(members) < MAX_BUNDLE:
            e = alu[j]
            if not emitted[j] and e[0] == op and all(x < 0 or when.get(x, nb) < nb for x in e[2]):
                more = loads | {~x for x in e[2] if x < 0 and (~x) & 7 in (ROW, TRACE, AUX)}
                if len(more) <= LOAD_CAP:
                    members.append(j)
                    loads = more
            j += 1
        for j in members:
            emitted[j] = 1
            when[alu[j][1]] = nb
        out.append(tuple(alu[j] for j in members))
        for j in members:
            out.extend((r,) for r in roots_of.get(alu[j][1], ()))
        nb += 1
        while first < len(alu) and emitted[first]:
            first += 1
    return out


def _encode(units: list, consts: dict, groups: list[int], **shape) -> QuotientTape:
    """Value slots by liveness (a LIFO free list: a slot is free again
    after its value's last read; a bundle reads before it writes, so a
    member's result may take a slot freed by another member), then the
    chunks and the instruction words (module docstring)."""
    flat = [e for u in units for e in u]
    last: dict[int, int] = {}
    for t, (_op, _d, reads, _k, _g) in enumerate(flat):
        for x in reads:
            if x >= 0:
                last[x] = t
    slot_of: dict[int, int] = {}
    free: list[int] = []
    n_slots = 0
    frees: list = []
    dsts: list[int] = []
    srcs: list[tuple] = []  # per instruction: its operands as ("slot", s) or ("src", word)
    for t, (op, d, reads, _k, _g) in enumerate(flat):
        srcs.append(tuple(("slot", slot_of[x]) if x >= 0 else ("src", ~x) for x in reads))
        dead = sorted({slot_of[x] for x in reads if x >= 0 and last[x] == t})
        for x in set(reads):
            if x >= 0 and last[x] == t:
                del slot_of[x]
        free.extend(dead)
        frees.append(np.asarray(dead, dtype=np.int64))
        dst = 0
        if d >= 0:
            if free:
                dst = free.pop()
            else:
                dst = n_slots
                n_slots += 1
                if n_slots > 1 << 20:
                    raise ValueError("the tape's value slots do not fit the instruction encoding")
            slot_of[d] = dst
        dsts.append(dst)
    n_slots = max(n_slots, 1)
    n_consts = len(consts)
    lbuf = ZINV_ROWS + n_slots  # per-row index of the first load buffer
    # the scalars the tape reads, as uniform words after the constants
    scalar_at: dict[int, int] = {}
    for e_src in srcs:
        for kind, w in e_src:
            if kind == "src" and w & 7 == SCALAR:
                scalar_at.setdefault(w >> 3, len(scalar_at))
    # the block size is the tape's: per-row operands are byte offsets
    row_words = lbuf + 2 * LOAD_CAP
    try:
        threads = launch_shape(row_words, n_consts + len(scalar_at))["threads"]
    except ValueError:  # too large for a card's shared memory: the plain twin still runs it
        threads = THREAD_CHOICES[-1]
    stride = 8 * threads  # bytes between a thread's consecutive per-row words

    def per_row_load(w: int) -> bool:
        return w & 7 in (ROW, TRACE, AUX)

    # chunks: whole units, at most TAPE_CHUNK instructions and LOAD_CAP
    # distinct per-row loads each
    pos = [0]
    for u in units:
        pos.append(pos[-1] + len(u))
    chunks: list[tuple] = []  # (first unit, end unit, load words)
    cur: list[int] = []
    u0 = n_ins = 0
    for ui, u in enumerate(units):
        words = {w for e_src in srcs[pos[ui] : pos[ui + 1]] for kind, w in e_src if kind == "src" and per_row_load(w)}
        merged = cur + [w for w in sorted(words) if w not in cur]
        if n_ins + len(u) > TAPE_CHUNK or len(merged) > LOAD_CAP:
            chunks.append((u0, ui, cur))
            u0, n_ins, merged = ui, 0, sorted(words)
        cur = merged
        n_ins += len(u)
    chunks.append((u0, len(units), cur))

    code = np.zeros((len(flat), 4), dtype=np.int32)
    table = np.zeros((len(chunks), 8), dtype=np.int32)
    loads: list[int] = []
    root_order: list[int] = []
    reads = {m: 0 for m in MODES}
    seen = {m: set() for m in MODES}
    for c, (ua, ub, words) in enumerate(chunks):
        at = {w: lbuf + (c & 1) * LOAD_CAP + j for j, w in enumerate(words)}
        table[c] = (pos[ua], pos[ub] - pos[ua], len(loads), len(words), len(root_order), 0, 0, 0)
        loads.extend(words)
        for ui in range(ua, ub):
            for m, t in enumerate(range(pos[ui], pos[ui + 1])):
                op, _d, _r, k, g = flat[t]
                ops = []
                for kind, w in srcs[t]:
                    if kind == "slot":
                        reads["slot"] += 1
                        seen["slot"].add(w)
                        ops.append((ZINV_ROWS + w) * stride | 1)
                        continue
                    mode, idx = w & 7, w >> 3
                    reads[MODES[mode]] += 1
                    seen[MODES[mode]].add(w)
                    if mode == CONST:
                        ops.append(8 * idx)
                    elif mode == SCALAR:
                        ops.append(8 * (n_consts + scalar_at[idx]))
                    else:
                        ops.append(at[w] * stride | 1)
                if op == ROOT:
                    root_order.append(k)
                    code[t] = (ROOT, ops[0], k, g)
                else:
                    lead = (len(units[ui]) - 1) << 3 if m == 0 else 0
                    code[t] = (op | lead | dsts[t] << 8, *ops, *[0] * (3 - len(ops)))
        table[c, 5] = len(root_order) - table[c, 4]
    const_arr = np.zeros(n_consts, dtype=np.uint64)
    for v, i in consts.items():
        const_arr[i] = v
    stats = {
        "reads": reads,
        "distinct_reads": {m: len(v) for m, v in seen.items()},
        "loads": {MODES[m]: sum(1 for w in loads if w & 7 == m) for m in (ROW, TRACE, AUX)},
        "bundles": sum(1 for u in units if u[0][0] != ROOT),
        "chunks": len(chunks),
    }
    return QuotientTape(
        code=code, consts=const_arr, n_slots=n_slots, threads=threads, chunks=table,
        loads=np.asarray(loads, dtype=np.int32), root_order=np.asarray(root_order, dtype=np.int64),
        scalar_index=np.asarray(list(scalar_at), dtype=np.int64),
        root_groups=np.asarray(groups, dtype=np.int64), frees=frees, stats=stats, **shape,
    )


_CACHE: dict = {}
# distinct AIR shapes kept (a composite has three, its wrap two more)
_CACHE_SIZE = 16


def quotient_tape(air) -> QuotientTape:
    """The compiled quotient tape of `air`'s shape (evalair.air_cache_key),
    recorded once."""
    key = ev.air_cache_key(air)
    qt = _CACHE.get(key)
    if qt is None:
        qt = record_quotient(air)
        if len(_CACHE) >= _CACHE_SIZE:
            _CACHE.clear()
        _CACHE[key] = qt
    return qt


# ---------------------------------------------------------------------------
# A shard's frame: LDE row blocks and their halos
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LdeShard:
    """Where a shard's frame rows lie. trace (n_cols, Nb) and aux
    (n_aux, Nb) are the shard's LDE row blocks; trace_halo and aux_halo
    hold (at least) the max(offsets) * blowup rows that follow the block
    (the right neighbour's leading rows; on one device the block's own),
    row-major with unit stride along the rows (a view is fine). Offset k
    of local row r is block row r + offsets[k] * blowup, read from the
    halo past the block's end."""

    trace: GF
    aux: GF | None
    trace_halo: GF | None
    aux_halo: GF | None
    blowup: int

    @property
    def rows(self) -> int:
        return int(self.trace.shape[1])

    @property
    def device(self) -> torch.device:
        return self.trace.device


def _window(block: torch.Tensor, halo, p0: int, p1: int) -> torch.Tensor:
    """Columns [p0, p1) of cat([block, halo], dim=1) (rows are the LDE's
    columns), without materializing the concatenation."""
    nb = int(block.shape[1])
    if p1 <= nb:
        return block[:, p0:p1]
    if p0 >= nb:
        return halo[:, p0 - nb : p1 - nb]
    return torch.cat([block[:, p0:], halo[:, : p1 - nb]], dim=1)


def _frame_rows(block: torch.Tensor, halo, col: int, p0: int, p1: int) -> torch.Tensor:
    """LDE rows [p0, p1) of column `col` of a block and its halo."""
    return _window(block[col : col + 1], None if halo is None else halo[col : col + 1], p0, p1)[0]


def gather_frame(shard: LdeShard, offsets, r0: int, r1: int) -> GF:
    """The (n_offsets, n_cols + n_aux, r1 - r0) frame of local rows
    [r0, r1), as ``_eval_quotient_plain`` takes it."""
    frame = []
    for k in offsets:
        p0, p1 = r0 + k * shard.blowup, r1 + k * shard.blowup
        f = _window(shard.trace.v, None if shard.trace_halo is None else shard.trace_halo.v, p0, p1)
        if shard.aux is not None:
            f = torch.cat([f, _window(shard.aux.v, shard.aux_halo.v, p0, p1)])
        frame.append(f)
    return GF(torch.stack(frame))


# ---------------------------------------------------------------------------
# Plain executor (int64 torch ops, vectorised over rows)
# ---------------------------------------------------------------------------

# the value written into a dead slot by execute_plain(poison=True)
_POISON = 0x0123456789ABCDEF


def _rowvecs(periodic, public_cols, zinvs) -> list[torch.Tensor]:
    return [p.v for p in periodic] + [p.v for p in public_cols] + [z.v for z in zinvs]


def _check_inputs(
    qt: QuotientTape, shard: LdeShard, alpha_pows: GF2, pub: GF, periodic, public_cols, zinvs, chal: GF,
    rows,
) -> tuple[int, int]:
    """The checked local row range (r0, r1)."""
    nb = shard.rows
    if shard.trace.v.dim() != 2 or int(shard.trace.shape[0]) != qt.n_cols:
        raise ValueError(f"trace block has shape {tuple(shard.trace.shape)}, the AIR wants {qt.n_cols} x rows")
    if (shard.aux is None) != (qt.n_aux == 0):
        raise ValueError(f"the AIR has {qt.n_aux} aux columns, the shard {'no' if shard.aux is None else 'an'} aux block")
    if shard.aux is not None and tuple(shard.aux.shape) != (qt.n_aux, nb):
        raise ValueError(f"aux block has shape {tuple(shard.aux.shape)}, the AIR wants {(qt.n_aux, nb)}")
    halo = max(qt.offsets) * shard.blowup
    if halo > nb:
        raise ValueError(f"a shard of {nb} rows is shorter than the frame halo of {halo}")
    for blk, h in ((shard.trace, shard.trace_halo), (shard.aux, shard.aux_halo)):
        if blk is not None and halo and (
            h is None or h.v.dim() != 2 or int(h.shape[0]) != int(blk.shape[0]) or int(h.shape[1]) < halo
        ):
            raise ValueError(f"a halo of shape {None if h is None else tuple(h.shape)} for a frame halo of {halo} rows")
    r0, r1 = (0, nb) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 <= r1 <= nb:
        raise ValueError(f"row range [{r0}, {r1}) outside the shard's {nb} rows")
    counts = (len(periodic), len(public_cols), len(zinvs), int(pub.shape[0]), int(chal.shape[0]))
    if counts != (qt.n_periodic, qt.n_public_cols, 4, qt.n_public, qt.n_chal):
        raise ValueError(f"quotient inputs (periodic, public cols, zinvs, publics, challenges) {counts}")
    for r in _rowvecs(periodic, public_cols, zinvs):
        if r.dim() != 1 or int(r.shape[0]) != nb:
            raise ValueError(f"a row input of shape {tuple(r.shape)} for a shard of {nb} rows")
    if tuple(alpha_pows.shape) != (qt.n_roots,):
        raise ValueError(f"{tuple(alpha_pows.shape)} alpha powers for {qt.n_roots} constraints")
    return r0, r1


def execute_plain(
    qt: QuotientTape, shard: LdeShard, alpha_pows: GF2, pub: GF, periodic, public_cols, zinvs, chal: GF,
    rows=None, *, poison: bool = False,
) -> GF2:
    """Run the tape as the kernel does, as int64 torch ops over local rows
    rows = (r0, r1) of the shard (default: all), on any device: per chunk,
    its load list read from the LDE blocks, halos and the shard's row
    inputs into the chunk's load buffer, then its
    instructions over the per-row words (zerofier inverses, value slots,
    load buffers) and the uniform words (constants, publics, challenges).
    With poison=True every slot is overwritten with a constant once its
    value is dead, so a slot freed too early shows."""
    r0, r1 = _check_inputs(qt, shard, alpha_pows, pub, periodic, public_cols, zinvs, chal, rows)
    dev = shard.device
    n = r1 - r0
    rowvecs = [r[r0:r1] for r in _rowvecs(periodic, public_cols, zinvs)]
    scalars = torch.cat([pub.v.reshape(-1), chal.v.reshape(-1)])
    uniform = torch.cat([tensor_from_u64(qt.consts, dev), scalars[torch.from_numpy(qt.scalar_index).to(dev)]])
    blocks = {TRACE: (shard.trace.v, None if shard.trace_halo is None else shard.trace_halo.v)}
    if shard.aux is not None:
        blocks[AUX] = (shard.aux.v, None if shard.aux_halo is None else shard.aux_halo.v)
    shifts = [k * shard.blowup for k in qt.offsets]
    order = torch.from_numpy(qt.root_order).to(dev)
    a0, a1 = alpha_pows.c0.v[order], alpha_pows.c1.v[order]
    poison_v = torch.full((n,), _POISON, dtype=torch.int64, device=dev)
    words: list = [None] * qt.row_words  # per-row words
    words[:ZINV_ROWS] = rowvecs[qt.zinv_base : qt.zinv_base + 4]
    lbuf = ZINV_ROWS + qt.n_slots
    acc0 = torch.zeros(n, dtype=torch.int64, device=dev)
    acc1 = torch.zeros(n, dtype=torch.int64, device=dev)
    mul, add, sub = gl.mul, gl.add, gl.sub

    def load(w: int) -> torch.Tensor:
        mode, idx = w & 7, w >> 3
        if mode == ROW:
            return rowvecs[idx]
        block, halo = blocks[mode]
        s = shifts[idx & 15]
        return _frame_rows(block, halo, idx >> 4, r0 + s, r1 + s)

    stride = 8 * qt.threads

    def fetch(w: int) -> torch.Tensor:
        return words[w // stride] if w & 1 else uniform[w >> 3].expand(n)

    code = qt.code.tolist()
    loads = qt.loads.tolist()
    for c, (i0, ni, l0, nl, q0, _nq, _, _) in enumerate(qt.chunks.tolist()):
        base = lbuf + (c & 1) * LOAD_CAP
        for j in range(nl):
            words[base + j] = load(loads[l0 + j])
        q = q0
        for t in range(i0, i0 + ni):
            w0, a, b, cc = code[t]
            op = w0 & 7
            if op == ROOT:
                v = mul(fetch(a), words[cc])
                acc0 = add(acc0, mul(v, a0[q]))
                acc1 = add(acc1, mul(v, a1[q]))
                q += 1
            else:
                x, y = fetch(a), fetch(b)
                if op == ADD:
                    v = add(x, y)
                elif op == SUB:
                    v = sub(x, y)
                elif op == MUL:
                    v = mul(x, y)
                elif op == MAC:
                    v = add(fetch(cc), mul(x, y))
                elif op == MSUB:
                    v = sub(fetch(cc), mul(x, y))
                else:  # pragma: no cover - _encode emits only the ops above
                    raise ValueError(f"bad quotient opcode {op}")
            if poison:
                for s in qt.frees[t].tolist():
                    words[ZINV_ROWS + s] = poison_v
            if op != ROOT:
                words[ZINV_ROWS + (w0 >> 8)] = v
    return GF2(GF(acc0), GF(acc1))


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/quotient.cu)
# ---------------------------------------------------------------------------

# incremented exactly where the kernel is launched
quotient_kernel_launches = 0

# Shared memory on sm_90: a block may opt into 232,448 bytes of dynamic
# shared memory; an SM has 233,472 and reserves 1,024 of them per block
# (CUDA C++ Programming Guide, compute capability 9.0).
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
MAX_THREADS_PER_SM = 2048
# rows (threads) a block may have, tried largest first
THREAD_CHOICES = (256, 128, 64, 32)


def shared_bytes(row_words: int, n_uniform: int, threads: int) -> int:
    """Dynamic shared memory of one block (the layout of csrc/quotient.cu):
    two tape buffers, the uniform words (an even count) and two alpha
    buffers, and `threads` rows of per-row words."""
    return 2 * 16 * TAPE_CHUNK + 8 * ((n_uniform + 1) // 2 * 2 + 2 * 2 * TAPE_CHUNK) + 8 * row_words * threads


def launch_shape(row_words: int, n_uniform: int) -> dict:
    """Rows a block (threads) and shared bytes for a tape with `row_words`
    per-row words (value slots and load buffers): the block size that
    keeps the most rows resident on an SM under the shared-memory limit;
    among those, one that leaves two blocks on an SM (one block's chunk
    switch then overlaps the other's work), then the larger. Every slot
    lives in shared memory; a tape whose words do not fit one block of
    the smallest size raises (there is no spill tier)."""
    best, rank = None, None
    for t in THREAD_CHOICES:
        smem = shared_bytes(row_words, n_uniform, t)
        if smem > SMEM_PER_BLOCK:
            continue
        blocks = min(SMEM_PER_SM // (smem + SMEM_RESERVED), MAX_THREADS_PER_SM // t)
        r = (blocks * t, min(blocks, 2), t)
        if rank is None or r > rank:
            best, rank = {"threads": t, "shared_bytes": smem, "blocks_per_sm": blocks, "resident_rows": blocks * t}, r
    if best is None:
        smem = shared_bytes(row_words, n_uniform, THREAD_CHOICES[-1])
        raise ValueError(
            f"a tape of {row_words} per-row words does not fit shared memory: {smem} bytes for "
            f"{THREAD_CHOICES[-1]} rows, {SMEM_PER_BLOCK} the most a block may have"
        )
    return best


class _Args(ctypes.Structure):
    """csrc/quotient.cu's QuotientArgs, field for field."""

    _fields_ = [
        ("tape", ctypes.c_void_p), ("chunks", ctypes.c_void_p), ("n_chunks", ctypes.c_int64),
        ("loads", ctypes.c_void_p), ("load_addr", ctypes.c_void_p),
        ("consts", ctypes.c_void_p), ("n_consts", ctypes.c_int64),
        ("scalars", ctypes.c_void_p), ("scalar_index", ctypes.c_void_p), ("n_scalars", ctypes.c_int64),
        ("alpha", ctypes.c_void_p),
        ("zinv", ctypes.c_void_p * ZINV_ROWS),
        ("block_rows", ctypes.c_int64),
        ("shift", ctypes.c_int64 * MAX_OFFSETS),
        ("n_slots", ctypes.c_int64),
        ("r0", ctypes.c_int64), ("rows", ctypes.c_int64),
        ("out", ctypes.c_void_p),
    ]


@cache
def _library():
    from ..ops.cuda_build import load_library

    lib = load_library("quotient")
    lib.tmx_quotient.restype = ctypes.c_int
    lib.tmx_quotient.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    lib.tmx_quotient_occupancy.restype = ctypes.c_int
    lib.tmx_quotient_occupancy.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    return lib


def blocks_per_sm(threads: int, smem: int) -> int:
    """The card's resident blocks per SM for the kernel at this launch
    shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n = ctypes.c_int(0)
    err = _library().tmx_quotient_occupancy(threads, smem, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"tmx_quotient_occupancy failed: CUDA error {err}")
    return int(n.value)


def _check_cuda(x: torch.Tensor, what: str, dev, *, rows_unit_stride: bool = False):
    if x.device != dev or x.dtype != torch.int64:
        raise TypeError(f"quotient_cuda: {what} must be int64 on {dev}, got {x.dtype} on {x.device}")
    if rows_unit_stride:
        if x.stride(-1) != 1:
            raise ValueError(f"quotient_cuda: {what} must have unit stride along its rows")
    elif not x.is_contiguous():
        raise ValueError(f"quotient_cuda: {what} must be contiguous")


def _load_addresses(qt: QuotientTape, loads: torch.Tensor, shard: LdeShard, rowvecs: list) -> torch.Tensor:
    """(n_loads, 2) int64 on the shard's card: for each load word, the byte
    address of its value for local row 0 in the shard's block and in the
    halo past it (csrc/quotient.cu adds 8 * row to the one the row's
    offset reaches). A row input's two addresses are equal."""
    dev = shard.device
    halo = max(qt.offsets) * shard.blowup
    mode, idx = loads & 7, (loads >> 3).long()
    k, col = idx & (MAX_OFFSETS - 1), idx >> 4
    shift = torch.tensor([o * shard.blowup for o in qt.offsets] + [0] * (MAX_OFFSETS - qt.n_offsets), device=dev)[k]
    nb = shard.rows
    blk = torch.zeros_like(idx)
    hal = torch.zeros_like(idx)
    for m, block, h in ((TRACE, shard.trace, shard.trace_halo), (AUX, shard.aux, shard.aux_halo)):
        if block is None:
            continue
        hv = h.v if halo else block.v
        sel = mode == m
        blk = torch.where(sel, block.v.data_ptr() + 8 * (col * nb + shift), blk)
        hal = torch.where(sel, hv.data_ptr() + 8 * (col * hv.stride(0) + shift - nb), hal)
    if rowvecs:
        ptrs = torch.tensor([r.data_ptr() for r in rowvecs], dtype=torch.int64, device=dev)
        row = ptrs[torch.where(mode == ROW, idx, 0).clamp(max=len(rowvecs) - 1)]
        blk = torch.where(mode == ROW, row, blk)
        hal = torch.where(mode == ROW, row, hal)
    return torch.stack([blk, hal], dim=1).contiguous()


def quotient_cuda(
    air, shard: LdeShard, alpha_pows: GF2, pub: GF, periodic, public_cols, zinvs, chal: GF,
    rows=None,
) -> GF2:
    """Launch the tape kernel over local rows rows = (r0, r1) of a CUDA
    shard (default: all, one launch): the (r1 - r0,) GF(p^2) quotient
    numerators, reading the frame from the shard's LDE blocks and halos
    and the shard's row inputs."""
    global quotient_kernel_launches
    qt = quotient_tape(air)
    r0, r1 = _check_inputs(qt, shard, alpha_pows, pub, periodic, public_cols, zinvs, chal, rows)
    dev = shard.device
    if dev.type != "cuda":
        raise TypeError(f"quotient_cuda takes a CUDA shard, got {dev}")
    _check_cuda(shard.trace.v, "the trace block", dev)
    if shard.aux is not None:
        _check_cuda(shard.aux.v, "the aux block", dev)
    for what, h in (("the trace halo", shard.trace_halo), ("the aux halo", shard.aux_halo)):
        if h is not None:
            _check_cuda(h.v, what, dev, rows_unit_stride=True)
    for what, t in (("a public", pub.v), ("a challenge", chal.v), ("alpha c0", alpha_pows.c0.v),
                    ("alpha c1", alpha_pows.c1.v)):
        _check_cuda(t, what, dev)
    vecs = _rowvecs(periodic, public_cols, zinvs)
    for r in vecs:
        _check_cuda(r, "a row input", dev)
    shape = launch_shape(qt.row_words, qt.n_uniform)
    if shape["threads"] != qt.threads:
        raise ValueError(f"the tape was encoded for blocks of {qt.threads} rows, the card takes {shape['threads']}")
    n = r1 - r0
    out = torch.empty((2, n), dtype=torch.int64, device=dev)
    if n == 0:
        return GF2(GF(out[0]), GF(out[1]))
    tape = qt.on_device(dev)
    scalars = torch.cat([pub.v, chal.v, torch.zeros(1, dtype=torch.int64, device=dev)])
    # alpha^k of each ROOT in tape order, (c0, c1) pairs
    order = tape["root_order"]
    alpha = torch.stack([alpha_pows.c0.v[order], alpha_pows.c1.v[order]], dim=1).contiguous()
    load_addr = _load_addresses(qt, tape["loads"], shard, vecs[: qt.zinv_base])
    args = _Args(
        tape=tape["code"].data_ptr(), chunks=tape["chunks"].data_ptr(), n_chunks=len(qt.chunks),
        loads=tape["loads"].data_ptr(), load_addr=load_addr.data_ptr(),
        consts=tape["consts"].data_ptr(), n_consts=len(qt.consts),
        scalars=scalars.data_ptr(), scalar_index=tape["scalar_index"].data_ptr(),
        n_scalars=len(qt.scalar_index),
        alpha=alpha.data_ptr(),
        block_rows=shard.rows, n_slots=qt.n_slots, r0=r0, rows=n, out=out.data_ptr(),
    )
    for g, z in enumerate(vecs[qt.zinv_base :]):
        args.zinv[g] = z.data_ptr()
    for i, k in enumerate(qt.offsets):
        args.shift[i] = k * shard.blowup
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tmx_quotient(ctypes.byref(args), shape["threads"], shape["shared_bytes"], stream)
        if err != 0:
            raise RuntimeError(f"tmx_quotient launch failed: CUDA error {err}")
        quotient_kernel_launches += 1
    return GF2(GF(out[0]), GF(out[1]))
