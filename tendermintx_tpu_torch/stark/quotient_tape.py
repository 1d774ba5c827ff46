"""The constraint quotient as a recorded tape, run by a hand CUDA kernel.

Counterpart of the reference's XLA program for the quotient,
``tendermintx_tpu/stark/prover.py:293`` ``_build_quotient_fn`` (its
``jax.jit`` at ``:363-364``) over ``:379`` ``_eval_quotient_core``: per
LDE row, evaluate the AIR's first, transition, cyclic and last
constraints on the gathered frame, scale each by its zerofier inverse and
sum alpha^k * c_k into GF(p^2).

Eager torch runs that program at ~45 launches per field multiply. Here
each AIR's ``eval_*`` methods are recorded once per AIR shape under the
recording algebra (``evalair.RecAlg``) into a straight-line tape of
base-field ops, which one generic kernel (``csrc/quotient.cu``) runs, one
LDE row per thread. No AIR has constraint code of its own in CUDA.

  * ``record_quotient`` records the four groups with the frame, publics,
    periodic and public columns and challenges as lazy tape inputs, runs
    ``evalair.optimize_with_remap`` with the flattened constraints as
    roots (dead-code elimination, MAC fusion), and allocates value slots
    by liveness in tape order: a slot is free again once its value has
    been read for the last time, so the slot count is the tape's peak
    live set, not its length. Each root becomes a ROOT instruction right
    after the op that makes its value: ``acc += alpha^k * c * zinv_g``.
  * ``quotient_tape(air)`` caches the compiled tape per
    ``evalair.air_cache_key``; its device copy (instructions and uint64
    constants) is uploaded once per device.
  * ``execute_plain`` runs the same instructions as int64 torch ops,
    vectorised over rows (the CPU tests hold it against the DeviceAlgebra
    evaluation of ``stark/prover.py``); ``quotient_cuda`` launches the
    kernel. ``stark/prover.py::_eval_quotient_core`` launches the kernel
    for a CUDA frame and runs its DeviceAlgebra body for a CPU one.

Instruction encoding (int32 x 4 per instruction; ``op | dst << 8, a, b, c``):

  CONST   slot[dst] = consts[a]         FRAME  slot[dst] = frame[a][row]
  ROW     slot[dst] = rowvecs[a][row]   SCALAR slot[dst] = scalars[a]
  ADD     a + b     SUB  a - b          MUL    a * b
  CMUL    consts[b] * a                 CMAC   consts[b] * a + c
  MAC     a * b + c                     MSUB   c - a * b
  ROOT    acc += alpha^b * slot[a] * rowvecs[zinv_base + c][row]

with frame = the (n_offsets * n_total, B) gathered block, rowvecs = the
periodic columns, then the public columns, then the four zerofier
inverses (first, transition, cyclic, last), and scalars = the publics,
then the challenge components.
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

CONST, FRAME, ROW, SCALAR, ADD, SUB, MUL, CMUL, MAC, MSUB, CMAC, ROOT = range(12)
_BINARY = {ev.ADD: ADD, ev.SUB: SUB, ev.MUL: MUL}
# field multiplies per instruction (a ROOT scales by zinv, then by alpha's
# two components)
_MULS = {MUL: 1, CMUL: 1, MAC: 1, MSUB: 1, CMAC: 1, ROOT: 3}


@dataclass
class QuotientTape:
    """One AIR shape's compiled quotient program."""

    code: np.ndarray  # (T, 4) int32 instructions (module docstring)
    consts: np.ndarray  # uint64 constants (CONST values, CMUL/CMAC factors)
    n_slots: int
    # per root k (alpha power k): its constraint group, which is also its
    # zerofier inverse's index: 0 first, 1 transition, 2 cyclic, 3 last
    root_groups: np.ndarray
    # slots whose value is dead after instruction t (read for the last
    # time there): the plain executor's poisoning check reads them
    frees: list
    n_offsets: int
    n_total: int
    n_periodic: int
    n_public_cols: int
    n_public: int
    n_chal: int
    recorded_ops: int  # rows of the optimised tape, before _allocate drops the unread ones
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def n_roots(self) -> int:
        return len(self.root_groups)

    @property
    def zinv_base(self) -> int:
        return self.n_periodic + self.n_public_cols

    def counts(self) -> dict:
        """Tape rows, instructions, field multiplies per row, roots, slots."""
        ops = self.code[:, 0] & 0xFF
        return {
            "tape_rows": self.recorded_ops,
            "instructions": int(len(ops)),
            "muls": int(sum(int((ops == o).sum()) * k for o, k in _MULS.items())),
            "roots": self.n_roots,
            "slots": self.n_slots,
        }

    def on_device(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(instructions (T, 4) int32, constants int64) on `device`,
        uploaded once per device."""
        key = str(torch.device(device))
        got = self._device.get(key)
        if got is None:
            got = (
                torch.from_numpy(self.code).to(device),
                tensor_from_u64(self.consts if len(self.consts) else np.zeros(1, np.uint64), device),
            )
            self._device[key] = got
        return got


def record_quotient(air) -> QuotientTape:
    """Record, optimise and slot-allocate `air`'s constraint quotient."""
    alg = ev.RecAlg()
    n_total = air.n_cols + air.n_aux_cols
    n_off = len(air.frame_offsets)
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
    return _allocate(
        tape, [remap[r] for r in roots], groups,
        n_offsets=n_off, n_total=n_total, n_periodic=n_per,
        n_public_cols=air.n_public_cols, n_public=air.n_public, n_chal=n_chal,
    )


def _source(kind: str, i: int, n_total: int, n_per: int, n_pub: int) -> tuple[int, int]:
    """(load opcode, operand) of one tape input."""
    if kind.startswith("ood"):
        return FRAME, int(kind[3:]) * n_total + i
    if kind == "per":
        return ROW, i
    if kind == "pcol":
        return ROW, n_per + i
    if kind == "pub":
        return SCALAR, i
    if kind == "chal":
        return SCALAR, n_pub + i
    raise ValueError(f"unknown quotient input {kind!r}")


def _allocate(tape: ev.Tape, root_rows: list[int], groups: list[int], **shape) -> QuotientTape:
    """Instruction stream with value slots allocated by liveness: ROOT
    instructions follow the row that makes their value, and a slot returns
    to the free list (last in, first out) after its value's last read,
    before the instruction's own result takes one."""
    T = tape.n_ops
    roots_at: dict[int, list[int]] = {}
    for k, row in enumerate(root_rows):
        roots_at.setdefault(row, []).append(k)
    tag_iter = iter(tape.input_tags)
    consts: dict[int, int] = {}

    def const_index(v: int) -> int:
        return consts.setdefault(int(v) % gl.P, len(consts))

    # instruction stream over tape rows (operands still tape rows)
    stream: list[tuple[int, int, int, int, int]] = []  # (op, def row | -1, a, b, c)
    for i in range(T):
        op = int(tape.op[i])
        a, b, c = int(tape.a[i]), int(tape.b[i]), int(tape.c[i])
        if op == ev.LOAD:
            if tape.is_input[i]:
                kind, idx = next(tag_iter)
                lop, operand = _source(kind, idx, shape["n_total"], shape["n_periodic"], shape["n_public"])
                stream.append((lop, i, operand, 0, 0))
            else:
                stream.append((CONST, i, const_index(tape.const[i]), 0, 0))
        elif op in _BINARY:
            stream.append((_BINARY[op], i, a, b, 0))
        elif op == ev.CMUL:
            stream.append((CMUL, i, a, const_index(tape.const[i]), 0))
        elif op == ev.CMAC:
            stream.append((CMAC, i, a, const_index(tape.const[i]), c))
        elif op == ev.MAC:
            stream.append((MAC, i, a, b, c))
        elif op == ev.MSUB:
            stream.append((MSUB, i, a, b, c))
        else:  # pragma: no cover - evalair emits only the ops above
            raise ValueError(f"bad tape op {op}")
        for k in roots_at.get(i, ()):
            stream.append((ROOT, -1, i, k, groups[k]))

    def reads(ins) -> tuple[int, ...]:
        op, _d, a, b, c = ins
        if op in (ADD, SUB, MUL):
            return (a, b)
        if op == CMUL:
            return (a,)
        if op in (MAC, MSUB):
            return (a, b, c)
        if op == CMAC:
            return (a, c)
        if op == ROOT:
            return (a,)
        return ()

    # MAC fusion leaves the fused multiply's own row on the tape, unread:
    # keep only what a ROOT reads, directly or through other rows
    needed: set[int] = set()
    kept = []
    for ins in reversed(stream):
        if ins[0] == ROOT or ins[1] in needed:
            needed.update(reads(ins))
            kept.append(ins)
    stream = kept[::-1]

    last = {}
    for t, ins in enumerate(stream):
        for r in reads(ins):
            last[r] = t
    slot_of: dict[int, int] = {}
    free: list[int] = []
    n_slots = 0
    code = np.zeros((len(stream), 4), dtype=np.int32)
    frees: list = []
    for t, ins in enumerate(stream):
        op, d, a, b, c = ins
        rd = reads(ins)
        operands = {r: slot_of[r] for r in rd}
        dead = sorted({operands[r] for r in rd if last[r] == t})
        for r in set(rd):
            if last[r] == t:
                del slot_of[r]
        free.extend(dead)
        frees.append(np.asarray(dead, dtype=np.int64))
        dst = 0
        if d >= 0:
            if free:
                dst = free.pop()
            else:
                dst = n_slots
                n_slots += 1
                if n_slots > 1 << 23:
                    raise ValueError("the tape's value slots do not fit the instruction encoding")
            slot_of[d] = dst
        if op in (ADD, SUB, MUL, MAC, MSUB):
            a, b = operands[a], operands[b]
            c = operands[c] if op in (MAC, MSUB) else 0
        elif op in (CMUL, CMAC):
            a = operands[a]
            c = operands[c] if op == CMAC else 0
        elif op == ROOT:
            a = operands[a]
        code[t] = (op | (dst << 8), a, b, c)
    const_arr = np.zeros(len(consts), dtype=np.uint64)
    for v, i in consts.items():
        const_arr[i] = v
    return QuotientTape(
        code=code, consts=const_arr, n_slots=max(n_slots, 1),
        root_groups=np.asarray(groups, dtype=np.int64), frees=frees,
        recorded_ops=T, **shape,
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
# Plain executor (int64 torch ops, vectorised over rows)
# ---------------------------------------------------------------------------

# the value written into a dead slot by execute_plain(poison=True)
_POISON = 0x0123456789ABCDEF


def _rowvecs(periodic, public_cols, zinvs) -> list[torch.Tensor]:
    return [p.v for p in periodic] + [p.v for p in public_cols] + [z.v for z in zinvs]


def _check_inputs(qt: QuotientTape, stacked: GF, alpha_pows: GF2, pub: GF, periodic, public_cols, zinvs, chal: GF):
    want = (qt.n_offsets, qt.n_total)
    if stacked.v.dim() != 3 or tuple(stacked.shape[:2]) != want:
        raise ValueError(f"frame block has shape {tuple(stacked.shape)}, the AIR wants {want} x rows")
    B = int(stacked.shape[2])
    counts = (len(periodic), len(public_cols), len(zinvs), int(pub.shape[0]), int(chal.shape[0]))
    if counts != (qt.n_periodic, qt.n_public_cols, 4, qt.n_public, qt.n_chal):
        raise ValueError(f"quotient inputs (periodic, public cols, zinvs, publics, challenges) {counts}")
    for r in _rowvecs(periodic, public_cols, zinvs):
        if tuple(r.shape) != (B,):
            raise ValueError(f"a row input has shape {tuple(r.shape)}, the block has {B} rows")
    if tuple(alpha_pows.shape) != (qt.n_roots,):
        raise ValueError(f"{tuple(alpha_pows.shape)} alpha powers for {qt.n_roots} constraints")


def execute_plain(
    qt: QuotientTape, stacked: GF, alpha_pows: GF2, pub: GF, periodic, public_cols, zinvs, chal: GF,
    *, poison: bool = False,
) -> GF2:
    """Run the tape's instructions as int64 torch ops over the block's rows
    (any device). With poison=True every slot is overwritten with a
    constant once its value is dead, so a slot freed too early shows."""
    _check_inputs(qt, stacked, alpha_pows, pub, periodic, public_cols, zinvs, chal)
    dev = stacked.device
    B = int(stacked.shape[2])
    frame = stacked.v.reshape(-1, B)
    rowvecs = _rowvecs(periodic, public_cols, zinvs)
    scalars = torch.cat([pub.v.reshape(-1), chal.v.reshape(-1)])
    consts = tensor_from_u64(qt.consts, dev)
    a0, a1 = alpha_pows.c0.v, alpha_pows.c1.v
    poison_v = torch.full((B,), _POISON, dtype=torch.int64, device=dev)
    slots: list = [None] * qt.n_slots
    acc0 = torch.zeros(B, dtype=torch.int64, device=dev)
    acc1 = torch.zeros(B, dtype=torch.int64, device=dev)
    mul, add, sub = gl.mul, gl.add, gl.sub
    for t, (od, a, b, c) in enumerate(qt.code.tolist()):
        op, dst = od & 0xFF, od >> 8
        if op == ROOT:
            v = mul(slots[a], rowvecs[qt.zinv_base + c])
            acc0 = add(acc0, mul(v, a0[b]))
            acc1 = add(acc1, mul(v, a1[b]))
        elif op == CONST:
            v = consts[a].expand(B)
        elif op == FRAME:
            v = frame[a]
        elif op == ROW:
            v = rowvecs[a]
        elif op == SCALAR:
            v = scalars[a].expand(B)
        elif op == ADD:
            v = add(slots[a], slots[b])
        elif op == SUB:
            v = sub(slots[a], slots[b])
        elif op == MUL:
            v = mul(slots[a], slots[b])
        elif op == CMUL:
            v = mul(consts[b], slots[a])
        elif op == MAC:
            v = add(mul(slots[a], slots[b]), slots[c])
        elif op == MSUB:
            v = sub(slots[c], mul(slots[a], slots[b]))
        elif op == CMAC:
            v = add(mul(consts[b], slots[a]), slots[c])
        else:  # pragma: no cover - _allocate emits only the ops above
            raise ValueError(f"bad quotient opcode {op}")
        if poison:
            for s in qt.frees[t].tolist():
                slots[s] = poison_v
        if op != ROOT:
            slots[dst] = v
    return GF2(GF(acc0), GF(acc1))


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/quotient.cu)
# ---------------------------------------------------------------------------

# incremented exactly where the kernel is launched
quotient_kernel_launches = 0

# The scratch buffer holds every value slot of every row of one launch
# ([slot][row], 8 bytes each). Rows per launch are chosen so that it stays
# within this size: the Ed25519 quotient at N=128 (6,264 slots) runs its
# 2^16-row blocks in one launch each with 3.3 GB of scratch.
SCRATCH_BYTES = 1 << 32
THREADS = 128


@cache
def _library():
    from ..ops.cuda_build import load_library

    lib = load_library("quotient")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tmx_quotient.restype = ctypes.c_int
    lib.tmx_quotient.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr] + [i64] * 6 + [ptr]
    return lib


def rows_per_launch(n_slots: int, B: int) -> int:
    """Rows of one launch: all of the block's B rows when their scratch
    fits SCRATCH_BYTES, else the largest multiple of THREADS that does."""
    fit = SCRATCH_BYTES // (8 * n_slots)
    if fit >= B:
        return B
    return max(THREADS, fit // THREADS * THREADS)


def _check_cuda(x: torch.Tensor, what: str, dev):
    if x.device != dev or x.dtype != torch.int64:
        raise TypeError(f"quotient_cuda: {what} must be int64 on {dev}, got {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"quotient_cuda: {what} must be contiguous")


def quotient_cuda(air, stacked: GF, alpha_pows: GF2, pub: GF, periodic, public_cols, zinvs, chal: GF) -> GF2:
    """Launch the tape kernel on a gathered (n_offsets, n_total, B) CUDA
    frame block: the (B,) GF(p^2) quotient numerators of
    stark/prover.py::_eval_quotient_core."""
    global quotient_kernel_launches
    qt = quotient_tape(air)
    _check_inputs(qt, stacked, alpha_pows, pub, periodic, public_cols, zinvs, chal)
    x = stacked.v
    dev = x.device
    if dev.type != "cuda":
        raise TypeError(f"quotient_cuda takes a CUDA frame block, got {dev}")
    _check_cuda(x, "the frame block", dev)
    for what, t in (("a public", pub.v), ("a challenge", chal.v), ("alpha c0", alpha_pows.c0.v),
                    ("alpha c1", alpha_pows.c1.v)):
        _check_cuda(t, what, dev)
    rows = _rowvecs(periodic, public_cols, zinvs)
    for r in rows:
        if r.device != dev or r.dtype != torch.int64:
            raise TypeError(f"quotient_cuda: a row input is {r.dtype} on {r.device}, not int64 on {dev}")
    B = int(x.shape[2])
    code, consts = qt.on_device(dev)
    rowvecs = torch.stack(rows)
    scalars = torch.cat([pub.v, chal.v, torch.zeros(1, dtype=torch.int64, device=dev)])
    alpha = torch.cat([alpha_pows.c0.v, alpha_pows.c1.v])
    out = torch.empty((2, B), dtype=torch.int64, device=dev)
    R = rows_per_launch(qt.n_slots, B)
    scratch = torch.empty((qt.n_slots, R), dtype=torch.int64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for r0 in range(0, B, R):
            err = lib.tmx_quotient(
                code.data_ptr(), int(code.shape[0]), consts.data_ptr(), x.data_ptr(),
                rowvecs.data_ptr(), scalars.data_ptr(), alpha.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), B, r0, min(R, B - r0), R, qt.n_roots, qt.zinv_base, stream,
            )
            if err != 0:
                raise RuntimeError(f"tmx_quotient launch failed: CUDA error {err}")
            quotient_kernel_launches += 1
    return GF2(GF(out[0]), GF(out[1]))
