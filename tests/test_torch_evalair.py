"""The port's EvalAir (stark/evalair.py) against the JAX package: recording
semantics, the tape of a Fibonacci statement and of the three N=4
composite AIRs (field for field), the EvalAir witness, public and aux
columns, and the EvalAir STARK round trip. Exact equality throughout."""

import copy
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.ext import GF2 as JGF2
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import evalair as jev
from tendermintx_tpu.stark.ed25519_air import Ed25519Air as JEd25519Air
from tendermintx_tpu.stark.sha256_air import Sha256Air as JSha256Air
from tendermintx_tpu.stark.sha512_air import Sha512Air as JSha512Air
from tendermintx_tpu_torch.ops.ext import GF2, ext_add, ext_mul, ext_sub
from tendermintx_tpu_torch.ops.goldilocks import GF, P
from tendermintx_tpu_torch.stark import evalair as ev
from tendermintx_tpu_torch.stark.air import Air
from tendermintx_tpu_torch.stark.batch import prove_batch, verify_batch
from tendermintx_tpu_torch.stark.challenger import Challenger
from tendermintx_tpu_torch.stark.ed25519_air import Ed25519Air
from tendermintx_tpu_torch.stark.prover import StarkConfig
from tendermintx_tpu_torch.stark.sha256_air import Sha256Air
from tendermintx_tpu_torch.stark.sha512_air import Sha512Air
from tendermintx_tpu_torch.stark.verifier import ood_identity, replay_statement

from test_evalair import FibAir as JFibAir

CFG = StarkConfig(rate_bits=3, n_queries=8, final_poly_len=8)
TAPE_FIELDS = ("op", "a", "b", "c", "m", "const", "is_input", "assert_rows", "input_tags", "n_rows")


class FibAir(Air):
    """The reference's EvalAir test statement (tests/test_evalair.py)."""

    n_cols = 2
    n_public = 3
    constraint_degree = 3

    def eval_transition(self, frame, alg):
        a, b = frame.local
        a_n, b_n = frame.next
        return [a_n - b, b_n - (a + b)]

    def eval_first(self, frame, alg):
        a, b = frame.local
        return [a - frame.public[0], b - frame.public[1]]

    def eval_last(self, frame, alg):
        _, b = frame.local
        return [b - frame.public[2]]


def _tape_fields(t) -> dict:
    out = {}
    for f in TAPE_FIELDS:
        v = getattr(t, f)
        out[f] = v.tolist() if isinstance(v, np.ndarray) else list(v) if isinstance(v, list) else v
    return out


@pytest.fixture(scope="module")
def fib():
    """(air, one-statement batch proof, replay ctx) of a 64-row Fibonacci
    statement; the port has no single-statement prove, so a batch of one
    stands in (same transcript: no seed, one statement)."""
    rows = [[1, 1]]
    for _ in range(63):
        a, b = rows[-1]
        rows.append([b, (a + b) % P])
    air = FibAir()
    proof = prove_batch([air], [GF.from_ints(np.array(rows, dtype=object).T)], [[1, 1, rows[-1][1]]], CFG)
    assert verify_batch([air], proof, CFG)
    stmt = proof.statements[0]
    ctx = replay_statement(air, stmt, CFG, Challenger(), CFG.shift)
    assert ctx is not None and ood_identity(air, stmt, ctx)
    return air, proof, ctx


def test_rec_alg_semantics():
    """Recorded tape execution computes the same ext arithmetic as the host
    algebra, MAC/CMAC fusion results included."""
    rng = random.Random(1)
    alg = ev.RecAlg()
    xs = [alg.inp((0, "pub", i)) for i in range(4)]
    y = xs[0] * xs[1] + xs[2]
    y = alg.cmul(7, y) + xs[3]
    y = y - xs[0] * xs[2]
    y = y * y
    tape = ev._optimize(alg, [(y - y).i])
    assert {ev.MAC, ev.CMAC, ev.MSUB} & set(tape.op.tolist())
    vals = [(rng.randrange(P), rng.randrange(P)) for _ in range(4)]
    out, _, _, _ = ev.execute_tape(tape, [c for v in vals for c in v])
    e = ext_add(ext_mul(vals[0], vals[1]), vals[2])
    e = ext_add(ext_mul((7, 0), e), vals[3])
    e = ext_sub(e, ext_mul(vals[0], vals[2]))
    e = ext_mul(e, e)
    assert e in {(int(out[i, 0]), int(out[i, 1])) for i in range(tape.n_ops)}


def test_fib_tape_equals_jax_and_proves_the_identity(fib):
    air, _, ctx = fib
    tape = ev.tape_for([air])
    assert tape is ev.tape_for([FibAir()])  # memoized per shape
    assert _tape_fields(tape) == _tape_fields(jev.build_tape([JFibAir()]))
    inputs = ev.assemble_inputs(tape, [ctx])
    ev.execute_tape(tape, inputs)  # raises if the identity fails
    bad = list(inputs)
    bad[0] = (bad[0] + 1) % P
    with pytest.raises(ValueError):
        ev.execute_tape(tape, bad)


def test_composite_n4_tape_equals_jax():
    """The tape of the three N=4 composite statements equals the JAX tape
    field for field."""
    port = ev.build_tape([Sha256Air(32), Ed25519Air(4), Sha512Air(2)])
    ref = jev.build_tape([JSha256Air(32), JEd25519Air(4), JSha512Air(2)])
    assert port.n_ops > 100_000
    assert _tape_fields(port) == _tape_fields(ref)


def test_evalair_columns_equal_jax(fib):
    air, _, ctx = fib
    tape = ev.tape_for([air])
    inputs = ev.assemble_inputs(tape, [ctx])
    e_air, j_air = ev.EvalAir(tape), jev.EvalAir(jev.build_tape([JFibAir()]))
    n = tape.n_rows
    trace = e_air.witness_trace(inputs, "cpu")
    jtrace = j_air.witness_trace(inputs)
    assert trace.to_ints().tolist() == np.asarray(jtrace.to_ints()).tolist()
    pcols = e_air.public_columns(inputs, n)
    jpcols = j_air.public_columns(inputs, n)
    assert [c.tolist() for c in pcols] == [np.asarray(c).tolist() for c in jpcols]
    rng = random.Random(5)
    chal = [(rng.randrange(P), rng.randrange(P)) for _ in range(2)]
    aux = e_air.aux_columns(trace, [GF2.from_ints([c0], [c1]) for c0, c1 in chal], inputs)
    jchal = [
        JGF2(JGF.from_ints(np.array([c0], dtype=object)), JGF.from_ints(np.array([c1], dtype=object)))
        for c0, c1 in chal
    ]
    jaux = j_air.aux_columns(jtrace, jchal, inputs)
    assert tuple(aux.shape) == (ev.N_AUX, n)
    assert aux.to_ints().tolist() == np.asarray(jaux.to_ints()).tolist()


def test_evalair_stark_roundtrip(fib):
    """EvalAir prove + verify over the fib statement's OOD check, and
    rejection when its publics or a committed OOD value are tampered."""
    air, _, ctx = fib
    tape = ev.tape_for([air])
    e_air = ev.EvalAir(tape)
    inputs = ev.assemble_inputs(tape, [ctx])
    assert len(inputs) == e_air.n_public
    trace = e_air.witness_trace(inputs, "cpu")
    assert int(trace.shape[1]) == tape.n_rows
    e_proof = prove_batch([e_air], [trace], [inputs], CFG)
    assert verify_batch([e_air], e_proof, CFG)

    bad = copy.deepcopy(e_proof)
    st = bad.statements[0]
    st.public_inputs = list(st.public_inputs)
    st.public_inputs[0] = (st.public_inputs[0] + 1) % P
    assert not verify_batch([e_air], bad, CFG)

    bad2 = copy.deepcopy(e_proof)
    v = bad2.statements[0].ood_trace[0][0]
    bad2.statements[0].ood_trace[0][0] = ((v[0] + 1) % P, v[1])
    assert not verify_batch([e_air], bad2, CFG)
