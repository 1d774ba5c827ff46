"""The port's STARK pipeline against the JAX package: a two-statement batch
proof (Fibonacci + Mix, the AIRs of tests/test_batch.py) must serialize
byte-identically, and each package's verifier must accept the other's
proof. Exact equality throughout: field arithmetic has no tolerance."""

import copy
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark.batch import prove_batch as j_prove_batch
from tendermintx_tpu.stark.batch import verify_batch as j_verify_batch
from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig
from tendermintx_tpu.stark.serialize import batch_proof_from_dict as j_from_dict
from tendermintx_tpu.stark.serialize import batch_proof_to_dict as j_to_dict
from tendermintx_tpu_torch.ops.goldilocks import GF, P
from tendermintx_tpu_torch.stark import prover as pr
from tendermintx_tpu_torch.stark.air import Air, public_columns_u64
from tendermintx_tpu_torch.stark.batch import prove_batch, verify_batch
from tendermintx_tpu_torch.stark.prover import StarkConfig
from tendermintx_tpu_torch.stark.serialize import batch_proof_from_dict, batch_proof_to_dict

from test_batch import MixAir as JMixAir
from test_stark import FibonacciAir as JFibonacciAir

CFG = StarkConfig(rate_bits=3, n_queries=8, final_poly_len=8)
JCFG = JStarkConfig(rate_bits=3, n_queries=8, final_poly_len=8)
SEED = [7, 9]


class FibonacciAir(Air):
    """Two columns (a, b); step (a, b) -> (b, a + b); publics [a0, b0, b_final]."""

    n_cols = 2
    n_public = 3
    constraint_degree = 3  # actual degree is 1; exercises chunk splitting

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


class MixAir(Air):
    """8 columns; next[i] = local[i]*local[(i+1)%8] + local[(i+2)%8]."""

    n_cols = 8
    n_public = 8
    constraint_degree = 2

    def eval_transition(self, frame, alg):
        loc, nxt = frame.local, frame.next
        return [nxt[i] - (loc[i] * loc[(i + 1) % 8] + loc[(i + 2) % 8]) for i in range(8)]

    def eval_first(self, frame, alg):
        return [frame.local[i] - frame.public[i] for i in range(8)]


def _statements():
    """(fib columns, fib publics, mix columns, mix publics) as ints."""
    rng = np.random.default_rng(11)
    a0, b0 = (int(v) for v in rng.integers(1, 2**62, 2))
    fib = [[a0, b0]]
    for _ in range(63):
        a, b = fib[-1]
        fib.append([b, (a + b) % P])
    mix = [[int(v) % P for v in rng.integers(0, 2**63, 8)]]
    for _ in range(255):
        r = mix[-1]
        mix.append([(r[i] * r[(i + 1) % 8] + r[(i + 2) % 8]) % P for i in range(8)])
    fib_cols = np.array(fib, dtype=object).T
    mix_cols = np.array(mix, dtype=object).T
    return fib_cols, [a0, b0, fib[-1][1]], mix_cols, list(mix[0])


@pytest.fixture(scope="module")
def proofs():
    fib_cols, fib_pub, mix_cols, mix_pub = _statements()
    port = prove_batch(
        [FibonacciAir(), MixAir()],
        [GF.from_ints(fib_cols), GF.from_ints(mix_cols)],
        [fib_pub, mix_pub], CFG, transcript_seed=SEED,
    )
    jax_proof = j_prove_batch(
        [JFibonacciAir(), JMixAir()],
        [JGF.from_ints(fib_cols), JGF.from_ints(mix_cols)],
        [fib_pub, mix_pub], JCFG, transcript_seed=SEED,
    )
    return port, jax_proof


def test_batch_proof_byte_identical_to_jax(proofs):
    port, jax_proof = proofs
    assert json.dumps(batch_proof_to_dict(port)) == json.dumps(j_to_dict(jax_proof))


def test_batch_proofs_cross_verify(proofs):
    port, jax_proof = proofs
    assert verify_batch([FibonacciAir(), MixAir()], port, CFG, transcript_seed=SEED)
    ported = batch_proof_from_dict(j_to_dict(jax_proof))
    assert verify_batch([FibonacciAir(), MixAir()], ported, CFG, transcript_seed=SEED)
    back = j_from_dict(batch_proof_to_dict(port))
    assert j_verify_batch([JFibonacciAir(), JMixAir()], back, JCFG, transcript_seed=SEED)


def test_tampered_opening_rejected(proofs):
    port, _ = proofs
    bad = copy.deepcopy(port)
    idx = next(iter(bad.statements[1].openings))
    op = list(bad.statements[1].openings[idx])
    row = list(op[0])
    row[0] = (row[0] + 1) % P
    op[0] = row
    bad.statements[1].openings[idx] = tuple(op)
    assert not verify_batch([FibonacciAir(), MixAir()], bad, CFG, transcript_seed=SEED)
    assert not verify_batch([FibonacciAir(), MixAir()], port, CFG, transcript_seed=[7, 8])


def test_blocked_quotient_and_deep_byte_identical(proofs, monkeypatch):
    """The row-blocked quotient and DEEP paths equal the one-block ones."""
    port, _ = proofs
    monkeypatch.setattr(pr, "_QUOTIENT_BLOCK_ELEMS", 64)
    monkeypatch.setattr(pr, "_DEEP_BLOCK_ELEMS", 64)
    monkeypatch.setattr(pr, "_MIN_BLOCK_ROWS", 256)
    assert pr._quotient_blocks(2, 8, 2048) > 1
    fib_cols, fib_pub, mix_cols, mix_pub = _statements()
    blocked = prove_batch(
        [FibonacciAir(), MixAir()],
        [GF.from_ints(fib_cols), GF.from_ints(mix_cols)],
        [fib_pub, mix_pub], CFG, transcript_seed=SEED,
    )
    assert json.dumps(batch_proof_to_dict(blocked)) == json.dumps(batch_proof_to_dict(port))


def test_public_columns_u64_reduces_every_form():
    """Public columns as uint64 arrays and as int lists give one canonical
    array; a column of the wrong length raises."""
    vals = [0, 1, P - 1, P, P + 5, 2**64 - 1]
    arr = public_columns_u64([np.array(vals, dtype=np.uint64), [-1, 2**70, 3, P, 7, 8]], 6)
    assert arr.tolist() == [[v % P for v in vals], [P - 1, 2**70 % P, 3, 0, 7, 8]]
    with pytest.raises(ValueError):
        public_columns_u64([np.zeros(1, dtype=np.uint64)], 6)
