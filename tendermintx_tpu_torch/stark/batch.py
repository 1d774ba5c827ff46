"""Batch STARK: several AIR statements, ONE transcript, ONE shared FRI.

Counterpart of ``tendermintx_tpu/stark/batch.py``. Every statement's
trace/aux/quotient commitments feed a single Fiat-Shamir transcript and
each statement's DEEP codeword folds into one batch FRI, so the proof
carries one layer family, one grinding nonce and one query-index set.
Statement i with trace size n_i commits over the coset
shift^(N_max/N_i) * <w_{N_i}>, the domain the running FRI fold reaches
when it injects that statement.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from ..ops.goldilocks import GF, P
from .air import Air
from .challenger import Challenger
from .fri import FriProof, fri_prove_batch, fri_verify_batch
from .prover import StarkConfig, _prove_statement, _statement_openings
from .verifier import check_statement

log = logging.getLogger(__name__)


@dataclass
class StatementProof:
    """One statement's share of a batch proof (everything but the FRI)."""

    n_rows: int
    public_inputs: list[int]
    trace_cap: list[list[int]]
    quotient_cap: list[list[int]]
    ood_trace: list
    ood_quotient: list
    openings: dict
    aux_cap: list[list[int]] | None = None


@dataclass
class BatchStarkProof:
    statements: list[StatementProof]
    fri_proof: FriProof


def prove_batch(
    airs: list[Air],
    traces: list[GF],
    publics_list: list[list[int]],
    config: StarkConfig = StarkConfig(),
    transcript_seed: list[int] | None = None,
    *,
    mesh=None,
) -> BatchStarkProof:
    """Prove all statements with a shared transcript and one batch FRI.
    The traces' device is where the work runs, or with `mesh` (a
    parallel.sharding.LaneMesh) every statement's LDE/leaf
    hashing/quotient/DEEP and the batch FRI's large folds are sharded over
    the mesh and the rest runs on its first device; the proof bytes are
    the same."""
    if not airs or not len(airs) == len(traces) == len(publics_list):
        raise ValueError("need one trace and one publics list per AIR")
    challenger = Challenger()
    if transcript_seed:
        challenger.observe_elements(transcript_seed)

    sizes = [int(t.shape[1]) << config.rate_bits for t in traces]
    n_max = max(sizes)
    ctxs = []
    codewords = []
    for air, trace, publics, N_i in zip(airs, traces, publics_list, sizes):
        shift_i = pow(config.shift, n_max // N_i, P)
        ctx, F = _prove_statement(air, trace, publics, config, challenger, shift=shift_i, mesh=mesh)
        ctxs.append(ctx)
        codewords.append(F)

    t0 = time.perf_counter()
    fri_proof = fri_prove_batch(codewords, challenger, config.fri, config.shift, mesh=mesh)
    log.info("batch-fri[%d statements] %.2fs", len(codewords), time.perf_counter() - t0)
    del codewords

    statements = []
    for ctx, N_i in zip(ctxs, sizes):
        t0 = time.perf_counter()
        openings = _statement_openings(ctx, [q % N_i for q in fri_proof.query_indices])
        ctx.phases.append(("openings", time.perf_counter() - t0))
        log.info(
            "batch-stmt[%s n=%d N=%d cols=%d] %s total=%.2fs",
            type(ctx.air).__name__, ctx.n, ctx.N,
            ctx.air.n_cols + ctx.air.n_aux_cols,
            " ".join(f"{k}={v:.2f}" for k, v in ctx.phases),
            sum(v for _, v in ctx.phases),
        )
        statements.append(
            StatementProof(
                n_rows=ctx.n,
                public_inputs=list(ctx.public_inputs),
                trace_cap=ctx.trace_cap,
                quotient_cap=ctx.quot_cap,
                ood_trace=ctx.ood_trace,
                ood_quotient=ctx.ood_quotient,
                openings=openings,
                aux_cap=ctx.aux_cap,
            )
        )
    return BatchStarkProof(statements=statements, fri_proof=fri_proof)


def verify_batch(
    airs: list[Air],
    proof: BatchStarkProof,
    config: StarkConfig = StarkConfig(),
    transcript_seed: list[int] | None = None,
) -> bool:
    """False (never an exception) on any malformed or invalid proof."""
    try:
        return _verify_batch_inner(airs, proof, config, transcript_seed)
    except (ValueError, AssertionError, KeyError, IndexError, TypeError, OverflowError):
        return False


def _verify_batch_inner(airs, proof, config, transcript_seed) -> bool:
    if len(airs) != len(proof.statements) or not airs:
        return False
    challenger = Challenger()
    if transcript_seed:
        challenger.observe_elements(transcript_seed)
    sizes = []
    for stmt in proof.statements:
        n = stmt.n_rows
        if n < 1 or n & (n - 1):
            return False
        sizes.append(n << config.rate_bits)
    n_max = max(sizes)
    eval_fns = []
    for air, stmt, N_i in zip(airs, proof.statements, sizes):
        shift_i = pow(config.shift, n_max // N_i, P)
        eval_at = check_statement(air, stmt, config, challenger, shift_i)
        if eval_at is None:
            return False
        eval_fns.append(eval_at)
    return fri_verify_batch(
        proof.fri_proof, sizes, eval_fns, challenger, config.fri, config.shift
    )
