"""STARK verifier (host-side, Python ints).

Counterpart of ``tendermintx_tpu/stark/verifier.py``: ``verify`` checks a
single-statement proof (stark/prover.py::prove); ``check_statement`` /
``replay_statement`` / ``ood_identity`` replay one statement's transcript
exactly as the prover ran it and check the OOD composition identity
natively, for ``verify`` and for the batch verifier.
"""

from __future__ import annotations

import numpy as np

from ..ops import ntt as nttmod
from ..ops.ext import ext_add, ext_inv, ext_mul, ext_pow, ext_sub
from ..ops.goldilocks import P
from ..ops.merkle import cap_levels, verify_opening
from .air import Air, Frame, HostAlgebra, HostFelt, flatten_host_constraints, public_columns_u64
from .challenger import Challenger
from .fri import fri_verify
from .prover import StarkConfig, StarkProof


def verify(
    air: Air,
    proof: StarkProof,
    config: StarkConfig = StarkConfig(),
    transcript_seed: list[int] | None = None,
) -> bool:
    """False (never an exception) on any malformed or invalid proof."""
    try:
        return _verify_inner(air, proof, config, transcript_seed)
    except (ValueError, AssertionError, KeyError, IndexError, TypeError, OverflowError):
        return False


def _verify_inner(air: Air, proof: StarkProof, config: StarkConfig, transcript_seed) -> bool:
    challenger = Challenger()
    if transcript_seed:
        challenger.observe_elements(transcript_seed)
    eval_at = check_statement(air, proof, config, challenger, config.shift)
    if eval_at is None:
        return False
    n = proof.n_rows
    return fri_verify(
        proof.fri_proof,
        degree_bound=n,
        n=n << config.rate_bits,
        challenger=challenger,
        config=config.fri,
        shift=config.shift,
        layer0_check=lambda idx, val: eval_at(idx) == tuple(val),
    )


def check_statement(air: Air, proof, config: StarkConfig, challenger: Challenger, shift: int):
    """Replay one statement's transcript and check its OOD identity.
    Returns the replay's `eval_at` (the DEEP layer-0 recomputation hook
    FRI uses) or None."""
    ctx = replay_statement(air, proof, config, challenger, shift)
    if ctx is None or not ood_identity(air, proof, ctx):
        return None
    return ctx.eval_at


class ReplayCtx:
    """Everything the transcript replay of one statement establishes."""

    __slots__ = (
        "eval_at", "alpha", "beta", "z", "g0s", "challenge_components",
        "ood_trace", "ood_quotient", "public_inputs", "periodic_at_z",
        "public_cols_at_z", "zinvs", "z_pows_n", "n_rows",
    )


def replay_statement(air: Air, proof, config: StarkConfig, challenger: Challenger, shift: int):
    """Structural checks + Fiat-Shamir replay for one statement against a
    caller-owned challenger. Returns a ReplayCtx or None on malformed
    input; does not evaluate the constraint system."""
    n = proof.n_rows
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        return None
    rate_bits = config.rate_bits
    N = n << rate_bits
    n_cols = air.n_cols
    n_aux = air.n_aux_cols
    n_total = n_cols + n_aux
    n_chunks = air.constraint_degree - 1
    offsets = list(air.frame_offsets)

    if len(proof.ood_trace) != len(offsets):
        return None
    if any(len(per) != n_total for per in proof.ood_trace):
        return None
    if len(proof.ood_quotient) != n_chunks:
        return None
    if len(proof.public_inputs) != air.n_public:
        return None
    if not air.validate_publics(list(proof.public_inputs)):
        return None
    if (proof.aux_cap is None) != (n_aux == 0):
        return None
    cap_len = 1 << min(config.cap_bits, max(N.bit_length() - 1, 0))
    opening_levels = cap_levels(N, config.cap_bits)
    for cap in (proof.trace_cap, proof.quotient_cap) + ((proof.aux_cap,) if n_aux else ()):
        if len(cap) != cap_len or any(len(d) != 4 for d in cap):
            return None

    # --- transcript replay ---
    challenger.observe_elements(proof.public_inputs)
    challenger.observe_cap(proof.trace_cap)
    challenges = [challenger.sample_ext() for _ in range(air.n_challenges)]
    if n_aux:
        challenger.observe_cap(proof.aux_cap)
    alpha = challenger.sample_ext()
    challenger.observe_cap(proof.quotient_cap)
    z = challenger.sample_ext()
    for per_offset in proof.ood_trace:
        for v in per_offset:
            challenger.observe_ext(tuple(v))
    for v in proof.ood_quotient:
        challenger.observe_ext(tuple(v))
    beta = challenger.sample_ext()

    g_trace = nttmod.primitive_root_of_unity(log_n)
    g_last = pow(g_trace, n - 1, P)

    from .prover import periodic_interpolant

    periodic_at_z = []
    for pattern in air.periodic_columns():
        p_len = len(pattern)
        if p_len == 0 or p_len & (p_len - 1) or n % p_len:
            return None
        coeffs = periodic_interpolant(tuple(pattern))
        z_pow = ext_pow(z, n // p_len)
        acc = (0, 0)
        for c in reversed(coeffs):
            acc = ext_add(ext_mul(acc, z_pow), (c % P, 0))
        periodic_at_z.append(acc)

    pub_cols = air.public_columns(list(proof.public_inputs), n)
    if any(len(col) != n for col in pub_cols):
        return None
    if len(pub_cols) * n > (1 << 14):
        public_cols_at_z = _public_cols_at_z_batched(pub_cols, z, n)
    else:
        public_cols_at_z = []
        for col in pub_cols:
            coeffs = periodic_interpolant(tuple(int(v) % P for v in col))
            acc = (0, 0)
            for c in reversed(coeffs):
                acc = ext_add(ext_mul(acc, z), (c % P, 0))
            public_cols_at_z.append(acc)

    z_pow_n = ext_pow(z, n)
    zh = ext_sub(z_pow_n, (1, 0))
    zh_inv = ext_inv(zh)
    zinv_transition = ext_mul(ext_sub(z, (g_last, 0)), zh_inv)
    zinv_first = ext_inv(ext_sub(z, (1, 0)))
    zinv_last = ext_inv(ext_sub(z, (g_last, 0)))

    ctx = ReplayCtx()
    ctx.n_rows = n
    ctx.alpha = alpha
    ctx.beta = beta
    ctx.z = z
    ctx.challenge_components = [c % P for ch in challenges for c in ch]
    ctx.ood_trace = [[tuple(v) for v in per] for per in proof.ood_trace]
    ctx.ood_quotient = [tuple(v) for v in proof.ood_quotient]
    ctx.public_inputs = [int(v) % P for v in proof.public_inputs]
    ctx.periodic_at_z = periodic_at_z
    ctx.public_cols_at_z = public_cols_at_z
    # zerofier-inverse order matches the constraint-group order
    ctx.zinvs = (zinv_first, zinv_transition, zh_inv, zinv_last)
    ctx.z_pows_n = [ext_pow(z, n * j) for j in range(n_chunks)]

    # --- DEEP layer-0 recomputation hook for FRI ---
    from .prover import _beta_powers, deep_power_layout

    bases, chunk_base, pos = deep_power_layout(n_cols, n_aux, n_chunks, len(offsets))
    pows = _beta_powers(beta, max(bases) + chunk_base + n_chunks + 1)
    group_info = []  # (z_k, [(beta_pow, kind, index)], G0)
    for gi, k in enumerate(offsets):
        zk = ext_mul(z, (pow(g_trace, k, P), 0))
        terms = []
        G0 = (0, 0)
        for i in range(n_total):
            b_pow = pows[bases[gi] + pos[i]]
            terms.append((b_pow, "trace", i))
            G0 = ext_add(G0, ext_mul(b_pow, tuple(proof.ood_trace[gi][i])))
        if gi == 0:
            for j in range(n_chunks):
                b_pow = pows[chunk_base + j]
                terms.append((b_pow, "quot", j))
                G0 = ext_add(G0, ext_mul(b_pow, tuple(proof.ood_quotient[j])))
        group_info.append((zk, terms, G0))

    w_N = nttmod.primitive_root_of_unity(log_n + rate_bits)

    def eval_at(idx: int):
        opening = proof.openings.get(idx)
        if opening is None or len(opening) != 6:
            return None
        trace_row, trace_path, aux_row, aux_path, quot_row, quot_path = opening
        if len(trace_row) != n_cols or len(quot_row) != 2 * n_chunks:
            return None
        if len(aux_row) != n_aux:
            return None
        if not verify_opening(proof.trace_cap, idx, list(trace_row), trace_path, opening_levels):
            return None
        if n_aux and not verify_opening(proof.aux_cap, idx, list(aux_row), aux_path, opening_levels):
            return None
        if not verify_opening(proof.quotient_cap, idx, list(quot_row), quot_path, opening_levels):
            return None
        combined_row = list(trace_row) + list(aux_row)
        x = shift * pow(w_N, idx, P) % P
        total = (0, 0)
        for zk, terms, G0 in group_info:
            G = (0, 0)
            for b, kind, i in terms:
                if kind == "trace":
                    v = (combined_row[i] % P, 0)
                else:
                    v = (quot_row[2 * i] % P, quot_row[2 * i + 1] % P)
                G = ext_add(G, ext_mul(b, v))
            term = ext_mul(ext_sub(G, G0), ext_inv(ext_sub((x, 0), zk)))
            total = ext_add(total, term)
        return total

    ctx.g0s = [gi[2] for gi in group_info]
    ctx.eval_at = eval_at
    return ctx


def ood_identity(air: Air, proof, ctx: ReplayCtx) -> bool:
    """Run the full constraint system at z (host ints) and compare the
    alpha-weighted combination against the shipped quotient values."""
    frame = Frame(
        rows=[[HostFelt(v) for v in per] for per in ctx.ood_trace],
        public=[HostFelt((v, 0)) for v in ctx.public_inputs],
        periodic=[HostFelt(v) for v in ctx.periodic_at_z],
        public_cols=[HostFelt(v) for v in ctx.public_cols_at_z],
        challenges=[HostFelt((c, 0)) for c in ctx.challenge_components],
    )
    alg = HostAlgebra()
    groups = [
        (air.eval_first(frame, alg), ctx.zinvs[0]),
        (air.eval_transition(frame, alg), ctx.zinvs[1]),
        (air.eval_cyclic(frame, alg), ctx.zinvs[2]),
        (air.eval_last(frame, alg), ctx.zinvs[3]),
    ]
    lhs = (0, 0)
    a_pow = (1, 0)
    for constraints, zi in groups:
        for c in flatten_host_constraints(constraints):
            lhs = ext_add(lhs, ext_mul(a_pow, ext_mul(c.v, zi)))
            a_pow = ext_mul(a_pow, ctx.alpha)
    rhs = (0, 0)
    for j, oq in enumerate(ctx.ood_quotient):
        rhs = ext_add(rhs, ext_mul(ctx.z_pows_n[j], oq))
    return lhs == rhs


def _public_cols_at_z_batched(pub_cols, z, n: int):
    """Evaluate many public columns at z with one batched subgroup iNTT on
    CPU tensors (verification is host logic) and a z-power dot product."""
    from ..ops.goldilocks import GF, tensor_from_u64
    from .prover import coset_intt, ood_values

    arr = public_columns_u64(pub_cols, n)
    coeffs = coset_intt(GF(tensor_from_u64(arr, "cpu")), 1)
    return ood_values(coeffs, [z])[0]
