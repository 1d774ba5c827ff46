"""Poseidon-permutation AIR: prove iterated Poseidon (hash chains).

Counterpart of ``tendermintx_tpu/stark/poseidon_air.py``: the constraint
side of the permutation in ops/poseidon.py, and the smallest AIR of the
stack (12 columns), which the sharded-prove tests use.

Layout: each permutation occupies a 32-row block (30 rounds + 2 copy
rows); consecutive blocks chain (the output state of block k is the input
of block k+1) because the copy rows' transition constraints carry the
state across the block boundary. Public inputs bind the first row (chain
input) and the last row (chain output).

Periodic columns (period 32): 12 round-constant lanes and three selectors
(full round / partial round / copy). Constraint degree 8 = selector * x^7.
"""

from __future__ import annotations

import numpy as np

from ..ops import poseidon as ps
from ..ops.goldilocks import GF, P
from .air import Air, Frame

BLOCK = 32


class PoseidonChainAir(Air):
    n_cols = ps.WIDTH  # 12 state columns
    n_public = 2 * ps.WIDTH  # input state ‖ output state
    constraint_degree = 8

    def periodic_columns(self):
        rc = ps.round_constants()  # 30 x 12
        cols = [[rc[r][j] for r in range(ps.N_ROUNDS)] + [0, 0] for j in range(ps.WIDTH)]
        half = ps.FULL_ROUNDS // 2
        sel_full = [
            1 if (r < half or half + ps.PARTIAL_ROUNDS <= r < ps.N_ROUNDS) else 0
            for r in range(ps.N_ROUNDS)
        ] + [0, 0]
        sel_partial = [1 if half <= r < half + ps.PARTIAL_ROUNDS else 0 for r in range(ps.N_ROUNDS)] + [0, 0]
        sel_copy = [0] * ps.N_ROUNDS + [1, 1]
        return cols + [sel_full, sel_partial, sel_copy]

    def eval_transition(self, frame: Frame, alg):
        rc = frame.periodic[: ps.WIDTH]
        sel_full, sel_partial, sel_copy = frame.periodic[ps.WIDTH :]
        mds = ps.mds_matrix()

        # vectorised over the 12 state lanes: stacked ops and weighted sums
        s_vec = alg.stack(frame.local)  # (12, N)
        rc_vec = alg.stack(rc)

        def sbox(x):
            x2 = x * x
            x3 = x2 * x
            x4 = x2 * x2
            return x3 * x4

        pre = s_vec + rc_vec
        sb = sbox(pre)
        mixed = alg.vconcat([sb[0:1], pre[1:]])

        constraints = []
        for i in range(ps.WIDTH):
            full_i = alg.weighted_sum(sb, mds[i])
            part_i = alg.weighted_sum(mixed, mds[i])
            expr = sel_full * full_i + sel_partial * part_i + sel_copy * frame.local[i]
            constraints.append(frame.next[i] - expr)
        return constraints

    def eval_first(self, frame: Frame, alg):
        return [frame.local[i] - frame.public[i] for i in range(ps.WIDTH)]

    def eval_last(self, frame: Frame, alg):
        return [frame.local[i] - frame.public[ps.WIDTH + i] for i in range(ps.WIDTH)]


def poseidon_chain_trace(input_state: list[int], n_perms: int, device=None):
    """Host trace generation: (trace_cols GF (12, 32*n_perms) on `device`,
    public inputs: 24 ints, the chain's input and output states)."""
    if len(input_state) != ps.WIDTH:
        raise ValueError(f"a Poseidon state has {ps.WIDTH} elements")
    rows = []
    state = [v % P for v in input_state]
    rc = ps.round_constants()
    mds = ps.mds_matrix()
    half = ps.FULL_ROUNDS // 2
    for _ in range(n_perms):
        for r in range(ps.N_ROUNDS):
            rows.append(list(state))
            pre = [(state[j] + rc[r][j]) % P for j in range(ps.WIDTH)]
            if r < half or r >= half + ps.PARTIAL_ROUNDS:
                sb = [pow(x, 7, P) for x in pre]
            else:
                sb = [pow(pre[0], 7, P)] + pre[1:]
            state = [sum(mds[i][j] * sb[j] for j in range(ps.WIDTH)) % P for i in range(ps.WIDTH)]
        rows.append(list(state))  # copy row 30
        rows.append(list(state))  # copy row 31
    cols = np.array(rows, dtype=object).T  # (12, 32*n_perms)
    publics = list(input_state) + list(state)
    return GF.from_ints(cols, device), publics


def poseidon_chain_output(input_state: list[int], n_perms: int) -> list[int]:
    state = [v % P for v in input_state]
    for _ in range(n_perms):
        state = ps.permute_ints(state)
    return state
