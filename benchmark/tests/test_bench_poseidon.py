"""The Poseidon work of an update's commitments (``harness/poseidon_work.py``),
read from the proof's wire form, against a count by hand."""

import base64

import pytest
from harness import poseidon_work

WRAP = {"rate_bits": 4, "n_queries": 21, "final_poly_len": 64, "proof_of_work_bits": 16, "cap_bits": 5}


def _felts(n: int) -> str:
    return base64.b64encode(bytes(8 * n)).decode()


def _statement(n_rows: int, trace: int, aux: int, quotient: int, opened: bool = True) -> dict:
    """A statement's wire form with the given widths; without openings, as
    a wrapped proof ships it, the widths show only in the OOD values."""
    return {
        "n_rows": n_rows,
        "aux_cap": _felts(4) if aux else None,
        "ood_trace": [_felts(2 * (trace + aux))] * 2,
        "ood_quotient": _felts(quotient),
        "openings": [[0, _felts(trace), "", _felts(aux), "", _felts(quotient), ""]] if opened else [],
    }


def _proof(rows_widths, wrapper=None, opened=True):
    batch = {"statements": [_statement(r, *w, opened=opened) for r, w in rows_widths]}
    if wrapper is not None:
        batch.update(wrapped=True, wrapper={"statements": [_statement(r, *w) for r, w in wrapper]})
    return {"batch": batch}


N4_STEP = [(4096, (170, 0, 6)), (1024, (2038, 912, 8)), (1024, (340, 0, 6))]


def test_n4_step_by_hand():
    """An N=4 step at rate 2, final poly 16: the SHA-256 plan's 64 segments
    (4,096 rows, 170 columns, quotient 6), 4 Ed25519 lanes (1,024 rows,
    2,038 trace and 912 auxiliary columns, quotient 8), 8 SHA-512 blocks
    (1,024 rows, 340 columns, quotient 6); caps of 16 digests. The same
    shapes' Poseidon calls, counted by instrumenting the port's plain
    sponge and layer on the CPU, gave the leaf counts below; an N=4 step
    proof the port made on the CPU reads the same total."""
    cfg = {"rate_bits": 2, "n_queries": 42, "final_poly_len": 16, "proof_of_work_bits": 16, "cap_bits": 4}
    launches = poseidon_work.launches(_proof(N4_STEP), cfg, WRAP)
    # leaves at rate 2: 16,384 and 4,096; ceil(width / 8) permutations a leaf
    sponge = (
        16384 * (22 + 1)  # SHA-256: 170 columns, quotient 6
        + 4096 * (255 + 114 + 1)  # Ed25519: 2,038 trace, 912 aux, quotient 8
        + 4096 * (43 + 1)  # SHA-512: 340 columns, quotient 6
    )
    assert sponge == 2_072_576
    # levels down to the cap: leaves / 2 + ... + 16 = leaves - 16
    levels = 2 * (16384 - 16) + 3 * (4096 - 16) + 2 * (4096 - 16)
    assert levels == 53_136
    # batch FRI: layers from 16,384 down to 128 (the next, 64, is 16 << 2)
    fri_layers = [16384 >> i for i in range(8)]
    fri = sum(n + (n - 16) for n in fri_layers)
    assert sum(p for p, _ in launches) == sponge + levels + fri == 2_190_864
    # one sponge launch a tree and one launch a level above the cap; one
    # permute a FRI layer
    tree_launches = 7 + 2 * 10 + 3 * 8 + 2 * 8
    assert len(launches) == tree_launches + sum(1 + n.bit_length() - 5 for n in fri_layers)


def test_without_openings_the_widths_come_summed():
    """A wrapped proof ships no openings: the trace and auxiliary widths
    come as their sum, so the count is at most one permutation a leaf
    under the two trees' own, and the trees' levels stay."""
    cfg = {"rate_bits": 2, "n_queries": 42, "final_poly_len": 16, "proof_of_work_bits": 16, "cap_bits": 4}
    opened = sum(p for p, _ in poseidon_work.launches(_proof(N4_STEP), cfg, WRAP))
    summed = sum(p for p, _ in poseidon_work.launches(_proof(N4_STEP, opened=False), cfg, WRAP))
    # ceil(2950 / 8) = 369 = 255 + 114: equal at these widths
    assert summed == opened
    wide = [(1024, (2039, 913, 8))]
    a = sum(p for p, _ in poseidon_work.launches(_proof(wide), cfg, WRAP))
    b = sum(p for p, _ in poseidon_work.launches(_proof(wide, opened=False), cfg, WRAP))
    assert 0 < a - b <= 4096


def test_n128_wrapped_skip_shapes():
    """The N=128 skip's trees and the wrap batch's, as chip_smoke.py lists
    them (MAIN_PATH_TREES): Ed25519 2,031 / 898 / 8 columns at 2^18 leaves,
    WrapAir 136 / 14 at 2^19, EvalAir 8 / 10 / 4 at 2^21."""
    base = {"rate_bits": 3, "n_queries": 28, "final_poly_len": 64, "proof_of_work_bits": 16, "cap_bits": 4}
    rows = [(65536, (170, 0, 6)), (32768, (2031, 898, 8)), (32768, (340, 0, 6))]
    composite = poseidon_work.launches(_proof(rows), base, WRAP)
    wrapper = [(1 << 15, (136, 0, 14)), (1 << 17, (8, 10, 4))]
    inner = poseidon_work.launches(_proof(rows, opened=False), base, WRAP)
    wrapped = poseidon_work.launches(_proof(rows, wrapper=wrapper, opened=False), base, WRAP)
    assert wrapped[:len(inner)] == inner
    wrap_part = wrapped[len(inner):]
    # each tree: its sponge launch, then its levels down to the cap (5 bits
    # in the wrap, 4 in the composite); trace, quotient, then auxiliary
    assert [perm for perm, _ in wrap_part[:2 * 15:15]] == [17 << 19, 2 << 19]
    assert [perm for perm, _ in wrap_part[30:30 + 2 * 17:17]] == [1 << 21, 1 << 21]
    assert [perm for perm, _ in composite[:2 * 16:16]] == [22 << 19, 1 << 19]
    # Ed25519's trace tree (254 permutations a leaf), then its quotient's
    assert [perm for perm, _ in composite[32:32 + 2 * 15:15]] == [254 << 18, 1 << 18]
    least = poseidon_work.least_seconds(composite, 132, 1980.0, 3.35e12)
    assert least == pytest.approx(124_516_335 * 6656 / (64 * 132 * 1980e6), rel=0.001)
