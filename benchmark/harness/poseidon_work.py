"""The least work of an update's Merkle commitments, and its least time on
one H100.

The arithmetic is a frozen copy of ``chip_smoke.py`` at commit a7cc570
(``MULS_PER_PERMUTATION``, ``_bound``): a Poseidon permutation costs at
least 6,656 32-bit integer multiply-adds in plonky2's sparse
partial-round form, at 64 a clock per SM; bytes move at most at 3.35 TB/s;
a launch takes at least the longer of the two.

The count follows the proof's statement shapes, read from its wire form
(``ref/wire.py``), and the stated configs, as the prover commits them
(``stark/prover.py``, ``stark/fri.py``, ``ops/merkle.py`` at the same
commit):

- each statement's trace, auxiliary and quotient matrices (2 columns a
  quotient chunk) at ``n_rows << rate_bits`` leaves: one column-sponge
  launch of ``leaves * ceil(width / 8)`` permutations, then one
  ``merkle_layer`` launch per level down to the cap of ``2^cap_bits``
  digests (``leaves / 2``, ``leaves / 4``, ..., ``2^cap_bits``
  permutations; the prover also builds the few levels above the cap,
  which a commitment does not need);
- each committed FRI layer of the batch: one ``permute`` launch hashing
  its (n, 2) rows (one permutation a leaf), then its levels;
- for a wrapped proof, both (composite and wrap batch).
"""

from __future__ import annotations

from ref import wire

FULL_ROUND_MULS = 12 * 4 * 4 + 144 * 2
MULS_PER_PERMUTATION = 8 * FULL_ROUND_MULS + 11 * 11 * 4 + 22 * (4 * 4 + 11 * 4 + 2 + 11 * 4)  # 6,656
MULS_PER_CLOCK_PER_SM = 64
RATE = 8
WIDTH = 12
DIGEST = 4
# the kernels named by these prefixes run the commitments' permutations
KERNELS = ("tmx_poseidon_permute", "tmx_poseidon_sponge_cols", "tmx_poseidon_merkle_layer")


def _tree_levels(leaves: int, cap_bits: int) -> list[tuple[int, int]]:
    """(permutations, bytes) of each merkle_layer launch from `leaves` down
    to the cap."""
    out = []
    n = leaves
    while n > 1 << cap_bits:
        out.append((n // 2, n * DIGEST * 8 + (n // 2) * DIGEST * 8))
        n //= 2
    return out


def _statement_launches(st: dict, cfg: dict) -> list[tuple[int, int]]:
    leaves = int(st["n_rows"]) << cfg["rate_bits"]
    trace, aux, quotient = wire.statement_widths(st)
    trees = [trace, quotient]
    if st.get("aux_cap") is not None:
        # without openings the widths come as one sum (wire.statement_widths):
        # the trace's sponge launch counts both, the auxiliary tree its levels
        trees.append(aux)
    out = []
    for w in trees:
        if w:
            out.append((leaves * -(-w // RATE), w * leaves * 8 + leaves * DIGEST * 8))
        out += _tree_levels(leaves, cfg["cap_bits"])
    return out


def _batch_launches(statements: list[dict], cfg: dict) -> list[tuple[int, int]]:
    out = []
    for st in statements:
        out += _statement_launches(st, cfg)
    for n in wire.fri_layers([int(st["n_rows"]) << cfg["rate_bits"] for st in statements], cfg):
        out.append((n, 2 * n * WIDTH * 8))
        out += _tree_levels(n, cfg["cap_bits"])
    return out


def launches(proof: dict, base_cfg: dict, wrap_cfg: dict) -> list[tuple[int, int]]:
    """(permutations, bytes) of every commitment launch an update proving
    `proof` (its wire form) made."""
    out = _batch_launches(proof["batch"]["statements"], base_cfg)
    if wire.is_wrapped(proof):
        out += _batch_launches(proof["batch"]["wrapper"]["statements"], wrap_cfg)
    return out


def least_seconds(launch_list, sms: int, clock_mhz: float, hbm_bytes_per_s: float) -> float:
    """Sum over launches of the longer of its operations and its bytes."""
    ops_per_s = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
    return sum(max(p * MULS_PER_PERMUTATION / ops_per_s, b / hbm_bytes_per_s) for p, b in launch_list)
