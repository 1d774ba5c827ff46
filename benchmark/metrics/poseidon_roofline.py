"""poseidon_roofline: the least time of the Poseidon permutations
the window's Merkle commitments need (``harness/poseidon_work.py``: counted
from each answered proof's statement shapes and the stated configs, at
6,656 integer multiply-adds a permutation, 64 a clock an SM, the card's SM
count and the published 1,980 MHz boost clock, or bytes at 3.35 TB/s) over
the device time of the kernels that run them (``csrc/poseidon.cu``'s
commit entries: permute, sponge_cols, merkle_layer; not expand or grind),
in the traced window."""

import harness.peaks as peaks
from harness import poseidon_work


def read(run):
    if run.trace is None or not run.proofs:
        return None
    kernel_s = sum(s for n, s in run.trace["kernel_s"].items() if n.startswith(poseidon_work.KERNELS))
    if kernel_s <= 0:
        return None
    base, wrap = run.cfg["stark"], run.cfg["wrap_stark"]
    least = sum(
        poseidon_work.least_seconds(poseidon_work.launches(p, base, wrap), run.sms, peaks.SM_CLOCK_MHZ,
                                    peaks.HBM_BYTES_PER_S)
        for p in run.proofs
    )
    return 100.0 * least / kernel_s
