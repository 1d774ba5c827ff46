"""Fiat-Shamir challenger: a duplex Poseidon sponge over Goldilocks.

Counterpart of the host ``Challenger`` in
``tendermintx_tpu/stark/challenger.py``; the transcript bytes are the same.
It runs on the host with Python ints: the transcript is sequential and
tiny, and the prover and verifier must run it identically.
"""

from __future__ import annotations

from ..ops import poseidon as ps
from ..ops.goldilocks import P


class Challenger:
    def __init__(self):
        self._state = [0] * ps.WIDTH
        self._input: list[int] = []
        self._output: list[int] = []

    # -- observation --
    def observe_element(self, x: int):
        # an explicit raise, not an assert: observed values may come from an
        # untrusted proof
        if not 0 <= x < P:
            raise ValueError(f"transcript element out of range: {x}")
        self._output.clear()
        self._input.append(x)
        if len(self._input) == ps.RATE:
            self._duplex()

    def observe_elements(self, xs):
        for x in xs:
            self.observe_element(int(x))

    def observe_ext(self, x: tuple[int, int]):
        self.observe_elements(list(x))

    def observe_digest(self, digest):
        if len(digest) != ps.DIGEST:
            raise ValueError("bad digest length")
        self.observe_elements(digest)

    def observe_cap(self, cap):
        """Absorb a Merkle cap (list of digests) in order."""
        if not cap:
            raise ValueError("empty cap")
        for digest in cap:
            self.observe_digest(digest)

    # -- sampling --
    def sample(self) -> int:
        if self._input or not self._output:
            self._duplex()
        return self._output.pop()

    def sample_ext(self) -> tuple[int, int]:
        return (self.sample(), self.sample())

    def sample_index(self, size: int) -> int:
        """Index in [0, size); size must be a power of two."""
        if size < 1 or size & (size - 1):
            raise ValueError("sample_index size must be a power of two")
        return self.sample() & (size - 1)

    def sample_indices(self, n: int, size: int) -> list[int]:
        return [self.sample_index(size) for _ in range(n)]

    # -- internals --
    def _duplex(self):
        for i, v in enumerate(self._input):
            self._state[i] = v
        self._state = ps.permute_ints(self._state)
        self._input.clear()
        self._output = list(self._state[: ps.RATE])
