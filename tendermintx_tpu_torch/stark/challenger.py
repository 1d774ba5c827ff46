"""Fiat-Shamir challenger: a duplex Poseidon sponge over Goldilocks.

Counterpart of ``tendermintx_tpu/stark/challenger.py``; the transcript
bytes are the same. ``Challenger`` runs on the host with Python ints: the
transcript is sequential and tiny, and the prover and verifier must run it
identically.

``DeviceChallenger`` is the counterpart of the reference's device-resident
transcript: a mirror of a host challenger that absorbs Merkle caps and
samples challenges as device scalars, without a host fetch. Its sponge goes
through ``ops/poseidon.permute_tensor`` (the kernel on a CUDA tensor). The
prover and FRI keep the host challenger: on one H100, wired into their
commit loops (with a host replay that cross-checked it), it gave no
end-to-end gain on the N=128 skip prove (PERF.md, Findings), so nothing in
the package calls it yet; a caller that does must replay the host
challenger over the fetched caps, which stays authoritative.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import poseidon as ps
from ..ops.goldilocks import P, tensor_from_u64


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


class DeviceChallenger:
    """A device snapshot of a host ``Challenger``: the sponge state (12,)
    and the input and output buffers as int64 tensors on `device`. Every
    value it samples is returned as a device tensor, without a host
    fetch; the host challenger is not advanced."""

    def __init__(self, host: Challenger, device):
        def dev(vals):
            return tensor_from_u64(np.array(vals, dtype=np.uint64).reshape(-1), device)

        self.state = dev(host._state)
        self.inbuf = dev(host._input)
        self.outbuf = dev(host._output)

    def _permute(self, head: torch.Tensor):
        """Overwrite the leading lanes with `head` and permute."""
        st = torch.cat([head, self.state[int(head.shape[0]) :]])
        self.state = ps.permute_tensor(st[None].contiguous())[0]

    def observe_rows_sample(self, rows, n_out: int) -> torch.Tensor:
        """Absorb a device (k, w) field matrix row-major (a Merkle cap: k
        digests of w elements), as the host's observe_element would one
        by one, then sample n_out elements: a (n_out,) device tensor."""
        v = rows.v
        if v.numel() == 0:
            # an explicit check, not an assert: it must hold under -O
            raise ValueError(f"observe_rows_sample needs k*w > 0, got shape {tuple(v.shape)}")
        buf = torch.cat([self.inbuf, v.reshape(-1).to(self.state.device)])
        full = int(buf.shape[0]) // ps.RATE * ps.RATE
        for i in range(0, full, ps.RATE):
            self._permute(buf[i : i + ps.RATE])
        self.inbuf = buf[full:]
        # the last observe either ended in a duplex (output = rate lanes)
        # or cleared the output
        self.outbuf = self.state[: ps.RATE] if full == int(buf.shape[0]) else buf[:0]
        return self.sample_many(n_out)

    def sample_many(self, n_out: int) -> torch.Tensor:
        """n_out samples as the host's sample() would draw them."""
        vals = []
        for _ in range(n_out):
            if int(self.inbuf.shape[0]) or not int(self.outbuf.shape[0]):
                self._permute(self.inbuf)
                self.inbuf = self.inbuf[:0]
                self.outbuf = self.state[: ps.RATE]
            vals.append(self.outbuf[-1:])
            self.outbuf = self.outbuf[:-1]
        return torch.cat(vals) if vals else self.state[:0]
