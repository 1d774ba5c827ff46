"""The port's DeviceChallenger against the host Challenger: seeded random
sequences of observe_rows_sample / sample_many, started from fresh and
from mid-transcript host states, must sample exactly what the host
sponge samples over the same elements; an empty observation raises. The
host Challenger itself is held against the JAX package's. Exact
equality: field elements."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.stark.challenger import Challenger as JChallenger
from tendermintx_tpu_torch.ops.goldilocks import GF, P
from tendermintx_tpu_torch.stark.challenger import Challenger, DeviceChallenger

CPU = torch.device("cpu")


def _ints(t: torch.Tensor) -> list[int]:
    return [int(v) for v in t.numpy().view(np.uint64)]


def _host_at(rng, n_pre: int, sample_pre: int) -> Challenger:
    host = Challenger()
    host.observe_elements(int(v) for v in rng.integers(0, P, size=n_pre, dtype=np.uint64))
    for _ in range(sample_pre):
        host.sample()
    return host


@pytest.mark.parametrize("seed", range(8))
def test_random_sequences_match_the_host(seed):
    rng = np.random.default_rng(seed)
    # fresh, a partial input buffer, a partly drained output buffer
    host = _host_at(rng, int(rng.integers(0, 20)), int(rng.integers(0, 3)))
    dc = DeviceChallenger(host, CPU)
    for _ in range(12):
        if rng.random() < 0.65:
            k, w = int(rng.integers(1, 9)), int(rng.integers(1, 6))
            rows = rng.integers(0, P, size=(k, w), dtype=np.uint64)
            n_out = int(rng.integers(0, 11))
            got = dc.observe_rows_sample(GF.from_u64(rows), n_out)
            host.observe_elements(int(v) for v in rows.reshape(-1))
        else:
            n_out = int(rng.integers(0, 13))
            got = dc.sample_many(n_out)
        assert got.shape == (n_out,)
        assert _ints(got) == [host.sample() for _ in range(n_out)]
    # the snapshot tracks the host to the end
    assert _ints(dc.state) == host._state
    assert _ints(dc.inbuf) == host._input and _ints(dc.outbuf) == host._output


@pytest.mark.parametrize("shape", [(0, 4), (3, 0)])
def test_empty_observation_raises(shape):
    dc = DeviceChallenger(Challenger(), CPU)
    with pytest.raises(ValueError):
        dc.observe_rows_sample(GF.zeros(shape), 2)


def test_host_challenger_matches_jax():
    rng = np.random.default_rng(99)
    ours, theirs = Challenger(), JChallenger()
    for _ in range(20):
        xs = [int(v) for v in rng.integers(0, P, size=int(rng.integers(0, 19)), dtype=np.uint64)]
        ours.observe_elements(xs)
        theirs.observe_elements(xs)
        n = int(rng.integers(0, 5))
        assert [ours.sample() for _ in range(n)] == [theirs.sample() for _ in range(n)]
