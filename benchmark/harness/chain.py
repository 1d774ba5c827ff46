"""The fixture chain a run proves over, made from ``--seed``.

The chain is the frozen ``TestChain`` (``chaingen/testchain.py``):
real Ed25519 keys derived from the seed, bit-exact header hashing and
canonical vote sign-bytes, served in the recorded-RPC layout the port's
fixture fetcher reads. Every seed gives the same sizes (validators,
signers, heights); only keys, signing subsets and hashes change.
"""

from __future__ import annotations

import json
import math
import os
import random
from dataclasses import dataclass


FIRST = 2  # the first trusted height


@dataclass
class Request:
    index: int
    circuit: str  # "skip" | "step"
    start: int  # trusted / previous height
    target: int
    start_hash: bytes
    target_hash: bytes
    input_hex: str


def _signers(counts: random.Random, pick: random.Random, n: int, share) -> list[int] | None:
    """Who signs one height: how many comes from `counts`, which is seeded
    alike in every run, so every seed has the same sizes; which ones from
    `pick`, seeded by --seed."""
    lo, hi = share
    if lo >= 1.0:
        return None  # every validator signs
    k = min(max(math.ceil(n * counts.uniform(lo, hi)), 1), n)
    return sorted(pick.sample(range(n), k))


def build(cfg: dict, traffic: dict, seed: int, fixtures_dir: str) -> list[Request]:
    """Extend a chain far enough for the warm-up and `max_updates`
    requests, write the fixtures those requests read, and return the
    requests in order: request i proves start_i -> start_i + advance with
    start_i = 2 + advance * i (an operator catching up the head). The
    first trusted header is the chain's second: genesis has no last block
    id, which the port's header hashing and CometBFT's encode apart."""
    from chaingen.testchain import TestChain

    n = int(cfg["n_validators"])
    adv = int(traffic["advance"])
    if cfg["circuit"] == "step" and adv != 1:
        raise ValueError("a step request advances one height")
    count = int(traffic["warmup_updates"]) + int(traffic["max_updates"])
    counts = random.Random("tmx-bench-signer-counts")
    pick = random.Random(f"tmx-bench-signers/{seed}")
    chain = TestChain(
        n_validators=n,
        chain_id=cfg["chain_id"],
        powers=[int(cfg["voting_power"])] * n,
        seed=f"tmx-bench/{seed}".encode(),
    )
    share = tuple(cfg["signing_share"])
    while max(chain.headers) < FIRST + adv * count:
        chain.extend(signers=_signers(counts, pick, n, share))
    requests = []
    needed = set()
    for i in range(count):
        s, t = FIRST + adv * i, FIRST + adv * (i + 1)
        needed.update((s, t))
        sh, th = chain.headers[s].hash(), chain.headers[t].hash()
        if cfg["circuit"] == "skip":
            raw = s.to_bytes(8, "big") + sh + t.to_bytes(8, "big")
        else:
            raw = s.to_bytes(8, "big") + sh
        requests.append(Request(i, cfg["circuit"], s, t, sh, th, "0x" + raw.hex()))
    for h in sorted(needed):
        d = os.path.join(fixtures_dir, str(h))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "commit.json"), "w") as f:
            json.dump(chain.commit_rpc(h), f)
        with open(os.path.join(d, "validators_1.json"), "w") as f:
            json.dump(chain.validators_rpc(h), f)
    return requests
