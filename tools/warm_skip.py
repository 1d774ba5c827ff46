"""Time the N=128 skip composite on one card for a given checkout of the port.

    python3 tools/warm_skip.py [--root DIR] [--warm 1] [--label NAME]
                               [--modes single,mesh1,...]

Imports tendermintx_tpu_torch from DIR (default: this checkout), writes a
128-validator synthetic chain as fixtures in a temporary directory, then
proves skip 1 -> 5 (cold) and skip 2 -> 6 `--warm` times at
DEFAULT_COMPOSITE_CONFIG on cuda:0, verifying each, as chip_smoke.py's
slice phase does. `--modes` replaces the warm runs by one per listed mode:
`single` proves with device="cuda", `meshK` with mesh= a K-shard lane mesh
on cuda:0 (K = 1 runs the sharded path with no communication). Prints one
JSON line: the card's name and power limit, each prove's and verify's
seconds, its peak allocated bytes and the proof's sha256. Two checkouts
are compared by running this in turns from one call (parent, change,
change, parent), two modes by alternating them in `--modes`; the script is
a measuring aid that nothing else uses.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--label", default="")
    ap.add_argument("--modes", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("warm_skip: CUDA is not available")
    from tendermintx_tpu_torch.circuits.composite import (
        DEFAULT_COMPOSITE_CONFIG,
        CompositeProof,
        prove_skip_composite,
        verify_skip_composite,
    )
    from tendermintx_tpu_torch.inputs.fetcher import InputDataFetcher, InputDataMode
    from tendermintx_tpu_torch.inputs.testchain import TestChain

    modes = args.modes.split(",") if args.modes else ["single"] * args.warm

    def prove_kwargs(mode: str) -> dict:
        if mode == "single":
            return {"device": "cuda"}
        if not mode.startswith("mesh"):
            raise SystemExit(f"warm_skip: unknown mode {mode!r}")
        from tendermintx_tpu_torch.parallel.sharding import make_lane_mesh

        k = int(mode[4:])
        return {"mesh": make_lane_mesh(k, [torch.device("cuda", 0)] * k)}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    out = {"label": args.label, "root": os.path.abspath(args.root), "card": smi, "runs": []}
    chain = TestChain(n_validators=128, chain_id="warm-skip-chain")
    for _ in range(8):
        chain.extend()
    with tempfile.TemporaryDirectory(prefix="warm_skip_") as tmp:
        chain.write_fixtures(tmp)
        fetcher = InputDataFetcher(fixture_path=tmp, mode=InputDataMode.FIXTURE)
        for (trusted_h, target_h), mode in [((1, 5), "single")] + [((2, 6), m) for m in modes]:
            trusted = chain.headers[trusted_h].hash()
            inputs = fetcher.get_skip_inputs(trusted_h, trusted, target_h, max_validators=128)
            kwargs = prove_kwargs(mode)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            proof = prove_skip_composite(
                trusted_h, trusted, target_h, inputs, DEFAULT_COMPOSITE_CONFIG, **kwargs
            )
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated()
            blob = proof.to_bytes()
            t2 = time.perf_counter()
            ok = verify_skip_composite(CompositeProof.from_bytes(blob), "warm-skip-chain", 100)
            t3 = time.perf_counter()
            if ok != (trusted_h, trusted, target_h, chain.headers[target_h].hash()):
                raise AssertionError(f"skip {trusted_h} -> {target_h} failed to verify")
            out["runs"].append({
                "skip": [trusted_h, target_h], "mode": mode, "prove_seconds": t1 - t0,
                "verify_seconds": t3 - t2, "max_memory_allocated": peak,
                "proof_sha256": hashlib.sha256(blob).hexdigest(),
            })
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
