"""Time the N=128 skip composite on one card for a given checkout of the port.

    python3 tools/warm_skip.py [--root DIR] [--warm 1] [--label NAME]
                               [--modes single,mesh1,...] [--wrap]

Imports tendermintx_tpu_torch from DIR (default: this checkout), writes a
128-validator synthetic chain as fixtures in a temporary directory, then
proves skip 1 -> 5 (cold) and skip 2 -> 6 `--warm` times at
DEFAULT_COMPOSITE_CONFIG on cuda:0, verifying each, as chip_smoke.py's
slice phase does. `--modes` replaces the warm runs by one per listed mode:
`single` proves with device="cuda", `meshK` with mesh= a K-shard lane mesh
on cuda:0 (K = 1 runs the sharded path with no communication). Prints one
JSON line: the card's name and power limit, each prove's and verify's
seconds, its peak allocated bytes, the proof's sha256, the
per-statement phase lines that stark/batch.py logs and, per phase, the
device peak while it ran (`phase_peaks`: the allocator's peak since the
previous phase mark of stark/prover.py; the last entry is what follows
the last statement phase: the batch FRI and the openings). Two checkouts
are compared by running this in turns from one call (parent, change,
change, parent), two modes by alternating them in `--modes`; the script is
a measuring aid that nothing else uses. `--wrap` then wraps the last
proof at default_wrap_config() on the card, the process's first wrap
(`n128_wrap_seconds`, as chip_smoke.py's wrap phase times it), and times
the wrap FRI's host fold tables cold (`wrap_fri_tables`, chip_smoke.py's
`_time_fri_tables`: the plain fold's (2x)^-1 tables and the host
constants that csrc/fri.cu's fold takes instead), then wraps the proof
once more under torch.profiler (`second_wrap_seconds`, host tables warm)
and reports chip_smoke.py's `_range_times` of the wrap's program ranges
(`ranges`: expand_perm_states and eval_aux, or in an earlier checkout
eval_terms, eval_scan and, where it still assembles the EvalAir aux rows
in torch, eval_assemble), their
card time being that of the kernels launched inside them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
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
    ap.add_argument("--wrap", action="store_true")
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
    phases: list[str] = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: phases.append(record.getMessage())
    batch_log = logging.getLogger("tendermintx_tpu_torch.stark.batch")
    batch_log.setLevel(logging.INFO)
    batch_log.addHandler(handler)
    peaks: list[list] = []

    def on_mark(record):
        peaks.append([record.getMessage(), torch.cuda.max_memory_allocated()])
        torch.cuda.reset_peak_memory_stats()

    marks = logging.Handler(logging.DEBUG)
    marks.emit = on_mark
    prover_log = logging.getLogger("tendermintx_tpu_torch.stark.prover")
    prover_log.setLevel(logging.DEBUG)
    prover_log.addHandler(marks)
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
            phases.clear()
            peaks.clear()
            t0 = time.perf_counter()
            proof = prove_skip_composite(
                trusted_h, trusted, target_h, inputs, DEFAULT_COMPOSITE_CONFIG, **kwargs
            )
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            peaks.append(["batch FRI and openings", torch.cuda.max_memory_allocated()])
            peak = max(p for _, p in peaks)
            blob = proof.to_bytes()
            t2 = time.perf_counter()
            ok = verify_skip_composite(CompositeProof.from_bytes(blob), "warm-skip-chain", 100)
            t3 = time.perf_counter()
            if ok != (trusted_h, trusted, target_h, chain.headers[target_h].hash()):
                raise AssertionError(f"skip {trusted_h} -> {target_h} failed to verify")
            out["runs"].append({
                "skip": [trusted_h, target_h], "mode": mode, "prove_seconds": t1 - t0,
                "verify_seconds": t3 - t2, "max_memory_allocated": peak,
                "proof_sha256": hashlib.sha256(blob).hexdigest(), "phases": list(phases),
                "phase_peaks": [list(p) for p in peaks],
            })
        if args.wrap:
            out["wrap"] = _first_wrap(proof)
    print(json.dumps(out), flush=True)
    return 0


def _first_wrap(proof) -> dict:
    """The process's first wrap of `proof` on the card, timed, the wrap
    FRI's host fold tables built cold, and a second wrap under
    torch.profiler with its program ranges' times."""
    import importlib.util

    import torch

    from tendermintx_tpu_torch.circuits.composite import wrap_composite
    from tendermintx_tpu_torch.stark.recursion import default_wrap_config

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapped = wrap_composite(proof, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke_tables", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = default_wrap_config()
    n = max(st.n_rows for st in wrapped.batch.wrapper.statements) << cfg.rate_bits
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = wrap_composite(proof, device="cuda")
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
    if again.to_bytes() != wrapped.to_bytes():
        raise AssertionError("two wraps of one proof differ")
    names = {e.name for e in prof.events()}
    ranges = [r for r in ("expand_perm_states", "eval_aux", "eval_terms", "eval_scan", "eval_assemble") if r in names]
    return {
        "n128_wrap_seconds": seconds,
        "wrapped_sha256": hashlib.sha256(wrapped.to_bytes()).hexdigest(),
        "wrap_fri_tables": {"domain": n, "cold_seconds": cs._time_fri_tables(n, cfg),
                            "card_host_seconds": cs._time_fri_tables(n, cfg, card=True)},
        "second_wrap_seconds": second,
        "ranges": cs._range_times(prof, ranges),
    }


if __name__ == "__main__":
    raise SystemExit(main())
