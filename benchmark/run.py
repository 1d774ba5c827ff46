"""Run one cell of the benchmark of the PyTorch/CUDA prover
(``tendermintx_tpu_torch``) on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from spans around the
port's layers and from torch.profiler's trace of the card. Every run
judges every answer of its window with the benchmark's own reference
(``harness/check.py`` over ``ref/``), which imports nothing of the
port. Lines before the last describe the card, the host and the heights
proved; the last line of standard output is one JSON object, and the
numbers compared, each beside its limit, are the last lines of standard
error.

``--control weak_fri`` makes the port prove and check 24 conjectured bits
below the configuration's floor, in the composite and in the wrap
(``harness.cell.weaken_fri``): the reference has to find every such
answer wrong. The benchmark's own runs never pass it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# the harness, the reference and the chain generator, then the checkout's port
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from harness.manifest import Manifest, load_reader  # noqa: E402


def _nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("weak_fri",), default=None)
    args = ap.parse_args(argv)

    # the port measured is the checkout's own, never one installed elsewhere
    if not os.path.isfile(os.path.join(os.path.dirname(BENCH_DIR), "tendermintx_tpu_torch", "__init__.py")):
        print("no tendermintx_tpu_torch beside benchmark/: run from the root of a checkout", file=sys.stderr)
        return 2
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"card: {_nvidia_smi()}", flush=True)
    print(f"host: {os.cpu_count()} cpus, python {sys.version.split()[0]}, torch {torch.__version__} "
          f"(cuda {torch.version.cuda})", flush=True)

    from harness.cell import forbidden_modules, run_cell, weaken_fri

    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    e2e = manifest.metrics("end_to_end", cell["name"])
    layer = manifest.metrics("per_layer", cell["name"])
    readers = {m["name"]: load_reader(m["name"]) for m in layer} if args.trace else {}
    if args.control == "weak_fri":
        weaken_fri()
    out = run_cell(
        cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda:0", T0, readers,
        log=lambda s: print(s, flush=True), config_check=args.control is None,
    )
    run = out["run"]
    metrics = {}
    if args.trace:
        for m in layer:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"update_s": run.update_s, "setup_s": out["setup_s"]}
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": int(cell["chips"]),
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    from harness.check import LIMITS

    result["checks"] = {k: {"value": v, "limit": LIMITS[k]} for k, v in out["counts"].items()}

    bad = forbidden_modules()
    if bad:
        print(f"loaded modules that the port must not load: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"window: {run.n_updates} updates in {run.window_s} s; setup {out['setup_s']} s", flush=True)
    print(json.dumps(result), flush=True)
    for k, v in out["counts"].items():
        print(f"check {k}: {v} (limit {LIMITS[k]})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
