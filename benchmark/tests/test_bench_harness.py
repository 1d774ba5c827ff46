"""The harness on the CPU: it refuses to run without a card, loads nothing
of JAX or the JAX package, installs its spans on the port's calls, and
reduces a device trace as it says."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
from harness import devtrace
from harness.manifest import BENCH_DIR, ROOT, Manifest, load_reader
from harness.spans import SpanRecorder

FORBIDDEN = {"jax", "jaxlib", "flax", "tendermintx_tpu"}


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show here")
    sys.path.insert(0, BENCH_DIR)
    import run

    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "celestia-step-composite", "--seed", "3000000007", "--seconds", "1"])
    assert rc != 0
    assert "{" not in out.getvalue()


def test_no_jax_after_a_rehearsal_import():
    """Import everything a run imports, in a fresh process, and compare the
    loaded modules' top-level names whole."""
    code = (
        "import sys, runpy; sys.path[:0] = [%r, %r]\n"
        "import run, harness.cell, harness.check, harness.chain, harness.devtrace, harness.poseidon_work\n"
        "from harness.manifest import Manifest, load_reader\n"
        "for m in Manifest().data['per_layer']: load_reader(m['name'])\n"
        "import ref.cometbft, ref.wire, chaingen.testchain\n"
        "import tendermintx_tpu_torch.runtime.service, tendermintx_tpu_torch.circuits.composite\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
    ) % (BENCH_DIR, ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert {"tendermintx_tpu_torch", "ref", "chaingen"} <= tops


def test_spans_resolve_on_the_port():
    targets = {}
    for m in Manifest().data["per_layer"]:
        for name, fns in getattr(load_reader(m["name"]), "SPANS", {}).items():
            targets.setdefault(name, []).extend(fns)
    rec = SpanRecorder()
    rec.install(targets)
    try:
        from tendermintx_tpu_torch.circuits import composite

        assert composite.prove_batch.__wrapped__ is not None
        with rec.span("outer"):
            pass
        assert rec.totals()["outer"] >= 0
    finally:
        rec.uninstall()
    from tendermintx_tpu_torch.circuits import composite

    assert not hasattr(composite.prove_batch, "__wrapped__")


def test_trace_summary():
    s = 1_000_000_000
    events = [("k1", 0, s), ("k2", s // 2, 2 * s), ("k1", 3 * s, 4 * s), ("outside", 9 * s, 11 * s)]
    spans = [("prover", 0, 10 * s), ("verify", 2 * s, 3 * s)]
    out = devtrace.summarize(events, spans, 0, 10 * s)
    assert out["busy_s"] == pytest.approx(4.0)  # [0, 2] + [3, 4] + [9, 10]
    assert out["window_s"] == pytest.approx(10.0)
    assert out["kernel_s"] == pytest.approx({"k1": 2.0, "k2": 1.5, "outside": 1.0})
    # idle [2, 3] under verify, [4, 9] under prover
    assert dict(out["breakdown"]["idle_gaps"]) == pytest.approx({"verify": 1.0, "prover": 5.0})
    assert out["breakdown"]["device_ops"][0] == ["k1", 2.0]


def test_idle_split_across_spans():
    """A gap that runs over several spans is split among them."""
    s = 1_000_000_000
    events = [("k", 0, s), ("k", 9 * s, 10 * s)]
    spans = [("prover", 0, 8 * s), ("wrap", s, 4 * s), ("verify", 5 * s, 7 * s)]
    out = devtrace.summarize(events, spans, 0, 10 * s)
    assert dict(out["breakdown"]["idle_gaps"]) == pytest.approx(
        {"wrap": 3.0, "prover": 2.0, "verify": 2.0, "service": 1.0}
    )


def test_readers_on_a_run():
    """Every per-layer reader on a window of 4 updates; a reader with
    nothing to read returns None, never 0."""
    from harness.cell import Run

    spans = {"prover": 80.0, "fetch": 0.2, "trace_build": 44.0, "stark_prove": 6.0, "verify": 16.0}
    trace = {"busy_s": 4.0, "window_s": 80.4, "kernel_s": {}}
    run = Run(cfg={}, n_updates=4, window_s=80.4, update_s=20.1, spans=spans, trace=trace, proofs=[], sms=132)
    got = {m["name"]: load_reader(m["name"]).read(run) for m in Manifest().data["per_layer"]}
    assert got["service_overhead_s"] == pytest.approx(0.1)
    assert got["fetch_s"] == pytest.approx(0.05)
    assert got["trace_build_s"] == pytest.approx(11.0)
    assert got["stark_prove_s"] == pytest.approx(1.5)
    assert got["verify_s"] == pytest.approx(4.0)
    assert got["poseidon_roofline"] is None  # no proofs, no kernel time
    assert got["device_idle_share"] == pytest.approx(100 * (1 - 4.0 / 80.4))
