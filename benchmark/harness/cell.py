"""One run of one cell: set-up, the measured window, the reference's
judgement and the metrics.

Set-up (``setup_s``) runs from the start of the process to the first timed
submit: imports, the kernel libraries (built into the checkout's
``build/torch_kernels`` on its first run), the fixture chain, the
service's start and the warm-up updates, which are of the cell's own kind
and build the port's host tables at the cell's shapes.

The window drives ``ProverService`` in this process through
``ProverClient`` over localhost HTTP, in a closed loop: the first request
goes at once; once answers come, the client keeps up to ``backlog``
distinct requests outstanding, but sends one only while the window's mean
time an update says that it, and those before it, will be answered within
``--seconds``. It polls every ``poll_s`` and fetches every result. The
window runs from the first timed submit to the last result fetched;
``update_s`` is its length over the updates answered in it.
"""

from __future__ import annotations

import functools
import gc
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

from . import chain as chainmod
from . import check, devtrace
from .spans import SpanRecorder

FORBIDDEN = ("jax", "jaxlib", "flax", "tendermintx_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """What a per-layer metric's reader reads."""

    cfg: dict
    n_updates: int  # answered in the window
    window_s: float
    update_s: float | None
    spans: dict  # seconds by span name, summed over the window
    trace: dict | None  # devtrace.summarize, or None where nothing ran on a card
    proofs: list  # the wire forms of the answers whose FRI reads as stated
    sms: int  # the card's SM count

    def per_update(self, span: str) -> float | None:
        """Seconds in `span` over the window, a mean per answered update;
        None where the window timed none."""
        if not self.n_updates or span not in self.spans:
            return None
        return self.spans[span] / self.n_updates


def weaken_fri(bits: int = 24):
    """The control: the port's runtime configs, composite and wrap, each
    with enough queries fewer to lose `bits` conjectured bits, and the
    floor lowered to match, so the service proves, checks and answers
    below the stated security."""
    from dataclasses import replace

    from tendermintx_tpu_torch.circuits import composite

    orig = composite.runtime_configs

    def weak():
        base, wrap, floor = orig()
        weak_base, weak_wrap = (replace(c, n_queries=c.n_queries - -(-bits // c.rate_bits)) for c in (base, wrap))
        return weak_base, weak_wrap, min(c.fri.security_bits for c in (weak_base, weak_wrap))

    composite.runtime_configs = weak
    return orig


def _check_stated_configs(cfg: dict):
    """The program has to run the configuration as stated: its runtime
    configs (no TMX_* overrides) are the file's."""
    from tendermintx_tpu_torch.circuits.composite import runtime_configs

    base, wrap, floor = runtime_configs()
    for key, got in (("stark", base), ("wrap_stark", wrap)):
        for k, v in cfg[key].items():
            if getattr(got, k) != v:
                raise RuntimeError(f"the port's runtime {key}.{k} is {getattr(got, k)}, the configuration states {v}")
    if floor != cfg["min_security_bits"]:
        raise RuntimeError(f"the port's security floor is {floor}, the configuration states {cfg['min_security_bits']}")


def _drive(client, cfg, traffic, fixtures, requests, seconds: float, late_s: float, log):
    """Closed loop over `requests` in order. Returns (answers, window
    seconds, attempted, failed, end wall-clock ns)."""
    backlog, poll = int(traffic["backlog"]), float(traffic["poll_s"])
    pending: dict[str, tuple[chainmod.Request, float]] = {}
    answers = []
    failed = 0
    it = iter(requests)
    t0 = time.perf_counter()
    t_end, end_ns = t0, time.time_ns()

    def fits() -> bool:
        """Whether one more request, after those outstanding, would be
        answered within `seconds` at the window's mean time an update."""
        if not answers:
            return not pending
        mean = (t_end - t0) / len(answers)
        return time.perf_counter() - t0 + (len(pending) + 1) * mean <= seconds

    def fill():
        while len(pending) < backlog and fits():
            req = next(it, None)
            if req is None:
                return
            rid = client.submit(
                req.circuit, cfg["chain_id"], req.input_hex,
                max_validators=int(cfg["max_validators"]), fixture_path=fixtures, wrap=bool(traffic["wrap"]),
            )
            pending[rid] = (req, time.perf_counter())

    fill()
    attempted = len(pending)
    while pending:
        time.sleep(poll)
        for rid, (req, sent) in list(pending.items()):
            st = client.status(rid)
            if st["state"] == "done":
                answers.append((req, client.result(rid)))
                now = time.perf_counter()
                log(f"update {req.start}->{req.target}: answered at {now - t0:.3f} s, {now - sent:.3f} s after its submit")
            elif st["state"] == "failed":
                log(f"request {req.index} ({req.start}->{req.target}) failed: {st.get('error')}")
                answers.append((req, None))
                failed += 1
            else:
                continue
            del pending[rid]
            t_end, end_ns = time.perf_counter(), time.time_ns()
        n = len(pending)
        fill()
        attempted += len(pending) - n
        if pending and time.perf_counter() - t0 > seconds + late_s:
            for req, _ in pending.values():
                log(f"request {req.index} ({req.start}->{req.target}) never came")
                answers.append((req, None))
                failed += 1
            break
    return answers, t_end - t0, attempted, failed, end_ns


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
             t0: float, readers: dict, log=print, prove=None, late_s: float = 150.0,
             config_check=True) -> dict:
    """Run one cell; returns the fields of the result line (without
    ``device``) and the readings the caller prints. `readers` maps a
    per-layer metric's name to its module (traced runs). `prove`
    (request -> answer) stands in for the port's ``default_prover`` on
    `device` where a test plants a fault; `late_s` is how long past the
    window's close an answer may still come."""
    import torch

    from tendermintx_tpu_torch.runtime.service import ProverClient, ProverService, default_prover

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if config_check:
        _check_stated_configs(cfg)
    tmp = tempfile.mkdtemp(prefix="tmx_bench_", dir=tempfile.gettempdir())
    fixtures = os.path.join(tmp, "fixtures")
    try:
        requests = chainmod.build(cfg, traffic, seed, fixtures)
        n_warm = int(traffic["warmup_updates"])
        spans = SpanRecorder(torch.cuda.synchronize if (trace and on_card) else None)
        prove = prove or functools.partial(default_prover, device=torch.device(device))

        def prover(request):
            with spans.span("prover"):
                return prove(request)

        svc = ProverService(port=0, prover=prover, allowed_fixture_roots=[tmp], device=device)
        svc.start()
        dtrace = None
        try:
            client = ProverClient(svc.url)
            _, _, _, warm_failed, _ = _drive(
                client, cfg, traffic, fixtures, requests[:n_warm], float("inf"), late_s, log,
            )
            if warm_failed:
                raise RuntimeError("a warm-up update failed")
            if trace:
                targets: dict[str, list[str]] = {}
                for mod in readers.values():
                    for name, fns in getattr(mod, "SPANS", {}).items():
                        targets.setdefault(name, []).extend(fns)
                spans.install(targets)
                if on_card:
                    dtrace = devtrace.DeviceTrace()
                    dtrace.start()
            spans.clear()
            setup_s = time.perf_counter() - t0
            start_ns = time.time_ns()
            answers, window_s, attempted, failed, end_ns = _drive(
                client, cfg, traffic, fixtures, requests[n_warm:], seconds, late_s, log,
            )
            events = dtrace.stop() if dtrace else None
            spans.uninstall()
        finally:
            svc.stop()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        del svc, dtrace
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        answered = [a for a in answers if a[1] is not None]
        log("heights proved: " + " ".join(f"{r.start}->{r.target}" for r, _ in answers))
        counts, proofs = check.judge(cfg, bool(traffic["wrap"]), fixtures, answers)
        update_s = window_s / len(answered) if answered else None
        summary = None
        if events is not None:
            summary = devtrace.summarize(events, spans.records, start_ns, end_ns)
            out_dir = os.path.join(tempfile.gettempdir(), f"tmx_bench_trace_{seed}")
            devtrace.write_records(out_dir, spans.records, summary)
            log(f"trace records: {out_dir}")
        run = Run(
            cfg=cfg, n_updates=len(answered), window_s=window_s, update_s=update_s,
            spans=spans.totals(), trace=summary, proofs=proofs,
            sms=torch.cuda.get_device_properties(0).multi_processor_count if on_card else 0,
        )
        return {
            "correct": check.correct(counts, attempted),
            "attempted": attempted,
            "failed": failed,
            "setup_s": setup_s,
            "run": run,
            "counts": counts,
            "memory_peak_bytes": peak,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
