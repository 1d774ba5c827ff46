"""The card's activity over the window, from torch.profiler with CUDA
activity only (CUPTI): every kernel, copy and fill the card ran, with its
start and length on the host's wall clock.

``summarize`` reduces the events to what the readers and the result line
need: the union of device activity inside the window (``busy_s``), the
window's length (``window_s``), device seconds by kernel name, and the
idle time by the innermost host span open over each piece of it.
"""

from __future__ import annotations

import json
import os
import time


class DeviceTrace:
    def __init__(self):
        import torch

        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._started_ns = 0

    def start(self):
        self._started_ns = time.time_ns()
        self._prof.start()

    def stop(self) -> list[tuple[str, int, int]]:
        """Stop tracing; the device events as (name, start ns, end ns)."""
        import torch

        self._prof.stop()
        results = self._prof.profiler.kineto_results
        # kineto stamps events on the host's wall clock; where a build uses
        # another clock, move its events by the offset between the trace's
        # start and ours
        offset = results.trace_start_ns() - self._started_ns
        if abs(offset) < 5_000_000_000:
            offset = 0
        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in results.events():
            if e.device_type() == cuda:
                t0 = e.start_ns() - offset
                out.append((e.name(), t0, t0 + e.duration_ns()))
        return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_segments(spans: list[tuple[str, int, int]]) -> list[tuple[int, int, str]]:
    """The host's time cut at every span boundary, each piece named by the
    innermost (latest started) span open over it; "service" where none is."""
    points = sorted({t for _, a, b in spans for t in (a, b)})
    edges = [-(1 << 62)] + points + [1 << 62]
    out = []
    for a, b in zip(edges, edges[1:]):
        mid = a // 2 + b // 2
        best = None
        for name, s0, s1 in spans:
            if s0 <= mid < s1 and (best is None or s0 > best[1]):
                best = (name, s0)
        out.append((a, b, best[0] if best else "service"))
    return out


def summarize(events, spans, t_start_ns: int, t_end_ns: int) -> dict:
    """busy_s, window_s, kernel_s (device seconds by name inside the
    window) and the breakdown's top ten device ops and idle time by host
    span."""
    clipped = [(n, max(a, t_start_ns), min(b, t_end_ns)) for n, a, b in events]
    clipped = [(n, a, b) for n, a, b in clipped if b > a]
    kernel_s: dict[str, float] = {}
    for n, a, b in clipped:
        kernel_s[n] = kernel_s.get(n, 0.0) + (b - a) / 1e9
    busy = _union([(a, b) for _, a, b in clipped])
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps, prev = [], t_start_ns
    for a, b in busy + [(t_end_ns, t_end_ns)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle_by_span: dict[str, float] = {}
    segments = _host_segments(spans)
    k = 0
    for a, b in gaps:  # both in time order
        while segments[k][1] <= a:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < b:
            s0, s1, name = segments[j]
            idle_by_span[name] = idle_by_span.get(name, 0.0) + (min(b, s1) - max(a, s0)) / 1e9
            j += 1
    top_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": (t_end_ns - t_start_ns) / 1e9,
        "kernel_s": kernel_s,
        "n_events": len(clipped),
        "breakdown": {
            "device_ops": [[n, s] for n, s in top_ops],
            "idle_gaps": [[n, s] for n, s in top_idle],
        },
    }


def write_records(out_dir: str, spans, summary: dict):
    """The span records and the kernel sums, for a reader of the run."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "spans.jsonl"), "w") as f:
        for name, a, b in spans:
            f.write(json.dumps({"name": name, "start_ns": a, "end_ns": b}) + "\n")
    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump({k: summary[k] for k in ("busy_s", "window_s", "kernel_s", "n_events")}, f, indent=1)
