"""Spans around the calls into the port's layers, for traced runs.

A metric reader names the calls it times in ``SPANS``: span name ->
``"module:attribute"`` targets (``"module:Class.method"`` for a method).
``install`` wraps each target in place; the wrapper records (name, start,
end) on the host's wall clock, in nanoseconds, which is the clock of the
profiler's trace, and synchronises the card before a span closes over card
work. Untraced runs install nothing.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import threading
import time


class SpanRecorder:
    def __init__(self, sync=None):
        self._sync = sync  # called before a span closes, or None
        self._lock = threading.Lock()
        self.records: list[tuple[str, int, int]] = []
        self._undo: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
            t1 = time.time_ns()
            with self._lock:
                self.records.append((name, t0, t1))

    def clear(self):
        with self._lock:
            self.records.clear()

    def totals(self) -> dict[str, float]:
        """Seconds by span name."""
        out: dict[str, float] = {}
        for name, t0, t1 in self.records:
            out[name] = out.get(name, 0.0) + (t1 - t0) / 1e9
        return out

    def install(self, spans: dict[str, list[str]]):
        """Wrap every target once, under its span name."""
        seen = set()
        for name, targets in spans.items():
            for target in targets:
                if target in seen:
                    continue
                seen.add(target)
                mod_name, attr = target.split(":")
                owner = importlib.import_module(mod_name)
                *path, leaf = attr.split(".")
                for p in path:
                    owner = getattr(owner, p)
                orig = getattr(owner, leaf)
                setattr(owner, leaf, self._wrap(name, orig))
                self._undo.append((owner, leaf, orig))

    def uninstall(self):
        while self._undo:
            owner, leaf, orig = self._undo.pop()
            setattr(owner, leaf, orig)

    def _wrap(self, name: str, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        return timed
