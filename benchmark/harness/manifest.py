"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name the manifest gives it:

    configs/<config>.json   the configuration's ``file`` entry
    traffic/<traffic>.json  the parameters the chain and client read
    metrics/<metric>.py     a reader: ``read(run) -> float | None`` and,
                            optionally, ``SPANS``, the calls it times
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Manifest:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def metrics(self, kind: str, cell_name: str) -> list[dict]:
        """The `kind` ("end_to_end" or "per_layer") metrics a cell reports:
        those without a `workloads` key and those that list it."""
        return [m for m in self.data[kind] if cell_name in m.get("workloads", [cell_name])]


def load_reader(name: str):
    """metrics/<name>.py as a module."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tmx_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
