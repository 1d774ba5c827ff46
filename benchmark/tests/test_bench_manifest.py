"""BENCHMARK.json against the benchmark's contract: names, units, keys and
limits, and every file the harness finds by name."""

import json
import os
import re

import pytest
from harness.manifest import BENCH_DIR, ROOT, Manifest, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
# a width may never be cut
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$|experts_per_tok)")


@pytest.fixture(scope="module")
def bench():
    return Manifest().data


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert os.path.isfile(os.path.join(ROOT, cmd[1])) and cmd[1].startswith(tuple(p + "/" for p in bench["paths"]))
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"])) and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k)
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    m = Manifest()
    for w in bench["workloads"]:
        assert set(w) == CELL_KEYS and NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        cfg = m.config(w["config"])
        traffic = m.traffic(w["traffic"])
        assert cfg["circuit"] in ("skip", "step")
        assert traffic["advance"] >= 1 and traffic["backlog"] >= 1 and traffic["max_updates"] >= 1


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(bench["per_layer"]) <= 128
    names = list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers_of = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        layers_of.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    for c in cells:
        assert len([m for m in bench["end_to_end"] if c in m.get("workloads", [c])]) >= 2
        assert any(c in m.get("workloads", [c]) for m in bench["per_layer"])


def test_every_file_is_found_by_name(bench):
    m = Manifest()
    for w in bench["workloads"]:
        assert m.config(w["config"])["name"] == w["config"]
        assert isinstance(m.traffic(w["traffic"]), dict)
    for metric in bench["per_layer"]:
        reader = load_reader(metric["name"])
        assert callable(reader.read)
        for targets in getattr(reader, "SPANS", {}).values():
            assert all(t.startswith("tendermintx_tpu_torch.") and ":" in t for t in targets)
    for name in os.listdir(os.path.join(BENCH_DIR, "metrics")):
        assert name.endswith(".py") and name[:-3] in {x["name"] for x in bench["per_layer"]}
