"""The comparison that decides ``correct``, shown to fail.

A whole run on the CPU at N=4 (the look for a card skipped, a 100-bit
config that a CPU proves in minutes), first sound, then with the answer
broken where the prover makes it: a prover that returns its last answer
unchanged, an altered output, a proof with a query round left out, a
proof whose validator leaf or signer lane is altered, an answer that
never comes, and the control, the port proving and checking 24 bits below
the stated floor. Each has to come out not correct. The cells have no batch
and no exchange between cards, so those faults do not apply.

On a card, ``test_control_on_card`` runs ``benchmark/run.py --control
weak_fri`` at each cell's own size.
"""

import json
import os
import subprocess
import sys
import time

import pytest
from harness.cell import run_cell, weaken_fri
from harness.manifest import ROOT, Manifest

SEED = 2**31 + 4099
CELL = "celestia-step-composite"
# 2 x 42 + 16 = 100 conjectured bits, the floor, at a CPU's size
CPU_STARK = {"rate_bits": 2, "n_queries": 42, "final_poly_len": 16}


@pytest.fixture(scope="module")
def small():
    m = Manifest()
    cell = m.cell(CELL)
    cfg = m.config(cell["config"])
    cfg.update(n_validators=4, max_validators=4)
    cfg["stark"].update(CPU_STARK)
    traffic = m.traffic(cell["traffic"])
    traffic.update(backlog=1, warmup_updates=1, max_updates=1)
    old = os.environ.get("TMX_FRI_CONFIG")
    os.environ["TMX_FRI_CONFIG"] = "{rate_bits},{n_queries},{final_poly_len},16".format(**CPU_STARK)
    yield cfg, traffic
    if old is None:
        os.environ.pop("TMX_FRI_CONFIG")
    else:
        os.environ["TMX_FRI_CONFIG"] = old


@pytest.fixture(scope="module")
def honest():
    """The port's default_prover on the CPU, each answer made once."""
    import torch
    from tendermintx_tpu_torch.runtime.service import default_prover

    made = {}

    def prove(request):
        key = request["input"]
        if key not in made:
            made[key] = default_prover(request, device=torch.device("cpu"))
        return json.loads(json.dumps(made[key]))

    return prove


def _run(small, prove, config_check=True):
    cfg, traffic = small
    return run_cell(cfg, traffic, SEED, 0.01, False, "cpu", time.perf_counter(), {},
                    log=lambda s: None, prove=prove, late_s=3600.0, config_check=config_check)


def test_sound_run_is_correct(small, honest):
    out = _run(small, honest)
    assert out["correct"], out["counts"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["counts"].values()) == {0}


def test_answer_left_unchanged(small, honest):
    """Every answer after the first is the first one again."""
    first = []

    def stale(request):
        if not first:
            first.append(honest(request))
        return first[0]

    out = _run(small, stale)
    assert not out["correct"] and out["counts"]["wrong_claims"] == 1


def test_output_altered(small, honest):
    def altered(request):
        ans = honest(request)
        ans["output"] = ans["output"][:-1] + ("0" if ans["output"][-1] != "0" else "1")
        return ans

    out = _run(small, altered)
    assert not out["correct"] and out["counts"]["wrong_claims"] == 1


def test_proof_abi_output_altered(small, honest):
    def altered(request):
        ans = honest(request)
        out = bytearray.fromhex(ans["proof"]["abi_output"])
        out[0] ^= 1
        ans["proof"]["abi_output"] = out.hex()
        return ans

    out = _run(small, altered)
    assert not out["correct"] and out["counts"]["wrong_claims"] == 1


def test_query_round_left_out(small, honest):
    def fewer(request):
        ans = honest(request)
        ans["proof"]["batch"]["fri"]["query_rounds"].pop()
        return ans

    out = _run(small, fewer)
    assert not out["correct"] and out["counts"]["weak_proofs"] == 1


def _rewrite_blob(packed: str, index: int, at: int) -> str:
    """`packed` (wire blobs) with one byte of blob `index` flipped."""
    import base64

    from ref import wire

    blobs = wire.blobs(packed)
    b = bytearray(blobs[index])
    b[at] ^= 1
    blobs[index] = bytes(b)
    return base64.b64encode(b"".join(len(x).to_bytes(2, "little") + x for x in blobs)).decode()


def test_validator_leaf_altered(small, honest):
    def altered(request):
        ans = honest(request)
        ans["proof"]["hash_data"] = _rewrite_blob(ans["proof"]["hash_data"], 1, 10)  # a key byte
        return ans

    out = _run(small, altered)
    assert not out["correct"] and out["counts"]["wrong_validators"] == 1


def test_signer_lane_altered(small, honest):
    def altered(request):
        ans = honest(request)
        ans["proof"]["signers"] = _rewrite_blob(ans["proof"]["signers"], 0, 2)  # the signature's first byte
        return ans

    out = _run(small, altered)
    assert not out["correct"] and out["counts"]["wrong_signatures"] == 1


def test_answer_never_comes(small, honest):
    calls = []

    def dropped(request):
        calls.append(request)
        if len(calls) > 1:  # the warm-up is answered
            raise RuntimeError("dropped")
        return honest(request)

    out = _run(small, dropped)
    assert not out["correct"] and out["counts"]["unanswered"] == 1 and out["failed"] == 1


def test_control_below_the_floor(small):
    from tendermintx_tpu_torch.circuits import composite

    orig = weaken_fri()
    try:
        out = _run(small, None, config_check=False)
    finally:
        composite.runtime_configs = orig
    assert out["attempted"] == 1 and out["failed"] == 0
    assert not out["correct"] and out["counts"]["weak_proofs"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in Manifest().data["workloads"]])
def test_control_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(SEED), "--seconds", "5",
         "--trace", "0", "--control", "weak_fri"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is False and result["checks"]["weak_proofs"]["value"] >= 1
