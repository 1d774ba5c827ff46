"""The port stands alone: every module of tendermintx_tpu_torch, and
chip_smoke.py, must import and run in a process where neither `jax` nor the
JAX package `tendermintx_tpu` can be imported."""

import os
import pkgutil
import shutil
import subprocess
import sys

import tendermintx_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = "import sys\nsys.modules['jax'] = None\nsys.modules['tendermintx_tpu'] = None\n"
CHECK = (
    "assert not any(k.split('.')[0] in ('jax', 'tendermintx_tpu')\n"
    "               for k, v in sys.modules.items() if v is not None)\n"
)


def _modules() -> list[str]:
    return sorted(
        m.name
        for m in pkgutil.walk_packages(tendermintx_tpu_torch.__path__, "tendermintx_tpu_torch.")
    )


def _run(code: str, cwd: str = ROOT, argv=None) -> subprocess.CompletedProcess:
    cmd = [sys.executable, *(argv or ["-c", code])]
    return subprocess.run(
        cmd, cwd=cwd, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT if cwd == ROOT else "", "CUDA_VISIBLE_DEVICES": ""},
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "tendermintx_tpu_torch.circuits.composite" in mods
    assert "tendermintx_tpu_torch.inputs.testchain" in mods
    for m in ("runtime.cli", "runtime.service", "runtime.operator", "circuits.verify", "ops.ed25519",
              "parallel.sharding", "parallel.prover", "stark.poseidon_air", "graft_entry"):
        assert f"tendermintx_tpu_torch.{m}" in mods
    code = BLOCK + (
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
    ) + CHECK + "print('ok', len(sys.modules))\n"
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_mesh_prove_without_jax():
    """A sharded prove over a CPU lane mesh, and its verification, run with
    jax and the JAX package blocked."""
    code = BLOCK + (
        "import torch\n"
        "from tendermintx_tpu_torch.parallel.sharding import make_lane_mesh\n"
        "from tendermintx_tpu_torch.stark.poseidon_air import PoseidonChainAir, poseidon_chain_trace\n"
        "from tendermintx_tpu_torch.stark.prover import StarkConfig, prove\n"
        "from tendermintx_tpu_torch.stark.verifier import verify\n"
        "cfg = StarkConfig(rate_bits=3, n_queries=4, final_poly_len=8, proof_of_work_bits=2)\n"
        "trace, publics = poseidon_chain_trace(list(range(12)), 2)\n"
        "mesh = make_lane_mesh(4, [torch.device('cpu')] * 4)\n"
        "assert verify(PoseidonChainAir(), prove(PoseidonChainAir(), trace, publics, cfg, mesh=mesh), cfg)\n"
    ) + CHECK + "print('ok')\n"
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_inputs_without_jax(tmp_path):
    """chip_smoke.py's host side (its imports and the skip inputs it
    proves) runs with jax and the JAX package blocked."""
    code = BLOCK + (
        "import chip_smoke\n"
        f"sc = chip_smoke.SkipChain(4, {str(tmp_path)!r})\n"
        "trusted, target, inputs = sc.skip(2, 6)\n"
        "assert inputs.nb_target_validators == 4 and len(trusted) == len(target) == 32\n"
    ) + CHECK + "print('ok')\n"
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without CUDA, and in a directory holding only the script, the smoke
    run exits non-zero and prints no result line."""
    out = _run("", argv=["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    out = _run("", cwd=str(alone), argv=["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
