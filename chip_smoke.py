"""End-to-end smoke run of tendermintx_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line; any failure raises (non-zero exit):

  1. device    - requires CUDA; prints the card's name and power limit;
  2. build     - compiles every hand-written kernel from csrc/ with nvcc;
  3. kernels   - each kernel against its plain torch version on the same
                 CUDA tensors (exact equality: integer field arithmetic),
                 Poseidon also against the host oracle, with both times;
  4. parity    - an N=4 skip composite proven on cuda and on cpu (plain
                 versions) at a small config: the proofs' bytes must match;
  5. slice     - the N=128 skip composite at DEFAULT_COMPOSITE_CONFIG,
                 proven on the card and verified by the port's verifier,
                 twice in one process as bench.py times the JAX package:
                 skip 1 -> 5 first (``skip_composite_n128_cold_seconds``,
                 host tables cold), then 2 -> 6 (``skip_composite_n128_seconds``,
                 warm); each is prove + verify. Every kernel must have been
                 launched by this phase. The per-statement phase seconds that
                 ``stark/batch.py`` logs are in the line under ``phases``;
  6. profile   - only with --profile: one more warm prove under
                 torch.profiler (device time by kernel, the card's busy
                 share of the wall time) and one under cProfile (the host
                 functions with the most cumulative time).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CHAIN_ID = "smoke-chain"
SKIP_MAX = 100
SEED = 20261016
GL_P = 0xFFFFFFFF00000001
EDGES = [0, 1, GL_P - 1, 2**32 - 1, 2**32, 2**63 % GL_P, GL_P - 2**32]


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def phase_build() -> dict:
    from tendermintx_tpu_torch.ops import cuda_build

    out = {"phase": "build"}
    for name in ("poseidon",):
        t0 = time.perf_counter()
        path = cuda_build.build(name)
        cuda_build.load_library(name)
        out[name] = {"seconds": time.perf_counter() - t0, "library": os.path.relpath(path)}
    emit(out)
    return out


def _time_ms(fn, reps: int = 5) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the canonical uint64 values (0 when equal)."""
    bad = (got != want).reshape(-1)
    if not bool(bad.any()):
        return 0.0
    g = got.reshape(-1)[bad].cpu().numpy().view(np.uint64).tolist()
    w = want.reshape(-1)[bad].cpu().numpy().view(np.uint64).tolist()
    return float(max(abs(int(a) - int(b)) for a, b in zip(g, w)))


def _field_tensor(rng, shape, dev) -> torch.Tensor:
    from tendermintx_tpu_torch.ops.goldilocks import tensor_from_u64

    u = rng.integers(0, 2**63, size=shape, dtype=np.uint64) * np.uint64(2)
    u += rng.integers(0, 2, size=shape, dtype=np.uint64)
    u[u >= np.uint64(GL_P)] -= np.uint64(GL_P)
    flat = u.reshape(-1)
    flat[: len(EDGES)] = np.array(EDGES, dtype=np.uint64)[: flat.size]
    return tensor_from_u64(u, dev)


def phase_kernels() -> dict:
    from tendermintx_tpu_torch.ops import poseidon as ps

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    rows = {}

    # Poseidon permutation: kernel == plain on every batch, == host oracle
    err = 0.0
    for b in (1, 7, 4096, 1 << 20, 1000003):
        st = _field_tensor(rng, (b, ps.WIDTH), dev)
        got = ps.permute_cuda(st)
        want = ps.permute_plain(st)
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(got, want))
        if b <= 4096:
            host = [ps.permute_ints([int(v) for v in row]) for row in
                    st[:8].cpu().numpy().view(np.uint64).tolist()]
            if got[:8].cpu().numpy().view(np.uint64).tolist() != host:
                raise AssertionError(f"poseidon kernel disagrees with the host oracle at B={b}")
    if err:
        raise AssertionError(f"poseidon kernel disagrees with permute_plain: {err}")
    big = _field_tensor(rng, (1 << 20, ps.WIDTH), dev)
    rows["poseidon_permute"] = {
        "route": "cuda",
        "source": "tendermintx_tpu_torch/csrc/poseidon.cu",
        "replaces": "tendermintx_tpu/ops/poseidon_pallas.py:182",
        "shape": [1 << 20, ps.WIDTH],
        "max_abs_err": err,
        "ms": _time_ms(lambda: ps.permute_cuda(big)),
        "plain_ms": _time_ms(lambda: ps.permute_plain(big), reps=2),
    }
    emit({"phase": "kernels", **rows})
    return rows


class SkipChain:
    """A synthetic chain written as fixtures, and the skip inputs between
    two of its heights."""

    def __init__(self, n_validators: int, workdir: str):
        from tendermintx_tpu_torch.inputs.fetcher import InputDataFetcher, InputDataMode
        from tendermintx_tpu_torch.inputs.testchain import TestChain

        self.n = n_validators
        self.chain = TestChain(n_validators=n_validators, chain_id=CHAIN_ID)
        for _ in range(8):
            self.chain.extend()
        self.chain.write_fixtures(workdir)
        self.fetcher = InputDataFetcher(fixture_path=workdir, mode=InputDataMode.FIXTURE)

    def skip(self, trusted_h: int, target_h: int):
        """(trusted hash, target hash, SkipInputs) for trusted_h -> target_h."""
        trusted = self.chain.headers[trusted_h].hash()
        inputs = self.fetcher.get_skip_inputs(trusted_h, trusted, target_h, max_validators=self.n)
        return trusted, self.chain.headers[target_h].hash(), inputs


def phase_parity(workdir: str) -> dict:
    from tendermintx_tpu_torch.circuits.composite import prove_skip_composite
    from tendermintx_tpu_torch.stark.prover import StarkConfig

    cfg = StarkConfig(rate_bits=2, n_queries=8, final_poly_len=16, proof_of_work_bits=4)
    trusted, _, inputs = SkipChain(4, os.path.join(workdir, "n4")).skip(1, 5)
    t0 = time.perf_counter()
    on_cuda = prove_skip_composite(1, trusted, 5, inputs, cfg, device="cuda").to_bytes()
    t1 = time.perf_counter()
    on_cpu = prove_skip_composite(1, trusted, 5, inputs, cfg, device="cpu").to_bytes()
    t2 = time.perf_counter()
    if on_cuda != on_cpu:
        raise AssertionError("N=4 composite proofs differ between cuda and cpu")
    out = {
        "phase": "parity", "n_validators": 4, "identical": True,
        "proof_bytes": len(on_cuda), "cuda_seconds": t1 - t0, "cpu_seconds": t2 - t1,
    }
    emit(out)
    return out


def _launch_counts() -> dict:
    from tendermintx_tpu_torch.ops import poseidon as ps

    return {"poseidon_permute": ps.permute_kernel_launches}


def _reset_launch_counts():
    from tendermintx_tpu_torch.ops import poseidon as ps

    ps.permute_kernel_launches = 0


class _PhaseLog(logging.Handler):
    """Collects the per-statement phase lines that stark/batch.py logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _prove_and_verify(sc: SkipChain, trusted_h: int, target_h: int) -> dict:
    """One timed N-validator skip: prove on the card, verify on the host,
    as bench.py's ``_run`` times it (inputs fetched before the clock)."""
    from tendermintx_tpu_torch.circuits.composite import (
        DEFAULT_COMPOSITE_CONFIG,
        CompositeProof,
        prove_skip_composite,
        verify_skip_composite,
    )

    trusted, target, inputs = sc.skip(trusted_h, target_h)
    phases = _PhaseLog()
    batch_log = logging.getLogger("tendermintx_tpu_torch.stark.batch")
    batch_log.addHandler(phases)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prove_skip_composite(
            trusted_h, trusted, target_h, inputs, DEFAULT_COMPOSITE_CONFIG, device="cuda"
        )
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        batch_log.removeHandler(phases)
    blob = proof.to_bytes()
    t2 = time.perf_counter()
    result = verify_skip_composite(CompositeProof.from_bytes(blob), CHAIN_ID, SKIP_MAX)
    t3 = time.perf_counter()
    if result != (trusted_h, trusted, target_h, target):
        raise AssertionError(f"N={sc.n} composite {trusted_h}->{target_h} failed to verify: {result!r}")
    return {
        "skip": [trusted_h, target_h],
        "seconds": (t1 - t0) + (t3 - t2),
        "prove_seconds": t1 - t0,
        "verify_seconds": t3 - t2,
        "proof_bytes": len(blob),
        "ed_lanes": proof.n_ed_segments,
        "phases": phases.lines,
    }


def phase_slice(sc: SkipChain) -> tuple[dict, dict]:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    cold = _prove_and_verify(sc, 1, 5)
    cold_launches = _launch_counts()
    warm = _prove_and_verify(sc, 2, 6)
    launches = _launch_counts()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    out = {
        "phase": "slice",
        "n_validators": sc.n,
        "skip_composite_n128_seconds": warm["seconds"],
        "skip_composite_n128_cold_seconds": cold["seconds"],
        "permute_kernel_launches": launches["poseidon_permute"],
        "launches": launches,
        "cold_launches": cold_launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "cold": cold,
        "warm": warm,
    }
    emit(out)
    return out, launches


def phase_profile(sc: SkipChain) -> dict:
    """A warm prove under torch.profiler, then one under cProfile."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tendermintx_tpu_torch.circuits.composite import (
        DEFAULT_COMPOSITE_CONFIG,
        prove_skip_composite,
    )

    def prove(trusted_h, target_h):
        trusted, _, inputs = sc.skip(trusted_h, target_h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove_skip_composite(trusted_h, trusted, target_h, inputs, DEFAULT_COMPOSITE_CONFIG, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = prove(3, 7)

    # Only the events that ran on the card (kernels, memcpy, memset); the
    # aten ops that launched them carry the same time again.
    on_card = [evt for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA]
    by_kernel = sorted(
        ((evt.key[:160], evt.self_device_time_total / 1e6, evt.count) for evt in on_card),
        key=lambda r: -r[1],
    )
    device_s = sum(r[1] for r in by_kernel)

    host = cProfile.Profile()
    host.enable()
    host_wall = prove(3, 7)
    host.disable()
    stats = pstats.Stats(host)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][3])[:15]

    out = {
        "phase": "profile",
        "torch_profiler": {
            "wall_seconds": wall,
            "device_seconds": device_s,
            "device_busy_share": device_s / wall,
            "device_events": sum(r[2] for r in by_kernel),
            "by_kernel": [
                {"name": k, "seconds": t, "count": c} for k, t, c in by_kernel[:15] if t > 0
            ],
        },
        "cprofile": {
            "wall_seconds": host_wall,
            "top_cumulative": [
                {"function": f"{os.path.basename(fn)}:{line}:{name}", "cumulative_seconds": v[3]}
                for (fn, line, name), v in top
            ],
        },
    }
    emit(out)
    return out


def main(argv: list[str]) -> int:
    import tendermintx_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    unknown = [a for a in argv if a != "--profile"]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown arguments {unknown}")

    # per-statement phase seconds of every prove, on stderr
    logging.basicConfig(format="%(asctime)s %(name)s %(message)s")
    logging.getLogger("tendermintx_tpu_torch.stark.batch").setLevel(logging.INFO)
    phase_device()
    phase_build()
    rows = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        phase_parity(workdir)
        n128 = SkipChain(128, os.path.join(workdir, "n128"))
        _, launches = phase_slice(n128)
        if "--profile" in argv:
            phase_profile(n128)
    kernels = [
        {"name": name, **{k: v for k, v in row.items() if k != "shape"},
         "launches": launches[name]}
        for name, row in rows.items()
    ]
    emit({"kernels": kernels})
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
