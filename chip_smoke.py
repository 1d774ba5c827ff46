"""End-to-end smoke run of tendermintx_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line; any failure raises (non-zero exit):

  1. device    - requires CUDA; prints the card's name and power limit;
  2. build     - compiles every hand-written kernel from csrc/ with nvcc;
  3. kernels   - each kernel against its plain torch version on the same
                 CUDA tensors (exact equality: integer field arithmetic)
                 at every batch size the main paths give it, up to 2^21
                 states, Poseidon also against the host oracle, with both
                 times;
  4. parity    - an N=4 skip composite proven on cuda and on cpu (plain
                 versions) at a small config, then recursion-wrapped on each
                 device at a small wrap config: the proofs' bytes must match,
                 the unwrapped ones and the wrapped ones;
  5. slice     - the N=128 skip composite at DEFAULT_COMPOSITE_CONFIG,
                 proven on the card and verified by the port's verifier,
                 twice in one process as bench.py times the JAX package:
                 skip 1 -> 5 first (``skip_composite_n128_cold_seconds``,
                 host tables cold), then 2 -> 6 (``skip_composite_n128_seconds``,
                 warm); each is prove + verify. Every kernel must have been
                 launched by this phase. The per-statement phase seconds that
                 ``stark/batch.py`` logs are in the line under ``phases``;
  6. step      - an N=128 step composite 4 -> 5 at DEFAULT_COMPOSITE_CONFIG,
                 proven on the card, verified after a wire round trip;
  7. wrap      - wrap_composite of the warm N=128 skip proof at
                 default_wrap_config() on the card, as bench.py times it
                 (``n128_wrap_seconds``), then to_bytes / from_bytes and
                 verify_skip_composite at the 100-bit floor on both configs
                 (``n128_wrapped_verify_seconds``,
                 ``n128_wrapped_proof_gz_bytes``); peak device memory; the
                 same wrap once more (host tables warm), byte-identical;
                 with --profile that second wrap runs under torch.profiler
                 and the line times its plain torch programs
                 (expand_perm_states and the EvalAir aux pieces);
  8. profile   - only with --profile: one more warm prove under
                 torch.profiler (device time by kernel, the card's busy
                 share of the wall time) and one under cProfile (the host
                 functions with the most cumulative time), the wrapped
                 verify under cProfile, and the cold build of the wrap
                 FRI's host fold tables alone.

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

    # Poseidon permutation: kernel == plain on every batch, == host oracle.
    # The main paths' batches run up to 2^21 states (EvalAir's leaf sponge
    # over its 2^21-point LDE); 2^18 is the grinding batch, 2^19 WrapAir's
    # leaves, 1000003 an odd tail.
    batches = (1, 7, 4096, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1000003)
    err = 0.0
    for b in batches:
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
        "checked_batches": list(batches),
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

    def step(self, prev_h: int):
        """(prev hash, StepInputs) for prev_h -> prev_h + 1."""
        prev = self.chain.headers[prev_h].hash()
        return prev, self.fetcher.get_step_inputs(prev_h, prev, max_validators=self.n)


def phase_parity(workdir: str) -> dict:
    """The N=4 skip composite and its wrap on both devices, at the small
    configs of the reference's wrapped tests (base rate 3, 6 queries,
    final 64, PoW 4; wrap rate 3, 6 queries, final 32, PoW 2)."""
    from tendermintx_tpu_torch.circuits.composite import prove_skip_composite, wrap_composite
    from tendermintx_tpu_torch.stark.prover import StarkConfig

    cfg = StarkConfig(rate_bits=3, n_queries=6, final_poly_len=64, proof_of_work_bits=4)
    wrap_cfg = StarkConfig(rate_bits=3, n_queries=6, final_poly_len=32, proof_of_work_bits=2)
    trusted, _, inputs = SkipChain(4, os.path.join(workdir, "n4")).skip(1, 5)
    out = {"phase": "parity", "n_validators": 4}
    blobs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        proof = prove_skip_composite(1, trusted, 5, inputs, cfg, device=dev)
        t1 = time.perf_counter()
        wrapped = wrap_composite(proof, cfg, wrap_cfg, device=dev)
        t2 = time.perf_counter()
        blobs[dev] = (proof.to_bytes(), wrapped.to_bytes())
        out[f"{dev}_seconds"] = t1 - t0
        out[f"{dev}_wrap_seconds"] = t2 - t1
    if blobs["cuda"][0] != blobs["cpu"][0]:
        raise AssertionError("N=4 composite proofs differ between cuda and cpu")
    if blobs["cuda"][1] != blobs["cpu"][1]:
        raise AssertionError("N=4 wrapped composite proofs differ between cuda and cpu")
    out.update(
        identical=True, wrapped_identical=True,
        proof_bytes=len(blobs["cuda"][0]), wrapped_proof_bytes=len(blobs["cuda"][1]),
    )
    emit(out)
    return out


def _launch_counts() -> dict:
    from tendermintx_tpu_torch.ops import poseidon as ps

    return {"poseidon_permute": ps.permute_kernel_launches}


def _reset_launch_counts():
    from tendermintx_tpu_torch.ops import poseidon as ps

    ps.permute_kernel_launches = 0


class _PhaseLog(logging.Handler):
    """Collects the per-statement phase lines that stark/batch.py logs,
    while used as a context manager."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("tendermintx_tpu_torch.stark.batch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("tendermintx_tpu_torch.stark.batch").removeHandler(self)


def _prove_and_verify(sc: SkipChain, trusted_h: int, target_h: int) -> tuple[dict, object]:
    """One timed N-validator skip: prove on the card, verify on the host,
    as bench.py's ``_run`` times it (inputs fetched before the clock)."""
    from tendermintx_tpu_torch.circuits.composite import (
        DEFAULT_COMPOSITE_CONFIG,
        CompositeProof,
        prove_skip_composite,
        verify_skip_composite,
    )

    trusted, target, inputs = sc.skip(trusted_h, target_h)
    with _PhaseLog() as phases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prove_skip_composite(
            trusted_h, trusted, target_h, inputs, DEFAULT_COMPOSITE_CONFIG, device="cuda"
        )
        torch.cuda.synchronize()
        t1 = time.perf_counter()
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
    }, proof


def _check_launched(launches: dict, path: str):
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {path} path")


def phase_slice(sc: SkipChain) -> tuple[dict, dict, object]:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    cold, _ = _prove_and_verify(sc, 1, 5)
    cold_launches = _launch_counts()
    warm, warm_proof = _prove_and_verify(sc, 2, 6)
    launches = _launch_counts()
    _check_launched(launches, "skip")
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
    return out, launches, warm_proof


def phase_step(sc: SkipChain) -> tuple[dict, dict]:
    """An N=128 step composite 4 -> 5, proven on the card and verified by
    verify_step_composite after a wire round trip."""
    from tendermintx_tpu_torch.circuits.composite import (
        DEFAULT_COMPOSITE_CONFIG,
        CompositeProof,
        prove_step_composite,
        verify_step_composite,
    )

    prev, inputs = sc.step(4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with _PhaseLog() as phases:
        t0 = time.perf_counter()
        proof = prove_step_composite(4, prev, inputs, DEFAULT_COMPOSITE_CONFIG, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = _launch_counts()
    _check_launched(launches, "step")
    blob = proof.to_bytes()
    t2 = time.perf_counter()
    result = verify_step_composite(CompositeProof.from_bytes(blob), CHAIN_ID)
    t3 = time.perf_counter()
    if result != (4, prev, inputs.next_header):
        raise AssertionError(f"N={sc.n} step composite 4->5 failed to verify: {result!r}")
    out = {
        "phase": "step",
        "n_validators": sc.n,
        "step": [4, 5],
        "prove_seconds": t1 - t0,
        "verify_seconds": t3 - t2,
        "proof_bytes": len(blob),
        "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "phases": phases.lines,
    }
    emit(out)
    return out, launches


PLAIN_RANGES = ("expand_perm_states", "eval_terms", "eval_scan", "eval_assemble")


def _range_times(prof, names) -> dict:
    """Seconds of each named record_function range in a torch.profiler
    run: `host` is the range's wall time, `device` the summed time of the
    kernels launched inside it. Raises if a range is missing."""
    from torch.autograd import DeviceType

    def kernel_us(evt):
        own = sum(k.duration for k in evt.kernels if k.name != evt.name)
        return own + sum(kernel_us(ch) for ch in evt.cpu_children)

    out: dict[str, dict] = {}
    for evt in prof.events():
        if evt.name in names and evt.device_type == DeviceType.CPU:
            row = out.setdefault(evt.name, {"count": 0, "host_seconds": 0.0, "device_seconds": 0.0})
            row["count"] += 1
            row["host_seconds"] += evt.cpu_time_total / 1e6
            row["device_seconds"] += kernel_us(evt) / 1e6
    missing = [n for n in names if n not in out]
    if missing:
        raise AssertionError(f"the profiled run passed through no range {missing}")
    return out


def phase_wrap(sc: SkipChain, proof, profile: bool) -> tuple[dict, dict, bytes]:
    """wrap_composite of the warm N=128 skip proof at default_wrap_config()
    on the card, timed as bench.py times it, then verified after a wire
    round trip at the default 100-bit floor on both configs. With
    `profile`, the second wrap runs under torch.profiler and the line
    gives the times of the plain torch programs (PLAIN_RANGES) in it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tendermintx_tpu_torch.circuits.composite import (
        CompositeProof,
        verify_skip_composite,
        wrap_composite,
    )

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with _PhaseLog() as phases:
        t0 = time.perf_counter()
        wrapped = wrap_composite(proof, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = _launch_counts()
    _check_launched(launches, "wrap")
    peak = torch.cuda.max_memory_allocated()
    # the same wrap again: first-use host tables (FRI inverse tables of
    # the 2^21-point domain, the N=128 eval tape) are built by now
    plain_programs = None
    if profile:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_again = time.perf_counter()
            again = wrap_composite(proof, device="cuda")
            torch.cuda.synchronize()
            second_wrap_seconds = time.perf_counter() - t_again
        plain_programs = _range_times(prof, PLAIN_RANGES)
    else:
        t_again = time.perf_counter()
        again = wrap_composite(proof, device="cuda")
        torch.cuda.synchronize()
        second_wrap_seconds = time.perf_counter() - t_again
    blob = wrapped.to_bytes()
    if again.to_bytes() != blob:
        raise AssertionError("two wraps of one proof differ")
    t2 = time.perf_counter()
    result = verify_skip_composite(CompositeProof.from_bytes(blob), CHAIN_ID, SKIP_MAX)
    t3 = time.perf_counter()
    trusted, target = sc.chain.headers[2].hash(), sc.chain.headers[6].hash()
    if result != (2, trusted, 6, target):
        raise AssertionError(f"N={sc.n} wrapped composite 2->6 failed to verify: {result!r}")
    out = {
        "phase": "wrap",
        "n_validators": sc.n,
        "skip": [2, 6],
        f"n{sc.n}_wrap_seconds": t1 - t0,
        "second_wrap_seconds": second_wrap_seconds,
        "second_wrap_profiled": profile,
        f"n{sc.n}_wrapped_verify_seconds": t3 - t2,
        f"n{sc.n}_wrapped_proof_gz_bytes": len(blob),
        "unwrapped_proof_gz_bytes": len(proof.to_bytes()),
        "wrapped_proof_json_bytes": len(json.dumps(wrapped.to_dict(), separators=(",", ":"))),
        "wrap_rows": [st.n_rows for st in wrapped.batch.wrapper.statements],
        "launches": launches,
        "max_memory_allocated": peak,
        "phases": phases.lines,
    }
    if plain_programs is not None:
        out["wrap_plain_program_seconds"] = plain_programs
    emit(out)
    return out, launches, blob


def _time_fri_tables(n: int, config) -> float:
    """Seconds to build, cache cold, the host FRI fold tables of one batch
    FRI over an n-point domain (first use of stark/fri.py::_inv_x_table)."""
    from tendermintx_tpu_torch.stark import fri

    fri._inv_x_table.cache_clear()
    stop = config.final_poly_len << config.rate_bits
    cur_n, cur_shift = n, config.shift % GL_P
    t0 = time.perf_counter()
    while cur_n > stop:
        fri._inv_x_table(cur_n.bit_length() - 1, cur_shift)
        cur_shift = cur_shift * cur_shift % GL_P
        cur_n //= 2
    return time.perf_counter() - t0


def _top_cumulative(prof, k: int) -> list[dict]:
    """The k functions with the most cumulative time under cProfile."""
    import pstats

    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][3])[:k]
    return [
        {"function": f"{os.path.basename(fn)}:{line}:{name}", "cumulative_seconds": v[3]}
        for (fn, line, name), v in top
    ]


def phase_profile(sc: SkipChain, wrapped_blob: bytes, wrap_rows: list[int]) -> dict:
    """A warm prove under torch.profiler, then one under cProfile, then the
    wrapped proof's verify under cProfile, then the cold build of the wrap
    FRI's host fold tables alone."""
    import cProfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tendermintx_tpu_torch.circuits.composite import (
        DEFAULT_COMPOSITE_CONFIG,
        CompositeProof,
        prove_skip_composite,
        verify_skip_composite,
    )
    from tendermintx_tpu_torch.stark.recursion import default_wrap_config

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
    top = _top_cumulative(host, 15)

    # the wrapped verify on the host, under cProfile
    host = cProfile.Profile()
    host.enable()
    t0 = time.perf_counter()
    result = verify_skip_composite(CompositeProof.from_bytes(wrapped_blob), CHAIN_ID, SKIP_MAX)
    verify_wall = time.perf_counter() - t0
    host.disable()
    if result is None:
        raise AssertionError("the profiled wrapped proof failed to verify")

    wrap_cfg = default_wrap_config()
    wrap_n = max(wrap_rows) << wrap_cfg.rate_bits

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
        "cprofile": {"wall_seconds": host_wall, "top_cumulative": top},
        "wrapped_verify_cprofile": {
            "wall_seconds": verify_wall,
            "top_cumulative": _top_cumulative(host, 25),
        },
        "wrap_fri_tables": {"domain": wrap_n, "cold_seconds": _time_fri_tables(wrap_n, wrap_cfg)},
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
        _, launches, warm_proof = phase_slice(n128)
        _, step_launches = phase_step(n128)
        profile = "--profile" in argv
        wrap, wrap_launches, wrapped_blob = phase_wrap(n128, warm_proof, profile)
        if profile:
            phase_profile(n128, wrapped_blob, wrap["wrap_rows"])
    kernels = [
        {"name": name, **{k: v for k, v in row.items() if k not in ("shape", "checked_batches")},
         "launches": launches[name],
         "launches_by_path": {"skip": launches[name], "step": step_launches[name], "wrap": wrap_launches[name]}}
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
