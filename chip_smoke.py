"""End-to-end smoke run of tendermintx_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line; any failure raises (non-zero exit):

  1. device    - requires CUDA; prints the card's name and power limit;
  2. build     - compiles every hand-written kernel from csrc/ with nvcc;
                 the line gives each kernel function's registers and spill
                 bytes from ptxas (-v); a spill fails;
  3. kernels   - each Poseidon entry (poseidon_permute,
                 poseidon_sponge_cols, poseidon_merkle_layer) against its
                 plain torch version on the same CUDA tensors (exact
                 equality: integer field arithmetic) at every shape the main
                 paths give it, and against the host oracle, with its time
                 and its plain version's at one shape, and its bound
                 (multiply-adds of the sparse partial-round form at the
                 card's maximum SM clock, or bytes at 3.35 TB/s; the bound
                 of the kernel's own dense count beside it);
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
                 launched by this phase, the warm prove's column sponge once
                 per column-major tree. The per-statement phase seconds that
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
                 torch.profiler (device time by kernel, Poseidon's and the
                 copies' totals, the card's busy share of the wall time)
                 and one under cProfile (the host
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
    """Build every kernel library; the line gives each kernel function's
    registers and spill bytes as ptxas reported them. Spills fail."""
    from tendermintx_tpu_torch.ops import cuda_build

    out = {"phase": "build"}
    for name in ("poseidon",):
        t0 = time.perf_counter()
        path = cuda_build.build(name)
        cuda_build.load_library(name)
        report = cuda_build.ptxas_report(name)
        out[name] = {
            "seconds": time.perf_counter() - t0,
            "library": os.path.relpath(path),
            "ptxas": report,
        }
        spills = {k: v for k, v in report.items() if v.get("spill_stores") or v.get("spill_loads")}
        if not report or spills:
            emit(out)
            raise AssertionError(f"{name}: ptxas reports spills or no kernel: {spills or report}")
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


def _nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# The bound of a Poseidon entry: 32-bit multiply-adds at Hopper's 64 per
# clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) at the card's maximum SM clock, or its
# bytes at 3.35 TB/s (H100 SXM data sheet), whichever is longer. The
# multiply-adds are those of the cheapest known form of the same
# permutation, plonky2's sparse partial rounds: 8 full rounds of 12 S-boxes
# (4 field products of 4 partial products each) and the dense 7-bit MDS (144
# entries x 2 halves); once, an 11 x 11 layer of full field products; then
# each of the 22 partial rounds one S-box, a first row of 11 full products
# and one 7-bit product, and a rank-one update of 11 full products.
FULL_ROUND_MULS = 12 * 4 * 4 + 144 * 2
MULS_PER_PERMUTATION = 8 * FULL_ROUND_MULS + 11 * 11 * 4 + 22 * (4 * 4 + 11 * 4 + 2 + 11 * 4)  # 6,656
# The kernel's own count: the dense MDS in every round, as the reference
# defines the rounds; its bound (design_bound_ms) is printed beside.
DESIGN_MULS_PER_PERMUTATION = 118 * 4 * 4 + 30 * 144 * 2  # 10,528
MULS_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12


def _bound(permutations: int, nbytes: int, clock_mhz: float) -> dict:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    muls_per_ms = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3
    ops_ms = permutations * MULS_PER_PERMUTATION / muls_per_ms
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "operations_bound_ms": ops_ms,
        "bytes_bound_ms": bytes_ms,
        "design_bound_ms": max(permutations * DESIGN_MULS_PER_PERMUTATION / muls_per_ms, bytes_ms),
        "permutations": permutations,
        "bytes": nbytes,
    }


def _timed_once(fn):
    """(fn(), its ms between two CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _u64_rows(t: torch.Tensor) -> list[list[int]]:
    return t.cpu().numpy().view(np.uint64).tolist()


def _check_equal(got: torch.Tensor, want: torch.Tensor, what: str):
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if err:
        raise AssertionError(f"{what} disagrees with its plain version: max_abs_err {err}")


def _kernel_permute(ps, rng, dev, clock_mhz: float) -> dict:
    """The permutation == plain on every batch the main paths give it (each
    power of two up to 2^21: grinding at 2^18, the FRI layer trees, the
    row-major leaves; 7 and 1000003 as odd tails); 8 rows == the host
    oracle."""
    batches = [1 << k for k in range(22)] + [7, 1000003]
    for b in batches:
        st = _field_tensor(rng, (b, ps.WIDTH), dev)
        got = ps.permute_cuda(st)
        _check_equal(got, ps.permute_plain(st), f"poseidon_permute at B={b}")
        if b <= 4096:
            want = [ps.permute_ints(row) for row in _u64_rows(st[:8])]
            if _u64_rows(got[:8]) != want:
                raise AssertionError(f"poseidon_permute disagrees with the host oracle at B={b}")
    n = 1 << 20
    big = _field_tensor(rng, (n, ps.WIDTH), dev)
    bound = _bound(n, 2 * n * ps.WIDTH * 8, clock_mhz)
    return {
        "route": "cuda",
        "source": "tendermintx_tpu_torch/csrc/poseidon.cu",
        "replaces": "tendermintx_tpu/ops/poseidon_pallas.py:182",
        "shape": [n, ps.WIDTH],
        "checked_batches": batches,
        "max_abs_err": 0.0,
        "ms": _time_ms(lambda: ps.permute_cuda(big), 500),
        "plain_ms": _time_ms(lambda: ps.permute_plain(big), reps=2),
        **bound,
        "library_ms": None,
    }


def _random_cols(shape, gen, dev) -> torch.Tensor:
    """Canonical felts below 2^63 made on the card from a seeded generator
    (the full Ed25519 LDE is 6 GB), the edge values in column 0."""
    from tendermintx_tpu_torch.ops.goldilocks import tensor_from_u64

    x = torch.randint(0, 2**63 - 1, shape, dtype=torch.int64, device=dev, generator=gen)
    k = min(len(EDGES), shape[1])
    x[0, :k] = tensor_from_u64(np.array(EDGES[:k], dtype=np.uint64), dev)
    return x


# The timed shape, then every column-major tree of the N=128 paths,
# (columns, LDE rows): trace, aux and quotient (2 x chunks) of each
# statement. The timed shape is the Ed25519 trace and aux together
# (2,031 + 898 columns): the same 367 absorbs per leaf as its two trees.
SPONGE_TIMED = (2929, 1 << 18)
MAIN_PATH_TREES = (
    (2031, 1 << 18), (898, 1 << 18), (8, 1 << 18),  # Ed25519
    (170, 1 << 19), (6, 1 << 19),  # SHA-256 plan, skip
    (170, 1 << 18), (6, 1 << 18),  # SHA-256 plan, step
    (340, 1 << 18),  # SHA-512 table (its quotient is (6, 2^18) above)
    (136, 1 << 19), (14, 1 << 19),  # WrapAir, rate 4
    (8, 1 << 21), (10, 1 << 21), (4, 1 << 21),  # EvalAir, rate 4
)


def _kernel_sponge(ps, rng, dev, clock_mhz: float) -> dict:
    """The column sponge == plain on its whole output at SPONGE_TIMED and
    every tree of the main paths (MAIN_PATH_TREES), and at the ragged and
    exact small widths on 1,024 leaves, where 8 leaves of each == hash_ints
    of the zero-padded row. Kernel and plain are timed at SPONGE_TIMED: the
    plain version once, in its check."""
    widths = (1, 7, 8, 9, 170, 340, 2929)
    for L in widths:
        cols = _field_tensor(rng, (L, 1024), dev)
        got = ps.sponge_cols_cuda(cols)
        _check_equal(got, ps.hash_no_pad_cols_plain(cols), f"poseidon_sponge_cols at L={L}")
        rows = _u64_rows(cols[:, :8].t())
        want = [ps.hash_ints(r + [0] * ((-L) % ps.RATE)) for r in rows]
        if _u64_rows(got[:8]) != want:
            raise AssertionError(f"poseidon_sponge_cols disagrees with the host oracle at L={L}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timed = None
    for L, n in (SPONGE_TIMED, *MAIN_PATH_TREES):
        cols = _random_cols((L, n), gen, dev)
        want, plain_ms = _timed_once(lambda: ps.hash_no_pad_cols_plain(cols))
        _check_equal(ps.sponge_cols_cuda(cols), want, f"poseidon_sponge_cols at ({L}, {n})")
        del want
        if timed is None:
            timed = {
                "shape": [L, n],
                "ms": _time_ms(lambda: ps.sponge_cols_cuda(cols), 6),
                "plain_ms": plain_ms,
                **_bound(n * -(-L // ps.RATE), L * n * 8 + n * ps.DIGEST * 8, clock_mhz),
            }
        del cols
    return {
        "route": "cuda",
        "source": "tendermintx_tpu_torch/csrc/poseidon.cu",
        "replaces": "tendermintx_tpu/ops/poseidon_pallas.py:182",
        "replaces_program": "tendermintx_tpu/ops/poseidon.py:394 (hash_no_pad_cols)",
        "checked_widths": list(widths),
        "checked_trees": [list(t) for t in MAIN_PATH_TREES],
        "max_abs_err": 0.0,
        **timed,
        "library_ms": None,
    }


def _kernel_layer(ps, rng, dev, clock_mhz: float) -> dict:
    """One tree layer == plain at every layer size the main paths build,
    n = 2 .. 2^21 digests (EvalAir's leaves are 2^21); 8 parents ==
    two_to_one_ints."""
    sizes = [1 << k for k in range(1, 22)]
    for n in sizes:
        d = _field_tensor(rng, (n, ps.DIGEST), dev)
        got = ps.merkle_layer_cuda(d)
        _check_equal(got, ps.merkle_layer_plain(d), f"poseidon_merkle_layer at n={n}")
        rows = _u64_rows(d[:16])
        want = [ps.two_to_one_ints(rows[2 * i], rows[2 * i + 1]) for i in range(min(8, n // 2))]
        if _u64_rows(got[: len(want)]) != want:
            raise AssertionError(f"poseidon_merkle_layer disagrees with the host oracle at n={n}")
    n = 1 << 18
    d = _field_tensor(rng, (n, ps.DIGEST), dev)
    bound = _bound(n // 2, n * ps.DIGEST * 8 + (n // 2) * ps.DIGEST * 8, clock_mhz)
    return {
        "route": "cuda",
        "source": "tendermintx_tpu_torch/csrc/poseidon.cu",
        "replaces": "tendermintx_tpu/ops/poseidon_pallas.py:182",
        "replaces_program": "tendermintx_tpu/ops/merkle.py:57 (_inner_layers)",
        "shape": [n, ps.DIGEST],
        "checked_sizes": [sizes[0], sizes[-1]],
        "max_abs_err": 0.0,
        "ms": _time_ms(lambda: ps.merkle_layer_cuda(d), 4000),
        "plain_ms": _time_ms(lambda: ps.merkle_layer_plain(d), reps=2),
        **bound,
        "library_ms": None,
    }


def phase_kernels() -> dict:
    """Each Poseidon entry against its plain torch version on the same
    CUDA tensors (exact: integer field arithmetic) and the host oracle,
    with its time, its plain version's, and its bound."""
    from tendermintx_tpu_torch.ops import poseidon as ps

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    clock_mhz = float(_nvidia_smi("clocks.max.sm"))
    rows = {
        "poseidon_permute": _kernel_permute(ps, rng, dev, clock_mhz),
        "poseidon_sponge_cols": _kernel_sponge(ps, rng, dev, clock_mhz),
        "poseidon_merkle_layer": _kernel_layer(ps, rng, dev, clock_mhz),
    }
    for row in rows.values():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["design_bound_share"] = row["design_bound_ms"] / row["ms"]
    emit({
        "phase": "kernels",
        "clocks_max_sm_mhz": clock_mhz,
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        **rows,
    })
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


LAUNCH_COUNTERS = {
    "poseidon_permute": "permute_kernel_launches",
    "poseidon_sponge_cols": "sponge_kernel_launches",
    "poseidon_merkle_layer": "layer_kernel_launches",
}


def _launch_counts() -> dict:
    from tendermintx_tpu_torch.ops import poseidon as ps

    return {name: getattr(ps, counter) for name, counter in LAUNCH_COUNTERS.items()}


def _reset_launch_counts():
    from tendermintx_tpu_torch.ops import poseidon as ps

    for counter in LAUNCH_COUNTERS.values():
        setattr(ps, counter, 0)


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
    warm_launches = {k: launches[k] - cold_launches[k] for k in launches}
    # one sponge launch per column-major tree: trace, quotient and (where
    # the AIR has one) aux commitment of every statement
    trees = sum(2 + (st.aux_cap is not None) for st in warm_proof.batch.statements)
    if warm_launches["poseidon_sponge_cols"] != trees:
        raise AssertionError(
            f"the warm prove commits {trees} column-major trees with "
            f"{warm_launches['poseidon_sponge_cols']} sponge launches"
        )
    out = {
        "phase": "slice",
        "n_validators": sc.n,
        "skip_composite_n128_seconds": warm["seconds"],
        "skip_composite_n128_cold_seconds": cold["seconds"],
        "launches": launches,
        "cold_launches": cold_launches,
        "warm_launches": warm_launches,
        "warm_column_trees": trees,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "cold": cold,
        "warm": warm,
    }
    emit(out)
    return out, cold_launches, warm_launches, warm_proof


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

    def total(rows) -> dict:
        return {"seconds": sum(r[1] for r in rows), "count": sum(r[2] for r in rows)}

    poseidon = [r for r in by_kernel if "tmx_poseidon" in r[0]]
    copies = {
        "memcpy": total([r for r in by_kernel if r[0].startswith("Memcpy")]),
        "copy_kernels": total([r for r in by_kernel if "copy" in r[0].lower() and not r[0].startswith("Memcpy")]),
    }

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
            "poseidon": {**total(poseidon),
                         "by_entry": [{"name": k, "seconds": t, "count": c} for k, t, c in poseidon]},
            "copies": copies,
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
        _, cold_launches, warm_launches, warm_proof = phase_slice(n128)
        _, step_launches = phase_step(n128)
        profile = "--profile" in argv
        wrap, wrap_launches, wrapped_blob = phase_wrap(n128, warm_proof, profile)
        if profile:
            phase_profile(n128, wrapped_blob, wrap["wrap_rows"])
    kept = ("route", "source", "replaces", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_share", "library_ms")
    kernels = [
        {"name": name, **{k: row[k] for k in kept},
         "launches": cold_launches[name] + warm_launches[name],
         "launches_by_path": {"skip_cold": cold_launches[name], "skip_warm": warm_launches[name],
                              "step": step_launches[name], "wrap": wrap_launches[name]}}
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
