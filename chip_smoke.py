"""End-to-end smoke run of tendermintx_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line; any failure raises (non-zero exit):

  1. device    - requires CUDA; prints the card's name and power limit;
  2. build     - compiles every hand-written kernel from csrc/ with nvcc;
                 the line gives each kernel function's registers and spill
                 bytes from ptxas (-v); a spill fails;
  3. parity    - an N=4 skip composite proven on cuda and on cpu (plain
                 versions) at a small config, then recursion-wrapped on each
                 device at a small wrap config: the proofs' bytes must match,
                 the unwrapped ones and the wrapped ones; and the N=4 skip
                 HashBundle at DEFAULT_HASH_CONFIG proven on each device
                 (the card's in phase 7), its JSON byte-identical. The
                 card's prove and wrap run here; the CPU prove (then the
                 CPU hash bundle) and the CPU wrap (of the card's proof
                 bytes) run in two spawned low-priority processes beside
                 phases 4-10, and the line is printed when both have ended,
                 after phase 10;
  4. kernels   - each Poseidon entry (poseidon_permute,
                 poseidon_sponge_cols, poseidon_merkle_layer) against its
                 plain torch version on the same CUDA tensors (exact
                 equality: integer field arithmetic) at every shape the main
                 paths give it, and against the host oracle, with its time
                 and its plain version's at one shape, and its bound
                 (multiply-adds of the sparse partial-round form at the
                 card's maximum SM clock, or bytes at 3.35 TB/s; the bound
                 of the kernel's own dense count beside it);
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
  7. hashes    - the standalone SHA-256 hash-plan proofs
                 (circuits/hashing.py) at N=128 and DEFAULT_HASH_CONFIG:
                 the skip 2 -> 6 and step 4 -> 5 HashBundles proven on the
                 card, each read back through JSON and verified by the
                 port, its facts equal to the chain (the 128 validator
                 encodings, the validators hash) and every statement change
                 of tests/test_hashing.py rejected; prove and verify
                 seconds, JSON bytes and peak memory of each, beside the
                 card's name and power limit; every Poseidon entry must be
                 launched by the two proves. Then the N=4 skip bundle on
                 the card, for the parity phase;
  8. wrap      - wrap_composite of the warm N=128 skip proof at
                 default_wrap_config() on the card, as bench.py times it
                 (``n128_wrap_seconds``), then to_bytes / from_bytes and
                 verify_skip_composite at the 100-bit floor on both configs
                 (``n128_wrapped_verify_seconds``,
                 ``n128_wrapped_proof_gz_bytes``); peak device memory; the
                 same wrap once more (host tables warm), byte-identical;
                 with --profile that second wrap runs under torch.profiler
                 and the line times its plain torch programs
                 (expand_perm_states and the EvalAir aux pieces);
  9. runtime   - the port's entry points on the card at N=128, in this
                 process: ``cli build`` and a witness-only ``cli prove`` of
                 skip 2 -> 6 (valid, header 6); skip_verify timed on the
                 card (with --profile also sha256_blocks, sha512_blocks,
                 straus_verify, verify_bound and step_verify, and each
                 one's torch op count: the launches of eager torch); a
                 ProverService on
                 the card that prewarms and answers a wrapped skip 2 -> 6
                 and a step 4 -> 5 request through ProverClient, each
                 proof byte-identical to the wrap and step phases' and
                 accepted by ``cli verify`` (a tampered abi_output exits
                 1); an operator with prove_stark on a MockContract for
                 one tick (the head moves, the leaf STARK verifies); peak
                 memory and Poseidon launches;
 10. mesh      - multi-device proving on a 4-shard lane mesh
                 ([cuda:i % cards for i in range(4)]: all four on cuda:0 on
                 a one-card host): the N=128 skip 2 -> 6 at
                 DEFAULT_COMPOSITE_CONFIG with mesh= (bytes equal to the
                 slice phase's warm proof, verified; prove and verify
                 seconds, peak memory; the column sponge launched once per
                 shard for each column-major tree), sharded_lane_checks over
                 its 128 lanes (equal to single-device verify_bound,
                 hash_validator_leaves and Python-int sums), the card's N=4
                 parity proof wrapped with mesh= (equal to its single-device
                 wrap), the sharded Poseidon batch at 2^20 states and the
                 four-step NTT at 2^20 (each equal to its single-device
                 function, both timed), and dryrun_multichip(4) in each
                 of its shapes (default, toy, full), each timed;
 11. profile   - only with --profile: one more warm prove under
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
# the device of the runtime phase's entry points (the card; a CPU rehearsal
# of the phase's control flow may set "cpu")
RUNTIME_DEVICE = "cuda"
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
# the mesh path's row blocks: each tree of the N=128 skip over 4 shards
# (the mesh phase's MESH_SHARDS), (columns, LDE rows / 4); (2,929, 2^16)
# is the Ed25519 trace and aux together
MESH_PATH_TREES = (
    (2929, 1 << 16), (2031, 1 << 16), (898, 1 << 16), (8, 1 << 16),
    (170, 1 << 17), (6, 1 << 17), (340, 1 << 16), (6, 1 << 16),
)


def _kernel_sponge(ps, rng, dev, clock_mhz: float) -> dict:
    """The column sponge == plain on its whole output at SPONGE_TIMED,
    every tree of the main paths (MAIN_PATH_TREES) and every row block of
    the mesh path (MESH_PATH_TREES), and at the ragged and
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
    for L, n in (SPONGE_TIMED, *MAIN_PATH_TREES, *MESH_PATH_TREES):
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
        "checked_mesh_blocks": [list(t) for t in MESH_PATH_TREES],
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
        self.fixture_path = workdir
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


def _parity_configs():
    """The small configs of the reference's wrapped tests: base rate 3, 6
    queries, final 64, PoW 4; wrap rate 3, 6 queries, final 32, PoW 2."""
    from tendermintx_tpu_torch.stark.prover import StarkConfig

    return (
        StarkConfig(rate_bits=3, n_queries=6, final_poly_len=64, proof_of_work_bits=4),
        StarkConfig(rate_bits=3, n_queries=6, final_poly_len=32, proof_of_work_bits=2),
    )


# torch threads of the parity phase's two CPU processes on the 8-core
# host (the CPU prove and the CPU wrap), and their niceness: they run
# while the card phases do, whose host work goes first
PARITY_PROVE_THREADS = 3
PARITY_WRAP_THREADS = 5
PARITY_NICE = 19


def _hash_bundle_json(bundle) -> str:
    """A HashBundle's wire form: its dict as JSON with sorted keys."""
    return json.dumps(bundle.to_dict(), sort_keys=True)


def _parity_cpu_prove(trusted: bytes, inputs) -> tuple[bytes, str, float]:
    """The N=4 skip composite proven on the CPU (its bytes), then the N=4
    skip HashBundle at DEFAULT_HASH_CONFIG (its JSON, and its seconds)."""
    from tendermintx_tpu_torch.circuits.composite import prove_skip_composite
    from tendermintx_tpu_torch.circuits.hashing import prove_skip_hashes

    blob = prove_skip_composite(1, trusted, 5, inputs, _parity_configs()[0], device="cpu").to_bytes()
    t0 = time.perf_counter()
    hashes = _hash_bundle_json(prove_skip_hashes(inputs, device="cpu"))
    return blob, hashes, time.perf_counter() - t0


def _parity_cpu_wrap(blob: bytes) -> bytes:
    """A composite proof, read from its bytes, wrapped on the CPU: the
    wrapped proof's bytes."""
    from tendermintx_tpu_torch.circuits.composite import CompositeProof, wrap_composite

    cfg, wrap_cfg = _parity_configs()
    return wrap_composite(CompositeProof.from_bytes(blob), cfg, wrap_cfg, device="cpu").to_bytes()


def _cpu_job_main(fn, args, threads: int, conn):
    """Body of a spawned CPU process: fn(*args) at niceness PARITY_NICE on
    `threads` torch threads; sends (result, seconds) through `conn`."""
    os.nice(PARITY_NICE)
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    out = fn(*args)
    conn.send((out, time.perf_counter() - t0))
    conn.close()


class _CpuJob:
    """fn(*args) in a spawned low-priority process (no CUDA in it)."""

    def __init__(self, fn, args: tuple, threads: int):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._recv, send = ctx.Pipe(duplex=False)
        self.threads = threads
        self.process = ctx.Process(target=_cpu_job_main, args=(fn, args, threads, send), daemon=True)
        self.process.start()
        send.close()

    def result(self):
        """(fn's result, its seconds); raises if the process failed."""
        try:
            out = self._recv.recv()  # EOFError if the process died
        finally:
            self.stop(timeout=60)
        if self.process.exitcode != 0:
            raise AssertionError(f"a parity CPU process exited with {self.process.exitcode}")
        return out

    def stop(self, timeout: float = 0):
        """Join the process, killing it if it still runs after `timeout` s."""
        self.process.join(timeout=timeout)
        if self.process.is_alive():
            self.process.kill()
            self.process.join()


def parity_start(workdir: str) -> dict:
    """The card half of the parity phase: the N=4 skip composite proven
    and then wrapped on the card at _parity_configs(). The CPU half starts
    as two spawned low-priority processes, which run while the later
    phases use the card: the CPU prove of the same inputs, and the CPU
    wrap of the card's proof read from its bytes (as the card's wrap reads
    it). phase_parity collects them."""
    from tendermintx_tpu_torch.circuits.composite import (
        CompositeProof,
        prove_skip_composite,
        wrap_composite,
    )

    cfg, wrap_cfg = _parity_configs()
    trusted, target, inputs = SkipChain(4, os.path.join(workdir, "n4")).skip(1, 5)
    out = {"phase": "parity", "n_validators": 4}
    t0 = time.perf_counter()
    proof = prove_skip_composite(1, trusted, 5, inputs, cfg, device="cuda")
    t1 = time.perf_counter()
    blob = proof.to_bytes()
    jobs = {
        "prove": _CpuJob(_parity_cpu_prove, (trusted, inputs), PARITY_PROVE_THREADS),
        "wrap": _CpuJob(_parity_cpu_wrap, (blob,), PARITY_WRAP_THREADS),
    }
    t_jobs = time.perf_counter()
    wrapped = wrap_composite(CompositeProof.from_bytes(blob), cfg, wrap_cfg, device="cuda")
    t2 = time.perf_counter()
    out.update(cuda_seconds=t1 - t0, cuda_wrap_seconds=t2 - t1)
    return {"line": out, "cuda": (blob, wrapped.to_bytes()), "jobs": jobs, "jobs_started": t_jobs,
            "n4_skip": (trusted, target, inputs)}


def phase_parity(state: dict) -> dict:
    """The CPU half of the parity phase, collected: the proofs' bytes must
    match the card's, the unwrapped ones and the wrapped ones, and the
    N=4 hash bundle's JSON the card's (phase_hashes). The line gives each
    CPU job's seconds, both jobs' wall from their start, and how long this
    process waited for them at the end."""
    out, jobs = state["line"], state["jobs"]
    t_wait = time.perf_counter()
    ((cpu_proof, cpu_hashes, cpu_hashes_seconds), cpu_seconds), (cpu_wrapped, cpu_wrap_seconds) = (
        jobs["prove"].result(), jobs["wrap"].result()
    )
    t_done = time.perf_counter()
    out.update(
        cpu_seconds=cpu_seconds, cpu_hashes_seconds=cpu_hashes_seconds, cpu_wrap_seconds=cpu_wrap_seconds,
        cpu_concurrent_seconds=t_done - state["jobs_started"],
        cpu_wait_seconds=t_done - t_wait,
        cpu_threads={name: job.threads for name, job in jobs.items()},
        cpu_nice=PARITY_NICE,
    )
    blob, wrapped_blob = state["cuda"]
    if cpu_proof != blob:
        raise AssertionError("N=4 composite proofs differ between cuda and cpu")
    if cpu_wrapped != wrapped_blob:
        raise AssertionError("N=4 wrapped composite proofs differ between cuda and cpu")
    if cpu_hashes != state["hashes_cuda"]:
        raise AssertionError("N=4 skip hash bundles differ between cuda and cpu")
    out.update(identical=True, wrapped_identical=True, proof_bytes=len(blob), wrapped_proof_bytes=len(wrapped_blob),
               hash_bundle_identical=True, hash_bundle_json_bytes=len(cpu_hashes))
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


# the loggers of the per-statement phase lines: the batch prover's, and
# the single-statement prover's (the hashes phase)
PHASE_LOGGERS = ("tendermintx_tpu_torch.stark.batch", "tendermintx_tpu_torch.stark.prover")


class _PhaseLog(logging.Handler):
    """Collects the per-statement phase lines that stark/batch.py (or,
    given its logger, stark/prover.py) logs, while used as a context
    manager."""

    def __init__(self, logger: str = PHASE_LOGGERS[0]):
        super().__init__(logging.INFO)
        self.logger = logging.getLogger(logger)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


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


def phase_step(sc: SkipChain) -> tuple[dict, dict, bytes]:
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
    return out, launches, blob


def _prove_bundle(prove_fn, inputs) -> tuple[object, dict]:
    """A HashBundle proven on the card at DEFAULT_HASH_CONFIG, and its
    prove seconds, peak device memory and the prover's phase line."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _PhaseLog(PHASE_LOGGERS[1]) as phases:
        t0 = time.perf_counter()
        bundle = prove_fn(inputs, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return bundle, {"prove_seconds": seconds, "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "phases": phases.lines}


def _verify_bundle(verify_fn, bundle, headers: tuple[bytes, bytes], height: int) -> tuple[object, dict]:
    """The bundle read back from its JSON and verified (facts or None),
    with the JSON's bytes and the read-back + verify seconds."""
    from tendermintx_tpu_torch.circuits.hashing import HashBundle

    text = _hash_bundle_json(bundle)
    t0 = time.perf_counter()
    facts = verify_fn(HashBundle.from_dict(json.loads(text)), CHAIN_ID, *headers, height)
    return facts, {"verify_seconds": time.perf_counter() - t0, "json_bytes": len(text)}


def _rejected(verify_fn, bundle, cases: dict) -> list[str]:
    """Names of the statement changes (name -> (headers, height, chain
    id)) that the verifier accepts: each must be rejected."""
    return [
        name for name, (headers, height, chain_id) in cases.items()
        if verify_fn(bundle, chain_id, *headers, height) is not None
    ]


def phase_hashes(sc: SkipChain, parity: dict, card: str) -> tuple[dict, dict]:
    """The standalone SHA-256 hash-plan proofs at N=128 and
    DEFAULT_HASH_CONFIG on the card: the skip 2 -> 6 and step 4 -> 5
    HashBundles, each read back through JSON and verified by the port, its
    facts equal to the chain's (every validator's encoding, the validators
    hash) and every statement change of tests/test_hashing.py rejected.
    Every Poseidon entry must be launched by the two proves; their counts
    are the hashes path's. Then the N=4 skip bundle on the card, whose JSON
    phase_parity holds against the CPU's."""
    import dataclasses

    from tendermintx_tpu_torch.circuits.hashing import (
        DEFAULT_HASH_CONFIG,
        prove_skip_hashes,
        prove_step_hashes,
        verify_skip_hashes,
        verify_step_hashes,
    )

    chain = sc.chain
    encodings = [v.simple_encode() for v in chain.val_set]
    trusted, target, skip_inputs = sc.skip(2, 6)
    prev, step_inputs = sc.step(4)
    nxt = chain.headers[5].hash()
    _reset_launch_counts()
    skip, skip_line = _prove_bundle(prove_skip_hashes, skip_inputs)
    step, step_line = _prove_bundle(prove_step_hashes, step_inputs)
    launches = _launch_counts()
    _check_launched(launches, "hashes")

    facts, more = _verify_bundle(verify_skip_hashes, skip, (trusted, target), 6)
    skip_line.update(more)
    if facts is None:
        raise AssertionError(f"the N={sc.n} skip hash bundle 2->6 failed to verify")
    if (facts.target_encodings, facts.trusted_encodings) != (encodings, encodings):
        raise AssertionError("the skip hash bundle's validator encodings are not the chain's")
    if (facts.target_validators_hash, facts.trusted_validators_hash) != (chain.vhash, chain.vhash):
        raise AssertionError("the skip hash bundle's validators hashes are not the chain's")
    flipped = list(skip.proof.public_inputs)
    flipped[0] ^= 1
    tampered = dataclasses.replace(skip, proof=dataclasses.replace(skip.proof, public_inputs=flipped))
    skip_cases = {
        "target_header": ((trusted, bytes(32)), 6, CHAIN_ID),
        "height": ((trusted, target), 7, CHAIN_ID),
        "chain_id": ((trusted, target), 6, "other-chain"),
        "trusted_header": ((bytes(32), target), 6, CHAIN_ID),
    }
    tampered_cases = {"public_input": ((trusted, target), 6, CHAIN_ID)}
    accepted = _rejected(verify_skip_hashes, skip, skip_cases)
    accepted += _rejected(verify_skip_hashes, tampered, tampered_cases)

    facts, more = _verify_bundle(verify_step_hashes, step, (prev, nxt), 5)
    step_line.update(more)
    if facts is None:
        raise AssertionError(f"the N={sc.n} step hash bundle 4->5 failed to verify")
    if (facts.encodings, facts.validators_hash) != (encodings, chain.vhash):
        raise AssertionError("the step hash bundle's facts are not the chain's")
    step_cases = {
        "prev_header": ((bytes(32), nxt), 5, CHAIN_ID),
        "next_header": ((prev, bytes(32)), 5, CHAIN_ID),
    }
    accepted += _rejected(verify_step_hashes, step, step_cases)
    if accepted:
        raise AssertionError(f"the hash bundle verifiers accepted changed statements: {accepted}")

    # the N=4 skip bundle on the card; phase_parity compares the CPU's
    n4_trusted, n4_target, n4_inputs = parity["n4_skip"]
    n4, n4_line = _prove_bundle(prove_skip_hashes, n4_inputs)
    facts, more = _verify_bundle(verify_skip_hashes, n4, (n4_trusted, n4_target), 5)
    if facts is None:
        raise AssertionError("the N=4 skip hash bundle 1->5 failed to verify")
    parity["hashes_cuda"] = _hash_bundle_json(n4)

    out = {
        "phase": "hashes",
        "card": card,
        "n_validators": sc.n,
        "config": dataclasses.asdict(DEFAULT_HASH_CONFIG),
        "skip": {"skip": [2, 6], "rows": skip.proof.n_rows, "segments": skip.n_segments, **skip_line},
        "step": {"step": [4, 5], "rows": step.proof.n_rows, "segments": step.n_segments, **step_line},
        "facts_equal_chain": True,
        "rejected": [*skip_cases, *tampered_cases, *step_cases],
        "n4_skip": {"skip": [1, 5], "rows": n4.proof.n_rows, **n4_line, **more},
        "launches": launches,
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


class _OpCount:
    """Counts the torch operators dispatched to CUDA tensors (views
    excluded) while used as a context manager: each is about one kernel
    launch of eager torch."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not func.is_view:
                    outs = out if isinstance(out, (tuple, list)) else (out,)
                    if any(isinstance(o, torch.Tensor) and o.is_cuda for o in outs):
                        counter.ops += 1
                return out

        self.ops = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _card_seconds(fn):
    """(fn's result, seconds between CUDA events around one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def _witness_programs(sc: SkipChain, profile: bool) -> dict:
    """The witness programs at N=128 on the card: seconds of one call
    (CUDA events; the CLI's witness prove ran the same programs at the
    same shapes before) of skip_verify on the skip 2 -> 6 witness and,
    with `profile`, of each program below (step_verify on the step 4 -> 5
    witness) and the torch ops one call dispatches."""
    from tendermintx_tpu_torch.circuits import gadgets
    from tendermintx_tpu_torch.circuits.variables import pack_skip_witness, pack_step_witness
    from tendermintx_tpu_torch.circuits.verify import chain_id_leaf_const, skip_verify, step_verify
    from tendermintx_tpu_torch.ops import ed25519, sha256, sha512

    trusted, _, inputs = sc.skip(2, 6)
    w = pack_skip_witness(inputs).to(RUNTIME_DEVICE)
    cl, cn = chain_id_leaf_const(CHAIN_ID)
    lanes = w.lanes
    ladder = (lanes.table_x, lanes.table_y, lanes.table_t, lanes.bits2, lanes.rx, lanes.ry)
    leaf_blocks = gadgets.bytes_to_blocks(lanes.leaf_bytes, lanes.leaf_len, 1)
    chal_blocks = sha512.bytes_to_blocks512(
        torch.cat([lanes.sig_r, lanes.sig_pubkeys, lanes.messages], 1), lanes.msg_len + 64, 2
    )
    trusted_t = torch.frombuffer(bytearray(trusted), dtype=torch.uint8)
    programs = {
        "sha256_blocks": (lambda: sha256.sha256_blocks(*leaf_blocks), f"{sc.n} lanes x 1 block"),
        "sha512_blocks": (lambda: sha512.sha512_blocks(*chal_blocks), f"{sc.n} lanes x 2 blocks"),
        "straus_verify": (lambda: ed25519.straus_verify(*ladder), f"{sc.n} lanes"),
        "verify_bound": (
            lambda: ed25519.verify_bound(
                *ladder, lanes.sig_r, lanes.sig_s, lanes.sig_pubkeys, lanes.messages, lanes.msg_len, lanes.k_q
            ),
            f"{sc.n} lanes",
        ),
        "skip_verify": (
            lambda: skip_verify(w, trusted_t, 2, 0, 6, 0, cl, cn, SKIP_MAX)[0], f"N={sc.n} skip 2->6"
        ),
    }
    if profile:
        prev, step_inputs = sc.step(4)
        sw = pack_step_witness(step_inputs).to(RUNTIME_DEVICE)
        prev_t = torch.frombuffer(bytearray(prev), dtype=torch.uint8)
        programs["step_verify"] = (lambda: step_verify(sw, prev_t, 4, 0, cl, cn)[0], f"N={sc.n} step 4->5")
    else:
        programs = {"skip_verify": programs["skip_verify"]}
    out, valid = {}, {}
    for name, (fn, shape) in programs.items():
        valid[name], seconds = _card_seconds(fn)
        out[name] = {"shape": shape, "card_seconds": seconds}
        if profile:
            with _OpCount() as count:
                fn()
            out[name]["torch_ops"] = count.ops
    if not all(bool(valid[k]) for k in ("skip_verify", "step_verify") if k in valid):
        raise AssertionError("the N=128 witness programs rejected valid witnesses")
    return out


def _cli_quiet(argv: list[str]) -> tuple[int, str]:
    """tendermintx_tpu_torch.runtime.cli.main(argv) with its stdout captured."""
    import contextlib
    import io

    from tendermintx_tpu_torch.runtime import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _cli_verify_file(path: str, proof_file: dict) -> tuple[int, str]:
    with open(path, "w") as f:
        json.dump(proof_file, f)
    return _cli_quiet(["verify", "--proof", path])


def phase_runtime(
    sc: SkipChain, workdir: str, wrapped_blob: bytes, step_blob: bytes, profile: bool
) -> tuple[dict, dict]:
    """The port's entry points on the card: CLI, prover service, operator;
    with `profile`, the witness programs' torch op counts too."""
    from tendermintx_tpu_torch.circuits.composite import CompositeProof
    from tendermintx_tpu_torch.circuits.proving import verify_leaf_bundle
    from tendermintx_tpu_torch.circuits.skip import encode_skip_input
    from tendermintx_tpu_torch.circuits.step import encode_step_input
    from tendermintx_tpu_torch.runtime.cli import submit_file
    from tendermintx_tpu_torch.runtime.operator import MockContract, OperatorConfig, TendermintXOperator
    from tendermintx_tpu_torch.runtime.service import ProverClient, ProverService

    rt = os.path.join(workdir, "runtime")
    os.makedirs(rt)
    headers = sc.chain.headers
    skip_hex = "0x" + encode_skip_input(2, headers[2].hash(), 6).hex()
    step_hex = "0x" + encode_step_input(4, headers[4].hash()).hex()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    out = {"phase": "runtime", "n_validators": sc.n}

    # 1. cli build + witness-only cli prove of skip 2 -> 6
    build = os.path.join(rt, "build")
    t0 = time.perf_counter()
    rc, _ = _cli_quiet(["build", "--circuit", "skip", "--chain", CHAIN_ID,
                        "--max-validators", str(sc.n), "--out", build])
    t1 = time.perf_counter()
    with open(os.path.join(rt, "input.json"), "w") as f:
        json.dump({"input": skip_hex}, f)
    rc_prove, _ = _cli_quiet(["prove", "--artifact", build, "--input", os.path.join(rt, "input.json"),
                              "--out", os.path.join(rt, "witness.json"),
                              "--fixture-path", sc.fixture_path, "--device", RUNTIME_DEVICE])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with open(os.path.join(rt, "witness.json")) as f:
        witness = json.load(f)
    if rc or rc_prove or witness["valid"] is not True or witness["output"] != "0x" + headers[6].hash().hex():
        raise AssertionError(f"cli build/prove: rc {rc}/{rc_prove}, {witness}")
    out["cli"] = {"build_seconds": t1 - t0, "witness_prove_seconds": t2 - t1, "valid": True, "output_is_header_6": True}
    out["witness_programs"] = _witness_programs(sc, profile)

    # 2. the prover service: prewarm, a wrapped skip and a step request
    svc = ProverService(allowed_fixture_roots=[workdir], device=RUNTIME_DEVICE)
    prewarm_seconds = svc.prewarm()
    svc.start()
    try:
        client = ProverClient(svc.url)
        t0 = time.perf_counter()
        rid = client.submit("skip", CHAIN_ID, skip_hex, max_validators=sc.n,
                            fixture_path=sc.fixture_path, wrap=True)
        wrapped = client.wait(rid, timeout=900, poll=0.2)
        t1 = time.perf_counter()
        rid = client.submit("step", CHAIN_ID, step_hex, max_validators=sc.n, fixture_path=sc.fixture_path)
        step = client.wait(rid, timeout=900, poll=0.2)
        t2 = time.perf_counter()
    finally:
        svc.stop()
    service = {"prewarm_seconds": prewarm_seconds, "wrapped_skip_seconds": t1 - t0, "step_seconds": t2 - t1}
    for name, res, hexin, circuit, blob, header in (
        ("wrapped_skip", wrapped, skip_hex, "skip", wrapped_blob, headers[6].hash()),
        ("step", step, step_hex, "step", step_blob, headers[5].hash()),
    ):
        got = CompositeProof.from_dict(res["proof"]).to_bytes()
        if got != blob:
            raise AssertionError(f"the service's {name} proof differs from the {name} phase's proof")
        if res["output"] != "0x" + header.hex():
            raise AssertionError(f"the service's {name} output is {res['output']}")
        proof_file = submit_file(hexin, circuit, CHAIN_ID, sc.n, res)
        t0 = time.perf_counter()
        rc, said = _cli_verify_file(os.path.join(rt, f"{name}.json"), proof_file)
        t1 = time.perf_counter()
        if rc != 0 or "composite proof: OK" not in said:
            raise AssertionError(f"cli verify of the service's {name} proof: rc {rc}, {said!r}")
        proof_file["composite_proof"]["abi_output"] = "00" * 32
        rc_bad, _ = _cli_verify_file(os.path.join(rt, f"{name}_tampered.json"), proof_file)
        if rc_bad != 1:
            raise AssertionError(f"cli verify accepted a tampered {name} proof (rc {rc_bad})")
        service[f"{name}_proof_bytes"] = len(got)
        service[f"{name}_identical_to_phase"] = True
        service[f"{name}_cli_verify_seconds"] = t1 - t0
    out["service"] = service

    # 3. the operator, prove_stark, one tick on a MockContract: step 6 -> 7
    contract = MockContract(6, headers[6].hash(), skip_max=SKIP_MAX)
    op = TendermintXOperator(
        OperatorConfig(chain_id=CHAIN_ID, max_validators=sc.n, fixture_path=sc.fixture_path,
                       prove_stark=True, device=RUNTIME_DEVICE),
        contract=contract, fetcher=sc.fetcher,
    )
    t0 = time.perf_counter()
    moved = op.tick(chain_tip=7)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, step_inputs = sc.step(6)
    bundle_ok = verify_leaf_bundle(op.last_bundle, step_inputs.next_block_validators)
    t2 = time.perf_counter()
    if moved != ("step", 7) or contract.latest_block() != 7 or contract.header_hash(7) != headers[7].hash():
        raise AssertionError(f"the operator did not move the head to 7: {moved}, {contract.latest_block()}")
    if not bundle_ok:
        raise AssertionError("the operator's leaf STARK bundle failed to verify")
    out["operator"] = {"tick": list(moved), "tick_seconds": t1 - t0, "bundle_verify_seconds": t2 - t1,
                       "head": contract.latest_block(), "leaf_bundle_ok": True}

    launches = _launch_counts()
    _check_launched(launches, "runtime")
    out["launches"] = launches
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out, launches


# shards of the mesh phase: on a one-card host all four live on cuda:0
MESH_SHARDS = 4


def _mesh_devices() -> list:
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(MESH_SHARDS)]


def _timed_pair(sharded, single) -> tuple[dict, object, object]:
    """Both functions' results and ms (CUDA events, after a warm-up)."""
    got, want = sharded(), single()
    return {"ms": _time_ms(sharded, 3), "single_ms": _time_ms(single, 3)}, got, want


def phase_mesh(sc: SkipChain, warm_proof, parity: dict) -> tuple[dict, dict]:
    """The port's multi-device proving on a MESH_SHARDS-shard lane mesh:
    the N=128 skip 2 -> 6 proven with mesh= (bytes equal to the slice
    phase's warm proof, verified), the sharded lane checks over its 128
    lanes (equal to single-device verify_bound, hash_validator_leaves and
    exact Python-int sums), the card's N=4 parity proof wrapped with mesh=
    (bytes equal to its single-device wrap), the sharded Poseidon batch at
    2^20 states and the four-step NTT at 2^20 (each equal to its
    single-device function), and dryrun_multichip in each shape. The N=128
    prove must launch the column sponge once per shard for each
    column-major tree; its launch counts, read right after it, are the
    mesh path's."""
    from tendermintx_tpu_torch import graft_entry
    from tendermintx_tpu_torch.circuits import gadgets as g
    from tendermintx_tpu_torch.circuits.composite import (
        DEFAULT_COMPOSITE_CONFIG,
        CompositeProof,
        prove_skip_composite,
        verify_skip_composite,
        wrap_composite,
    )
    from tendermintx_tpu_torch.circuits.variables import pack_validator_lanes
    from tendermintx_tpu_torch.ops import ed25519, ntt as nttmod, poseidon as ps
    from tendermintx_tpu_torch.ops.goldilocks import GF
    from tendermintx_tpu_torch.parallel import prover as shp
    from tendermintx_tpu_torch.parallel.sharding import (
        make_lane_mesh,
        sharded_lane_checks,
        sharded_poseidon_throughput,
    )

    devices = _mesh_devices()
    mesh = make_lane_mesh(MESH_SHARDS, devices)
    dev = mesh.first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    out = {"phase": "mesh", "n_validators": sc.n, "shards": MESH_SHARDS,
           "devices": [str(d) for d in devices], "cards": torch.cuda.device_count()}

    # 1. N=128 skip 2 -> 6 with mesh=, at full width; the path's launch
    #    counts are this prove's alone
    trusted, target, inputs = sc.skip(2, 6)
    with _PhaseLog() as phases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prove_skip_composite(2, trusted, 6, inputs, DEFAULT_COMPOSITE_CONFIG, mesh=mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = _launch_counts()
    _check_launched(launches, "mesh")
    prove_peak = torch.cuda.max_memory_allocated()
    sponges = launches["poseidon_sponge_cols"]
    blob = proof.to_bytes()
    if blob != warm_proof.to_bytes():
        raise AssertionError("the N=128 mesh proof differs from the slice phase's warm proof")
    t2 = time.perf_counter()
    result = verify_skip_composite(CompositeProof.from_bytes(blob), CHAIN_ID, SKIP_MAX)
    t3 = time.perf_counter()
    if result != (2, trusted, 6, target):
        raise AssertionError(f"the N=128 mesh proof failed to verify: {result!r}")
    trees = sum(2 + (st.aux_cap is not None) for st in proof.batch.statements)
    if sponges != MESH_SHARDS * trees:
        raise AssertionError(
            f"the mesh prove commits {trees} column-major trees over {MESH_SHARDS} shards "
            f"with {sponges} sponge launches"
        )
    out["skip"] = {
        "skip": [2, 6], "prove_seconds": t1 - t0, "verify_seconds": t3 - t2,
        "seconds": (t1 - t0) + (t3 - t2), "proof_bytes": len(blob), "identical_to_slice": True,
        "sponge_launches": sponges, "column_trees": trees, "max_memory_allocated": prove_peak,
        "phases": phases.lines,
    }
    del proof

    # 2. the sharded lane checks over the N=128 skip's 128 lanes
    lanes = inputs.target_block_validators
    lv = pack_validator_lanes(lanes).to(dev)
    args = (lv.table_x, lv.table_y, lv.table_t, lv.bits2, lv.rx, lv.ry, lv.sig_r, lv.sig_s,
            lv.sig_pubkeys, lv.messages, lv.msg_len, lv.k_q, lv.leaf_bytes, lv.leaf_len,
            lv.vp_lo, lv.vp_hi, lv.signed, lv.enabled)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sig_ok, digests, signed, total = sharded_lane_checks(mesh)(*args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    flags = ed25519.verify_bound(*args[:12])
    power = lambda pair: int(pair[0]) | (int(pair[1]) << 32)
    want_total = sum(l.voting_power for l in lanes if l.enabled)
    want_signed = sum(l.voting_power for l in lanes if l.enabled and l.signed)
    if not (bool(sig_ok) and bool(flags.all())):
        raise AssertionError("the N=128 lane signatures do not all verify")
    if not torch.equal(digests, g.hash_validator_leaves(lv.leaf_bytes, lv.leaf_len)):
        raise AssertionError("the sharded leaf digests differ from hash_validator_leaves")
    if (power(total), power(signed)) != (want_total, want_signed):
        raise AssertionError(f"sharded voting sums {power(total)}, {power(signed)} != {want_total}, {want_signed}")
    out["lane_checks"] = {"lanes": len(lanes), "seconds": t1 - t0, "identical": True,
                          "total_power": want_total, "signed_power": want_signed}

    # 3. the card's N=4 parity proof wrapped with mesh= at the parity's wrap config
    cfg, wrap_cfg = _parity_configs()
    n4_blob, n4_wrapped = parity["cuda"]
    t0 = time.perf_counter()
    wrapped = wrap_composite(CompositeProof.from_bytes(n4_blob), cfg, wrap_cfg, mesh=mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if wrapped.to_bytes() != n4_wrapped:
        raise AssertionError("the N=4 mesh wrap differs from the card's single-device wrap")
    out["n4_wrap"] = {"seconds": t1 - t0, "identical": True, "wrapped_proof_bytes": len(n4_wrapped)}

    # 4. sharded Poseidon batch and the four-step NTT at 2^20, each against
    #    its single-device function
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    states = _random_cols((1 << 20, ps.WIDTH), gen, dev)
    pos = sharded_poseidon_throughput(mesh)
    times, got, want = _timed_pair(lambda: pos(GF(states)).v, lambda: ps.permute_tensor(states))
    _check_equal(got, want, "sharded Poseidon batch")
    out["poseidon"] = {"states": 1 << 20, "identical": True, **times}
    log_n = 20
    coeffs = _random_cols((1, 1 << log_n), gen, dev)[0]
    ntt_fn = shp.sharded_ntt_fn(mesh, log_n)

    def sharded_ntt():
        return mesh.gather([b.v for b in ntt_fn([GF(b) for b in mesh.split(coeffs)])])

    times, got, want = _timed_pair(sharded_ntt, lambda: nttmod.ntt(GF(coeffs)).v)
    _check_equal(got, want, "four-step NTT")
    out["ntt"] = {"log_n": log_n, "identical": True, **times}
    del states, coeffs, got, want

    # 5. the dry run, in each of its shapes
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(MESH_SHARDS, devices)
    out["dryrun_seconds"] = time.perf_counter() - t0
    for shape in ("toy", "full"):
        t0 = time.perf_counter()
        graft_entry.dryrun_multichip(MESH_SHARDS, devices, shape=shape)
        out[f"dryrun_{shape}_seconds"] = time.perf_counter() - t0

    out["launches"] = launches
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out, launches


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
    for name in PHASE_LOGGERS:
        logging.getLogger(name).setLevel(logging.INFO)
    card = phase_device()["nvidia_smi"]
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        parity = parity_start(workdir)
        try:
            rows = phase_kernels()
            n128 = SkipChain(128, os.path.join(workdir, "n128"))
            _, cold_launches, warm_launches, warm_proof = phase_slice(n128)
            _, step_launches, step_blob = phase_step(n128)
            _, hashes_launches = phase_hashes(n128, parity, card)
            profile = "--profile" in argv
            wrap, wrap_launches, wrapped_blob = phase_wrap(n128, warm_proof, profile)
            _, runtime_launches = phase_runtime(n128, workdir, wrapped_blob, step_blob, profile)
            _, mesh_launches = phase_mesh(n128, warm_proof, parity)
            phase_parity(parity)  # before the profile, which the CPU jobs would disturb
            if profile:
                phase_profile(n128, wrapped_blob, wrap["wrap_rows"])
        finally:
            for job in parity["jobs"].values():
                job.stop()
    kept = ("route", "source", "replaces", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_share", "library_ms")
    kernels = [
        {"name": name, **{k: row[k] for k in kept},
         "launches": cold_launches[name] + warm_launches[name],
         "launches_by_path": {"skip_cold": cold_launches[name], "skip_warm": warm_launches[name],
                              "step": step_launches[name], "hashes": hashes_launches[name],
                              "wrap": wrap_launches[name],
                              "runtime": runtime_launches[name], "mesh": mesh_launches[name]}}
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
