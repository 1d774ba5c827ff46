"""End-to-end smoke run of tendermintx_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line; any failure raises (non-zero exit):

  1. device    - requires CUDA; prints the card's name and power limit;
  2. build     - compiles every hand-written kernel from csrc/ with nvcc
                 (poseidon.cu, quotient.cu, ntt.cu, deep.cu, ood.cu,
                 logup.cu, fri.cu, sha.cu, ed25519.cu; one nvcc per
                 source, all started together); the
                 line gives each kernel
                 function's registers and spill bytes from ptxas (-v); a
                 spill fails;
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
                 of the kernel's own dense count beside it); then the
                 quotient tape kernel (stark/quotient_tape.py,
                 csrc/quotient.cu) for each AIR of the N=128 paths
                 (Ed25519, SHA-256, SHA-512, WrapAir, EvalAir) and
                 PoseidonChainAir: one launch over the statement's whole
                 one-device shard, the frame read from the LDE row blocks,
                 exact against the plain twin (the same tape as torch ops)
                 on the whole output, and one over the row block of
                 stark/prover.py::_quotient_blocks, exact
                 against the DeviceAlgebra evaluation of the gathered
                 frame; each with its time, the plain versions', its bound
                 (each input byte once at 3.35 TB/s, or 4 32-bit
                 multiply-adds per field multiply; beside it the bound
                 that counts every frame offset's copy of the columns), the launch shape (rows a block, shared bytes,
                 blocks per SM), value slots and operand reads by mode;
                 then the NTT kernel (ops/ntt.py, csrc/ntt.cu): each entry
                 (forward, inverse, the coset iNTT's inverse with its
                 power table, coset LDE) at every transform of the N=128
                 paths (each AIR's trace, aux, public-column and chunk
                 LDE and quotient iNTT, on one card and per mesh shard;
                 the step's and the hash bundles' SHA-256 plans; the
                 four-step NTT's rows; 1- and 2-point rows), exact against
                 its plain version on the whole output, the kernel timed
                 at every one of those shapes with its bound and its
                 plan's pass kernels (``shapes``), the plain version at
                 the Ed25519 trace; the kernels line sums the warm skip's
                 transforms over those times (``warm_skip``: kernel ms,
                 bound ms, pass kernels); and the DEEP kernel (csrc/deep.cu) at each
                 AIR's one-device shard, exact against
                 deep_composition_plain; each with its time, the plain
                 version's and its bound (bytes at 3.35 TB/s or 4
                 multiply-adds a field multiply); then csrc/ood.cu's three
                 entries (ext_powers at the opening points and at alpha,
                 ood_eval over the trace and aux rows at every point and
                 the chunk rows at z, deep_inverses over the LDE domain)
                 at every statement shape of the N=128 paths, and csrc/logup.cu's
                 two (logup_terms, logup_scan) at the Ed25519 statement and
                 at synthetic shapes with pad > 0 and several table
                 columns, each exact against its plain version on the
                 whole output, with its time (the median of five rounds,
                 the fastest and slowest beside it), the plain version's
                 and its bound (the function's least work: the DEEP and
                 LogUp inverses counted as a batch inversion, the chunk
                 rows at z alone); ext_powers, deep_inverses and
                 logup_scan also with their time a launch from a burst
                 of raw launches (``burst_ms``: no Python wrapper between
                 them), deep_inverses also checked with an opening point
                 planted on the domain (0 in that column alone); then
                 csrc/fri.cu's two entries at every fold and injection
                 call the N=128 paths make, derived from their configs
                 and statement shapes (_fri_paths, _fri_plan: the skip,
                 step and mesh composites, the two hash bundles, the
                 wrap, the operator's leaf bundle; fri_inject with 1, 2
                 and 3 codewords), exact against their plain versions
                 (the fold's over the (2x)^-1 host table); each fold
                 launch shape and each injection with ms over input sets
                 that exceed twice the L2 together (``l2_cold``),
                 burst_ms, plain ms and the bytes bound;
  4b. witness - the witness programs' kernels (csrc/sha.cu's SHA-256,
                 validator tree, header proofs, SHA-512 and the SHA-512
                 challenge, csrc/ed25519.cu's Straus ladder and witness
                 binding): skip_verify (2 -> 6) and step_verify (4 -> 5) at
                 N=128 with every call of the wrappers held exactly against
                 its plain twin on its own data (every shape these paths
                 give them; the calls and the tree and proof shapes those
                 of circuits/verify.py's structure: no sha256_blocks, which
                 is checked and timed at a mesh lane-check shard, and no
                 sha512_blocks, checked and timed at the challenge's
                 blocks), the challenge on random bytes at 1, 7, 33 and 129
                 lanes with msg_len at 0, 1, 47, 48, W - 1 and W and
                 outside [0, W] (clamped as the twin clamps it), at message
                 widths 0, 124 and 300, the SHA entries on random words at 1, 7
                 and 129 lanes of 1 and 2 blocks with n_active -1, 0, 1,
                 n_blocks and above, validator trees of 1, 5, 100 and 128
                 lanes at n_enabled 0, 1, odd, even and B, header proofs of
                 1, 5 and 33 with both path bits, the ladder and the binding on
                 lanes with both outcomes (tampered bytes, witness-only
                 tampering, a non-canonical witness, selectors outside 0..3,
                 and for the binding limbs of 8192 and -1); each timed at its
                 N=128 shapes (median of five rounds) beside its plain twin
                 and its bound (32-bit operations at 64 a clock per SM or
                 bytes at 3.35 TB/s), the ladder's dependent-chain floor
                 beside (253 steps of a step's critical path), the binding's
                 (its longest chain of field products), and the tree's,
                 the proofs' and the challenge's (their dependent
                 compressions); no prove runs
                 these kernels (every path below but runtime checks none
                 launched);
  5. slice     - the N=128 skip composite at DEFAULT_COMPOSITE_CONFIG,
                 proven on the card and verified by the port's verifier,
                 twice in one process as bench.py times the JAX package:
                 skip 1 -> 5 first (``skip_composite_n128_cold_seconds``,
                 host tables cold), then 2 -> 6 (``skip_composite_n128_seconds``,
                 warm); each is prove + verify. Every kernel must have been
                 launched by each of the two proves (the NTT's forward
                 entry excepted: only the mesh phase's four-step NTT
                 runs it), each NTT entry exactly the pass kernels
                 ntt_plan gives the transforms the path asked of it (so on
                 every path below), the quotient and the DEEP kernel once per
                 statement, ood_eval's two kernels, deep_inverses once
                 and ext_powers twice per statement (on every path below; the LogUp
                 terms kernel once and the scan's two kernels per Ed25519
                 statement, none in the hash bundles and the wrap), the
                 FRI fold once a committed FRI layer (on the mesh once a
                 shard) and the injection once a codeword size of the
                 batch (so on every path below; none in the hash
                 bundles' single-statement FRI), the warm prove's column sponge once per
                 column-major tree, and the warm proof's
                 statements must be the quotient check's. The per-statement
                 phase seconds that ``stark/batch.py`` logs are in the line
                 under ``phases``;
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
                 and the line times the ranges around its round-state and
                 EvalAir kernels (expand_perm_states, eval_aux: the
                 reference's programs that were plain torch before). The
                 wrap launches EvalAir's aux kernel once and the
                 round-state kernel once; no other path but runtime
                 launches them;
  8b. wrap_kernels - csrc/logup.cu's eval_aux (the four terms and their
                 running sum in one launch) and csrc/poseidon.cu's
                 poseidon_expand (one thread a state) on the inputs the
                 wraps gave them (the latest call of each shape), exact
                 against their plain twins on the whole outputs, eval_aux
                 also at a ragged row count and with two planted zero
                 denominators at the N=128 wrap's shape; at the N=128
                 wrap's shapes (EvalAir 2^17 rows, WrapAir 2^15 states)
                 timed beside the twins, with bounds and registers;
  9. runtime   - the port's entry points on the card at N=128, in this
                 process: ``cli build`` and a witness-only ``cli prove`` of
                 skip 2 -> 6 (valid, header 6), its witness kernels'
                 launches exactly those of skip_verify's structure (two
                 validator trees, one header-proof batch, one SHA-512
                 challenge, binding and ladder, no sha256_blocks or
                 sha512_blocks, at N=128: the
                 kernels line's ``launches`` of these); skip_verify
                 timed on the card, its launches held the same way (with
                 --profile also sha256_blocks, sha512_blocks,
                 sha512_challenge, straus_verify, verify_bound and
                 step_verify, and each
                 one's torch op count: the launches of eager torch); a
                 ProverService on
                 the card that prewarms and answers a wrapped skip 2 -> 6
                 and a step 4 -> 5 request through ProverClient, each
                 proof byte-identical to the wrap and step phases' and
                 accepted by ``cli verify`` (a tampered abi_output exits
                 1); an operator with prove_stark on a MockContract for
                 one tick (the head moves, the leaf STARK verifies); peak
                 memory and Poseidon launches; the tick's witness kernels
                 exactly a step_verify's; the FRI's launches exactly
                 the prewarm's (counted around it), the warm skip, wrap
                 and step paths' and one fold a layer of the leaf bundle;
 10. mesh      - multi-device proving on a 4-shard lane mesh
                 ([cuda:i % cards for i in range(4)]: all four on cuda:0 on
                 a one-card host): the N=128 skip 2 -> 6 at
                 DEFAULT_COMPOSITE_CONFIG with mesh= (bytes equal to the
                 slice phase's warm proof, verified; prove and verify
                 seconds, peak memory; the quotient and the DEEP kernel
                 once per shard per statement, the column sponge once per shard for each
                 column-major tree), sharded_lane_checks over
                 its 128 lanes (sha256_blocks, the SHA-512 challenge,
                 binding and ladder once a shard, no tree, proof or
                 sha512_blocks: sha256_blocks's
                 ``launches`` in the kernels line; equal
                 to single-device verify_bound,
                 hash_validator_leaves and Python-int sums), the card's N=4
                 parity proof wrapped with mesh= (equal to its single-device
                 wrap), the sharded Poseidon batch at 2^20 states and the
                 four-step NTT at 2^20 (each equal to its single-device
                 function, both timed; the four-step also equal to the
                 plain NTT, and the forward NTT kernel's launches of one
                 four-step run alone held to its shards' pass plans), and
                 dryrun_multichip(4) in each
                 of its shapes (default, toy, full), each timed;
 10b. grind    - csrc/poseidon.cu's grinding kernel on every span that
                 every path's FRIs searched (one launch a span of
                 GRIND_SPAN, checked on every path against its FRI proofs'
                 nonces), again against grind_plain over the same span on
                 the card and check_grind, then a seed whose first 20-bit
                 hit lies past 2^18 candidates (several waves of resident
                 threads), one launch; timed at the run's first 16-bit
                 search, beside grind_plain, with the bound of its least
                 work (nonce + 1 permutations) and of the span;
 11. fri_shapes - every fold and injection shape the run called
                 csrc/fri.cu's wrappers with (_FriCalls) that the kernels
                 phase did not check (the N=4 proofs': the parity prove,
                 the service's prewarm, the mesh's N=4 wrap), held
                 exactly against its plain version, so that every shape
                 a path launched was checked;
 12. profile   - only with --profile: one more warm prove under
                 torch.profiler (device time by kernel, Poseidon's and the
                 copies' totals, the card's busy share of the wall time)
                 and one under cProfile (the host
                 functions with the most cumulative time), the wrapped
                 verify under cProfile, and the cold build of the wrap
                 FRI's host fold tables alone (the plain fold's, and the
                 host constants the card's fold takes instead).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import itertools
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
# the device of the witness and runtime phases' entry points (the card; a
# CPU rehearsal of the phases' control flow may set "cpu")
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


# every csrc/<name>.cu the port launches
KERNEL_LIBRARIES = ("poseidon", "quotient", "ntt", "deep", "ood", "logup", "fri", "sha", "ed25519")


def phase_build() -> dict:
    """Build every kernel library; the line gives each kernel function's
    registers and spill bytes as ptxas reported them. Spills fail."""
    from concurrent.futures import ThreadPoolExecutor

    from tendermintx_tpu_torch.ops import cuda_build

    def timed_build(name: str) -> tuple[str, float]:
        t0 = time.perf_counter()
        path = cuda_build.build(name)
        return path, time.perf_counter() - t0

    out = {"phase": "build"}
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNEL_LIBRARIES)) as pool:
        built = dict(zip(KERNEL_LIBRARIES, pool.map(timed_build, KERNEL_LIBRARIES)))
    out["seconds"] = time.perf_counter() - t0
    for name in KERNEL_LIBRARIES:
        path, seconds = built[name]
        cuda_build.load_library(name)
        report = cuda_build.ptxas_report(name)
        out[name] = {
            "seconds": seconds,
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


def _time_rounds(fn, reps: int, rounds: int = 5) -> dict:
    """_time_ms over `rounds` rounds: the median round as ms, the fastest
    and the slowest beside it."""
    t = sorted(_time_ms(fn, reps) for _ in range(rounds))
    return {"ms": t[len(t) // 2], "ms_min": t[0], "ms_max": t[-1]}


def _launch_burst_ms(module, launch: str, library: str, call, reps: int = 200) -> float:
    """ms a launch of the kernel entry that `call` reaches through
    `module`'s ctypes launcher (`launch`, over the library `library`
    loads): CUDA events around `reps` back-to-back calls of the C entry
    with the arguments the wrapper built, inside its call (its scratch
    alive), with no wrapper in between: the kernels' time a launch, gaps
    included, or the C entry's host cost where that is longer, for
    kernels shorter than their Python wrapper."""
    import ctypes

    original = getattr(module, launch)
    times = []

    def burst(fn, args, dev):
        original(fn, args, dev)  # the wrapper's own launch, and a warm-up
        entry = getattr(getattr(module, library)(), fn)
        stream = torch.cuda.current_stream(dev).cuda_stream
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        errs = [entry(ctypes.byref(args), stream) for _ in range(reps)]
        end.record()
        torch.cuda.synchronize()
        if any(errs):
            raise RuntimeError(f"{fn} launch failed: CUDA error {max(errs)}")
        times.append(start.elapsed_time(end) / reps)

    setattr(module, launch, burst)
    try:
        call()
    finally:
        setattr(module, launch, original)
    return times[0]


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


# The 7-bit MDS products of that form: the dense layer of the 8 full rounds
# and the one 7-bit product of each partial round. The round-state and
# grinding kernels run their MDS sums on the FP64 pipe, 64 DFMAs a clock
# per SM beside the integer pipe's 64 (the same guide table), so their
# bound takes these products on that pipe and the rest on the integer one,
# and the busier of the two.
MDS_PRODUCTS_PER_PERMUTATION = 8 * 144 * 2 + 22 * 2  # 2,348
DESIGN_MDS_PRODUCTS_PER_PERMUTATION = 30 * 144 * 2  # 8,640


# WrapAir's round states stop after round 28: the last full round is not run
EXPAND_MULS_PER_STATE = MULS_PER_PERMUTATION - FULL_ROUND_MULS  # 6,176
DESIGN_EXPAND_MULS_PER_STATE = DESIGN_MULS_PER_PERMUTATION - FULL_ROUND_MULS  # 10,048
EXPAND_MDS_PRODUCTS_PER_STATE = MDS_PRODUCTS_PER_PERMUTATION - 144 * 2  # 2,060
DESIGN_EXPAND_MDS_PRODUCTS_PER_STATE = DESIGN_MDS_PRODUCTS_PER_PERMUTATION - 144 * 2  # 8,352


def _bound(permutations: int, nbytes: int, clock_mhz: float, muls: int = MULS_PER_PERMUTATION,
           design_muls: int = DESIGN_MULS_PER_PERMUTATION, fp64: int = 0, design_fp64: int = 0) -> dict:
    """The bound of `permutations` states at `muls` multiply-adds each
    (`design_muls` for design_bound_ms) moving `nbytes`; `fp64` (and
    `design_fp64`) of those multiply-adds are MDS products on the FP64
    pipe, the rest on the integer pipe, and the busier pipe bounds."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    muls_per_ms = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3
    integer_ms = permutations * (muls - fp64) / muls_per_ms
    fp64_ms = permutations * fp64 / muls_per_ms
    ops_ms = max(integer_ms, fp64_ms)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    design_ms = permutations * max(design_muls - design_fp64, design_fp64) / muls_per_ms
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "operations_bound_ms": ops_ms,
        "integer_bound_ms": integer_ms,
        "fp64_bound_ms": fp64_ms,
        "bytes_bound_ms": bytes_ms,
        "design_bound_ms": max(design_ms, bytes_ms),
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


# The statements of the N=128 paths, as the composite builds them for
# TestChain(128): skip 2 -> 6 proves a SHA-256 plan of 1,024 segments
# (65,536 rows), 128 Ed25519 lanes and 256 SHA-512 blocks (32,768 rows);
# phase_slice checks the warm proof's statements against these counts.
N128_SKIP_STATEMENTS = {"sha256": 1024, "ed25519": 128, "sha512": 256}
# rows of the PoseidonChainAir statement checked here: it is proven by the
# port's tests and no N=128 path, so a chain of 512 permutations (2^14
# rows at rate 3) stands for a real size
POSEIDON_CHAIN_ROWS = 1 << 14


def _quotient_airs() -> list[tuple[str, object, int, int]]:
    """(name, AIR, LDE rows, rate bits) of every AIR whose quotient the
    N=128 paths evaluate: the skip composite's three statements at
    DEFAULT_COMPOSITE_CONFIG, the wrap's WrapAir and EvalAir at
    default_wrap_config(), and PoseidonChainAir."""
    from tendermintx_tpu_torch.circuits.composite import DEFAULT_COMPOSITE_CONFIG
    from tendermintx_tpu_torch.stark import ed25519_air, sha256_air, sha512_air
    from tendermintx_tpu_torch.stark.evalair import EvalAir, tape_for
    from tendermintx_tpu_torch.stark.poseidon_air import PoseidonChainAir
    from tendermintx_tpu_torch.stark.recursion import WrapAir, default_wrap_config, wrap_n_rows, wrap_shape

    n = N128_SKIP_STATEMENTS
    mods = (sha256_air, ed25519_air, sha512_air)
    composite = [sha256_air.Sha256Air(n["sha256"]), ed25519_air.Ed25519Air(n["ed25519"]),
                 sha512_air.Sha512Air(n["sha512"])]
    rows = [m.SEGMENT * n[k] for m, k in zip(mods, ("sha256", "ed25519", "sha512"))]
    rate = DEFAULT_COMPOSITE_CONFIG.rate_bits
    shape = wrap_shape(composite, DEFAULT_COMPOSITE_CONFIG, rows)
    tape = tape_for(composite)
    wrate = default_wrap_config().rate_bits
    return [
        ("ed25519", composite[1], rows[1] << rate, rate),
        ("sha256", composite[0], rows[0] << rate, rate),
        ("sha512", composite[2], rows[2] << rate, rate),
        ("wrap", WrapAir(shape), wrap_n_rows(shape) << wrate, wrate),
        ("evalair", EvalAir(tape), tape.n_rows << wrate, wrate),
        ("poseidon_chain", PoseidonChainAir(), POSEIDON_CHAIN_ROWS << rate, rate),
    ]


def _random_felts(shape, gen, dev) -> torch.Tensor:
    """Canonical felts over the whole field, made on the card from a
    seeded generator, the edge values first."""
    from tendermintx_tpu_torch.ops import goldilocks as gl

    x = torch.randint(0, 2**63 - 1, shape, dtype=torch.int64, device=dev, generator=gen)
    x.mul_(2).add_(torch.randint(0, 2, shape, dtype=torch.int64, device=dev, generator=gen))
    x = gl._canon(x)
    flat = x.view(-1)
    k = min(len(EDGES), flat.numel())
    flat[:k] = gl.tensor_from_u64(np.array(EDGES[:k], dtype=np.uint64), dev)
    return x


def _quotient_inputs(air, N: int, gen, dev) -> tuple:
    """Random inputs of one statement's quotient made on the card: the
    whole LDE (columns, N), and the row inputs (alpha powers, publics,
    whole periodic, public and zerofier columns, challenges)."""
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.ops.goldilocks import GF

    vec = lambda k: GF(_random_felts((k,), gen, dev))
    K = air.n_constraints
    lde = _random_felts((air.n_cols + air.n_aux_cols, N), gen, dev)
    return lde, (
        GF2(vec(K), vec(K)),
        vec(air.n_public),
        tuple(vec(N) for _ in air.periodic_columns()),
        tuple(vec(N) for _ in range(air.n_public_cols)),
        tuple(vec(N) for _ in range(4)),
        vec(2 * air.n_challenges),
    )


def _quotient_bound(qt, rows: int, lde_rows: int, blowup: int, muls_per_ms: float) -> dict:
    """The least time for the quotient of `rows` LDE rows under the
    guide's rule: each input byte read once (the LDE columns over the
    rows and the halo past them, at most the whole LDE: the frame's
    offsets re-read the same columns a few rows apart; the row inputs;
    publics, challenges and alpha powers) and the output written once, at
    3.35 TB/s; or 4 32-bit multiply-adds per field multiply at the card's
    integer rate, whichever is longer. Beside it (``per_offset_*``) the
    bound of the gathered frame, which counts every offset's copy of the
    columns."""
    small = qt.n_public + qt.n_chal + 2 * qt.n_roots
    lde = qt.n_total * min(lde_rows, rows + max(qt.offsets) * blowup)
    nbytes = 8 * (lde + (qt.n_rowvecs + 2) * rows + small)
    per_offset = 8 * ((qt.n_offsets * qt.n_total + qt.n_rowvecs + 2) * rows + small)
    ops_ms = 4 * qt.counts()["muls"] * rows / muls_per_ms
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    per_offset_ms = per_offset / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "operations_bound_ms": ops_ms,
        "bytes_bound_ms": bytes_ms,
        "bytes": nbytes,
        "per_offset_bytes": per_offset,
        "per_offset_bytes_bound_ms": per_offset_ms,
        "per_offset_bound_ms": max(ops_ms, per_offset_ms),
    }


def _kernel_quotient(dev, clock_mhz: float, ptxas: dict) -> dict:
    """The tape kernel, per AIR of the N=128 paths at its main-path
    launch shape: one launch over the whole one-device shard (the LDE
    row blocks of the statement, the halo its own leading rows), held
    exactly against the plain twin (execute_plain, the same instructions
    as torch ops) on the whole output; and over the CPU path's row block
    (stark/prover.py::_quotient_blocks), held exactly against the
    DeviceAlgebra evaluation of the gathered frame. Each with its time,
    the plain versions', the bound of each shape, the launch shape
    (rows a block, shared bytes, blocks per SM), slots and operand reads.
    The row's own numbers are the Ed25519 shard's, the widest."""
    from tendermintx_tpu_torch.ops.goldilocks import GF
    from tendermintx_tpu_torch.parallel.prover import lde_shards_fn
    from tendermintx_tpu_torch.parallel.sharding import LaneMesh
    from tendermintx_tpu_torch.stark import quotient_tape as qtm
    from tendermintx_tpu_torch.stark.prover import _eval_quotient_plain, _quotient_blocks

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    muls_per_ms = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    airs = {}
    for name, air, N, rate in _quotient_airs():
        n_off, n_total = len(air.frame_offsets), air.n_cols + air.n_aux_cols
        log_n = N.bit_length() - 1 - rate
        B = N // _quotient_blocks(n_off, n_total, N)
        t0 = time.perf_counter()
        qt = qtm.quotient_tape(air)
        record_s = time.perf_counter() - t0
        shape = qtm.launch_shape(qt.row_words, qt.n_uniform)
        lde, vecs = _quotient_inputs(air, N, gen, dev)
        trace = GF(lde[: air.n_cols])
        aux = GF(lde[air.n_cols :]) if air.n_aux_cols else None
        (shard,) = lde_shards_fn(LaneMesh([dev]), air, log_n, rate)([trace], None if aux is None else [aux])
        got, first_ms = _timed_once(lambda: qtm.quotient_cuda(air, shard, *vecs))
        twin, twin_ms = _timed_once(lambda: qtm.execute_plain(qt, shard, *vecs))
        err = max(_max_abs_err(got.c0.v, twin.c0.v), _max_abs_err(got.c1.v, twin.c1.v))
        if err:
            raise AssertionError(f"quotient kernel of {name} over its {N}-row shard disagrees with "
                                 f"its plain twin: max_abs_err {err}")
        del twin
        # the CPU path's row block: the kernel over rows [0, B) against DeviceAlgebra
        stacked = qtm.gather_frame(shard, air.frame_offsets, 0, B)
        cut = lambda group: tuple(GF(v.v[:B]) for v in group)
        alpha, pub, periodic, public_cols, zinvs, chal = vecs
        want, plain_ms = _timed_once(lambda: _eval_quotient_plain(
            air, stacked, alpha, pub, cut(periodic), cut(public_cols), cut(zinvs), chal, B))
        del stacked
        err = max(_max_abs_err(got.c0.v[:B], want.c0.v), _max_abs_err(got.c1.v[:B], want.c1.v))
        if err:
            raise AssertionError(f"quotient kernel of {name} over rows [0, {B}) disagrees with the "
                                 f"DeviceAlgebra evaluation: max_abs_err {err}")
        del want, got
        reps = max(2, min(50, int(1000 / max(first_ms, 1e-3))))
        ms = _time_ms(lambda: qtm.quotient_cuda(air, shard, *vecs), reps)
        block_ms = _time_ms(lambda: qtm.quotient_cuda(air, shard, *vecs, (0, B)), reps)
        counts = qt.counts()
        airs[name] = {
            "lde": [n_total, N],
            "frame_offsets": list(air.frame_offsets),
            "blowup": 1 << rate,
            "block_rows": B,
            "record_seconds": record_s,
            **counts,
            "threads": shape["threads"],
            "shared_bytes": shape["shared_bytes"],
            "blocks_per_sm": qtm.blocks_per_sm(shape["threads"], shape["shared_bytes"]),
            "max_abs_err": 0.0,
            "ms": ms,
            "plain_ms": twin_ms,
            "bound": _quotient_bound(qt, N, N, 1 << rate, muls_per_ms),
            "block_ms": block_ms,
            "block_plain_ms": plain_ms,
            "block_bound": _quotient_bound(qt, B, N, 1 << rate, muls_per_ms),
        }
        for k in ("ms", "block_ms"):
            b = airs[name]["bound" if k == "ms" else "block_bound"]
            airs[name][k.replace("ms", "bound_share")] = b["bound_ms"] / airs[name][k]
        del lde, trace, aux, shard, vecs
    top = airs["ed25519"]
    regs = ptxas.get("tmx_quotient_kernel", {})
    return {
        "route": "cuda",
        "source": "tendermintx_tpu_torch/csrc/quotient.cu",
        "replaces": "tendermintx_tpu/stark/prover.py:293",
        "replaces_program": "tendermintx_tpu/stark/prover.py:379 (_eval_quotient_core, jax.jit at :363-364)",
        "shape": top["lde"],
        "max_abs_err": 0.0,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        **{k: top["bound"][k] for k in ("bound_ms", "bound_by", "operations_bound_ms", "bytes_bound_ms",
                                        "bytes", "per_offset_bytes_bound_ms")},
        "library_ms": None,
        "registers": regs.get("registers"),
        "spill_bytes": (regs.get("spill_stores") or 0) + (regs.get("spill_loads") or 0),
        "airs": airs,
    }


def _ntt_shapes() -> list[tuple[str, str, int, int, int]]:
    """(use, entry, rows, log2 n, rate bits) of every transform of the
    N=128 paths, each once: per AIR of _quotient_airs() its trace, aux and
    public-column iNTT and LDE, the quotient's coset iNTT (2 rows of N)
    and the chunk LDE, and its column blocks on the mesh phase's
    MESH_SHARDS shards; the SHA-256 plan of the step and of the two hash
    bundles (DEFAULT_HASH_CONFIG); the mesh phase's four-step NTT at 2^20
    (rows of 4, one row of 2^18); and 1- and 2-point rows."""
    from tendermintx_tpu_torch.circuits.hashing import DEFAULT_HASH_CONFIG
    from tendermintx_tpu_torch.stark import sha256_air

    out = []

    def lde(use, rows, log_n, rate):
        out.extend([(use, "intt", rows, log_n, 0), (use, "coset_lde", rows, log_n, rate)])

    for name, air, N, rate in _quotient_airs():
        log_n = N.bit_length() - 1 - rate
        lde(f"{name} trace", air.n_cols, log_n, rate)
        lde(f"{name} trace, mesh shard", -(-air.n_cols // MESH_SHARDS), log_n, rate)
        if air.n_aux_cols:
            lde(f"{name} aux", air.n_aux_cols, log_n, rate)
            lde(f"{name} aux, mesh shard", -(-air.n_aux_cols // MESH_SHARDS), log_n, rate)
        if air.n_public_cols:
            lde(f"{name} public columns", air.n_public_cols, log_n, rate)
        out.append((f"{name} quotient", "coset_intt", 2, log_n + rate, 0))
        out.append((f"{name} chunks", "coset_lde", 2 * (air.constraint_degree - 1), log_n, rate))
    sha = sha256_air.Sha256Air(N128_SKIP_STATEMENTS["sha256"]).n_cols
    lde("sha256 step", sha, 15, 3)
    hrate = DEFAULT_HASH_CONFIG.rate_bits
    for log_n in (16, 15):
        lde("sha256 hash bundle", sha, log_n, hrate)
        out.append(("sha256 hash bundle quotient", "coset_intt", 2, log_n + hrate, 0))
    out.extend([("four-step columns", "ntt", 1 << 16, 2, 0), ("four-step rows", "ntt", 1, 18, 0),
                ("ed25519 trace, forward (timed)", "ntt", 2031, 15, 0)])
    for log_n in (0, 1):
        for entry in ("ntt", "intt", "coset_intt"):
            out.append((f"{1 << log_n}-point", entry, 3, log_n, 0))
        out.append((f"{1 << log_n}-point", "coset_lde", 3, log_n, 3))
    seen, shapes = set(), []
    for use, entry, rows, log_n, rate in out:
        if (entry, rows, log_n, rate) not in seen:
            seen.add((entry, rows, log_n, rate))
            shapes.append((use, entry, rows, log_n, rate))
    return shapes


# the timed shape of every NTT entry: the Ed25519 trace (2,031 columns of
# 2^15 rows; its LDE 2^18), and the quotient's coset iNTT of 2 x 2^18
NTT_TIMED = {"ntt": (2031, 15, 0), "intt": (2031, 15, 0), "coset_lde": (2031, 15, 3), "coset_intt": (2, 18, 0)}
NTT_REPLACES = {
    "ntt": "tendermintx_tpu/ops/ntt.py:86",
    "intt": "tendermintx_tpu/ops/ntt.py:114",
    "coset_lde": "tendermintx_tpu/ops/ntt.py:139",
    "coset_intt": "tendermintx_tpu/stark/prover.py:654",
}
NTT_SHIFT = 7  # DEFAULT_COMPOSITE_CONFIG's and default_wrap_config()'s shift


def _ntt_bound(entry: str, rows: int, log_n: int, rate: int, muls_per_ms: float) -> dict:
    """The least time of one call: each input word (the rows and the
    tables: twiddles, shift powers) read once and each output word written
    once at 3.35 TB/s; or 4 32-bit multiply-adds per field multiply: an
    n-point transform (n/2) log2 n butterflies a row, n scalings a row
    for the inverse, and the coset LDE as 2^rate interleaved n-point
    transforms with N twists a row."""
    n, N = 1 << log_n, 1 << (log_n + rate)
    if entry == "coset_lde":
        muls = rows * (N + (1 << rate) * (n // 2) * log_n)
        words = rows * n + n + N // 2 + rows * N
    else:
        scaled = entry in ("intt", "coset_intt")
        muls = rows * ((n // 2) * log_n + n * scaled)
        words = 2 * rows * n + n // 2 + n * (entry == "coset_intt")
    ops_ms = 4 * muls / muls_per_ms
    bytes_ms = 8 * words / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "operations_bound_ms": ops_ms,
        "bytes_bound_ms": bytes_ms,
        "field_muls": muls,
        "bytes": 8 * words,
    }


def _ntt_plan_of(entry: str, log_n: int, rate: int) -> tuple[int, ...]:
    """The passes csrc/ntt.cu runs for one call of an entry."""
    from tendermintx_tpu_torch.ops import ntt

    r = rate if entry == "coset_lde" else 0
    return ntt.ntt_plan(log_n + r, r)


def _kernel_ntt(dev, clock_mhz: float, ptxas: dict) -> dict:
    """Each entry of csrc/ntt.cu against its plain version on the same
    CUDA tensors, exactly on the whole output, at every shape of
    _ntt_shapes(), each timed (the kernel alone) with its bound and its
    plan's pass kernels a call (`shapes`); the plain version's time at
    NTT_TIMED. The row's own numbers are the coset LDE's at the Ed25519
    trace, the main path's largest call."""
    from tendermintx_tpu_torch.ops import ntt
    from tendermintx_tpu_torch.ops.goldilocks import GF, P

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    muls_per_ms = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    powers = lambda n: ntt.power_tensor(pow(NTT_SHIFT, P - 2, P), n, dev)
    kernel = {
        "ntt": lambda x: ntt.ntt_cuda(x),
        "intt": lambda x: ntt.intt_cuda(x),
        "coset_intt": lambda x: ntt.intt_cuda(x, powers(int(x.shape[-1]))),
    }
    plain = {
        "ntt": lambda x: ntt.ntt_plain(GF(x)).v,
        "intt": lambda x: ntt.intt_plain(GF(x)).v,
        "coset_intt": lambda x: (ntt.intt_plain(GF(x)) * GF(powers(int(x.shape[-1])))).v,
    }
    entries, checked, shapes = {}, [], []
    for use, entry, rows, log_n, rate in _ntt_shapes():
        x = _random_felts((rows, 1 << log_n), gen, dev)
        if entry == "coset_lde":
            run = lambda: ntt.coset_lde_cuda(x, rate, NTT_SHIFT)
            run_plain = lambda: ntt.coset_lde_plain(GF(x), rate, NTT_SHIFT).v
        else:
            run = lambda: kernel[entry](x)
            run_plain = lambda: plain[entry](x)
        want, plain_ms = _timed_once(run_plain)
        got = run()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"NTT entry {entry} at {use} ({rows} x 2^{log_n}, rate {rate}) "
                                 f"disagrees with its plain version: max_abs_err {err}")
        del want, got
        checked.append([use, entry, rows, log_n, rate])
        _, first_ms = _timed_once(run)
        shape = {
            "use": use, "entry": entry, "rows": rows, "log_n": log_n, "rate": rate,
            "plan": list(_ntt_plan_of(entry, log_n, rate)),
            "ms": _time_ms(run, max(3, min(20, int(200 / max(first_ms, 1e-3))))),
            **_ntt_bound(entry, rows, log_n, rate, muls_per_ms),
        }
        shape["bound_share"] = shape["bound_ms"] / shape["ms"]
        shapes.append(shape)
        if NTT_TIMED.get(entry) == (rows, log_n, rate) and entry not in entries:
            entries[entry] = {"shape": [rows, 1 << log_n, 1 << (log_n + rate)], "plain_ms": plain_ms,
                              **{k: shape[k] for k in ("ms", "bound_ms", "bound_by", "operations_bound_ms",
                                                        "bytes_bound_ms", "field_muls", "bytes", "bound_share")}}
        del x
    missing = set(NTT_TIMED) - set(entries)
    if missing:
        raise AssertionError(f"NTT entries {sorted(missing)} were not timed")
    top = entries["coset_lde"]
    return {
        "route": "cuda",
        "source": "tendermintx_tpu_torch/csrc/ntt.cu",
        "replaces": NTT_REPLACES["coset_lde"],
        "replaces_entries": NTT_REPLACES,
        "shape": top["shape"],
        "max_abs_err": 0.0,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        **{k: top[k] for k in ("bound_ms", "bound_by", "operations_bound_ms", "bytes_bound_ms", "bytes")},
        "library_ms": None,
        **_registers(ptxas),
        "entries": entries,
        "shapes": shapes,
        "checked": checked,
    }


def _ntt_path_sums(shapes: list[dict], calls: list[tuple]) -> dict:
    """One path's NTT time: its transforms (entry, rows, log2 n, rate, as
    NTT_CALLS recorded them) each at its timed shape's kernel ms and bound
    ms, and their pass kernels; shapes never timed are listed apart."""
    timed = {(s["entry"], s["rows"], s["log_n"], s["rate"]): s for s in shapes}
    by_shape: dict = {}
    for call in calls:
        by_shape[call] = by_shape.get(call, 0) + 1
    untimed = [list(c) for c in by_shape if c not in timed]
    by_shape = {c: n for c, n in by_shape.items() if c in timed}
    return {
        "transforms": len(calls),
        "untimed": untimed,
        "launches": sum(len(timed[c]["plan"]) * n for c, n in by_shape.items()),
        "kernel_ms": sum(timed[c]["ms"] * n for c, n in by_shape.items()),
        "bound_ms": sum(timed[c]["bound_ms"] * n for c, n in by_shape.items()),
        "by_shape": [{"entry": c[0], "rows": c[1], "log_n": c[2], "rate": c[3], "calls": n,
                      "ms": timed[c]["ms"], "bound_ms": timed[c]["bound_ms"]} for c, n in by_shape.items()],
    }


def _registers(ptxas: dict) -> dict:
    """The most registers any kernel function of a library uses, and its
    spill bytes in all (the build phase fails on any spill)."""
    return {
        "registers": max((r.get("registers", 0) for r in ptxas.values()), default=None),
        "spill_bytes": sum((r.get("spill_stores") or 0) + (r.get("spill_loads") or 0) for r in ptxas.values()),
    }


def _deep_bound(n_total: int, n_chunks: int, n_groups: int, rows: int, muls_per_ms: float) -> dict:
    """The least time of one DEEP launch: each column word (trace, aux,
    the chunks' two rows each, the inverses' two rows a group) read once,
    the betas and G0s once, the output's two rows written once, at 3.35
    TB/s; or 4 32-bit multiply-adds per field multiply: 2 a column a group
    a row (an extension scalar times a base value), 4 an extension product
    (a chunk term, each group's inverse)."""
    words = rows * (n_total + 2 * n_chunks + 2 * n_groups + 2) + 2 * (n_groups * n_total + n_chunks + n_groups)
    muls = rows * (2 * n_groups * n_total + 4 * n_chunks + 4 * n_groups)
    ops_ms = 4 * muls / muls_per_ms
    bytes_ms = 8 * words / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "operations_bound_ms": ops_ms,
        "bytes_bound_ms": bytes_ms,
        "field_muls": muls,
        "bytes": 8 * words,
    }


def _kernel_deep(dev, clock_mhz: float, ptxas: dict) -> dict:
    """The DEEP kernel, per AIR of the N=128 paths at its one-device
    shard (one launch over every LDE row: the trace and aux blocks, the
    quotient row block's even and odd rows as the chunks' c0 and c1, one
    opening group per frame offset), held exactly against
    deep_composition_plain on the whole output, each with its time, the
    plain version's and its bound. The row's own numbers are Ed25519's,
    the widest."""
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.ops.goldilocks import GF
    from tendermintx_tpu_torch.stark import prover as pr

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    muls_per_ms = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    airs = {}
    for name, air, N, _ in _quotient_airs():
        f = lambda *shape: GF(_random_felts(shape, gen, dev))
        nc, ng = air.constraint_degree - 1, len(air.frame_offsets)
        trace = f(air.n_cols, N)
        aux = f(air.n_aux_cols, N) if air.n_aux_cols else None
        q = f(2 * nc, N)
        n_total = air.n_cols + air.n_aux_cols
        args = (trace, aux, GF2(q[0::2], q[1::2]), GF2(f(ng, n_total), f(ng, n_total)),
                GF2(f(nc), f(nc)), GF2(f(ng), f(ng)), GF2(f(ng, N), f(ng, N)))
        got, first_ms = _timed_once(lambda: pr.deep_cuda(*args))
        want, plain_ms = _timed_once(lambda: pr.deep_composition_plain(*args))
        err = max(_max_abs_err(got.c0.v, want.c0.v), _max_abs_err(got.c1.v, want.c1.v))
        if err:
            raise AssertionError(f"DEEP kernel of {name} over its {N}-row shard disagrees with its "
                                 f"plain version: max_abs_err {err}")
        del got, want
        reps = max(2, min(50, int(1000 / max(first_ms, 1e-3))))
        airs[name] = {
            "shape": [air.n_cols, air.n_aux_cols, N],
            "chunks": nc,
            "groups": ng,
            "max_abs_err": 0.0,
            "ms": _time_ms(lambda: pr.deep_cuda(*args), reps),
            "plain_ms": plain_ms,
            **_deep_bound(n_total, nc, ng, N, muls_per_ms),
        }
        airs[name]["bound_share"] = airs[name]["bound_ms"] / airs[name]["ms"]
        del trace, aux, q, args
    top = airs["ed25519"]
    return {
        "route": "cuda",
        "source": "tendermintx_tpu_torch/csrc/deep.cu",
        "replaces": "tendermintx_tpu/stark/prover.py:445",
        "replaces_program": "tendermintx_tpu/stark/prover.py:533 (_deep_core)",
        "shape": top["shape"],
        "max_abs_err": 0.0,
        **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "operations_bound_ms",
                               "bytes_bound_ms", "bytes")},
        "library_ms": None,
        **_registers(ptxas),
        "airs": airs,
    }


def _registers_of(ptxas: dict, *parts: str) -> dict:
    """_registers over the kernel functions of a library whose names hold
    one of `parts` (kernel names, not the file's, which every mangled name
    holds)."""
    return _registers({k: v for k, v in ptxas.items() if any(f"{p}_kernel" in k for p in parts)})


def _field_bound(muls: int, nbytes: int, muls_per_ms: float) -> dict:
    """The larger of the bytes at 3.35 TB/s and 4 32-bit multiply-adds a
    field multiply at 64 a clock per SM."""
    ops_ms = 4 * muls / muls_per_ms
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "operations_bound_ms": ops_ms,
        "bytes_bound_ms": bytes_ms,
        "field_muls": muls,
        "bytes": nbytes,
    }


# The bounds of the inverse tables count the least work of the function,
# not the kernels' per-element inversion: 1/d for d = d0 + d1 X with d1
# fixed (-z1 for a DEEP point, gamma1 for a LogUp term) is conj(d) / N(d),
# N(d) = d0^2 - W d1^2 one multiply (W d1^2 once), the N(d) inverted
# together by Montgomery's trick at BATCH_INV_MULS an element (a prefix
# product and two on the way back) and one base inversion, INV_MULS (the
# addition chain, csrc/goldilocks.cuh: inv), a batch; a zero N(d) is
# masked to 1, so inv(0) = 0 costs no multiply
BATCH_INV_MULS = 3
INV_MULS = 73


def _ood_shapes() -> list[tuple[str, object, int, int]]:
    """(name, AIR, log2 n, rate bits) of every statement shape whose OOD
    and DEEP inverses the N=128 paths run: the skip's three statements,
    the step's SHA-256 plan (32,768 rows) and the wrap's WrapAir and
    EvalAir (the hash bundles' plans are the skip's and the step's
    SHA-256 shapes)."""
    from tendermintx_tpu_torch.stark import sha256_air

    out = []
    for name, air, N, rate in _quotient_airs():
        if name == "poseidon_chain":
            continue
        out.append((name, air, N.bit_length() - 1 - rate, rate))
        if name == "sha256":
            step = sha256_air.Sha256Air(N128_SKIP_STATEMENTS["sha256"] // 2)
            out.append(("sha256_step", step, N.bit_length() - 2 - rate, rate))
    return out


def _random_points(k: int, gen, dev) -> list[tuple[int, int]]:
    """k random ext points (past _random_felts's edge values)."""
    v = _random_felts((2 * k + 8,), gen, dev)[8:].cpu().numpy().view(np.uint64).tolist()
    return [(int(v[2 * i]), int(v[2 * i + 1])) for i in range(k)]


def _kernel_ood(dev, clock_mhz: float, ptxas: dict) -> dict:
    """csrc/ood.cu's three entries at every statement shape of the N=128
    paths (_ood_shapes), each held exactly against its plain version on
    the whole output, with its time, the plain version's and its bound:
    ext_powers at the opening points (n powers each) and at alpha
    (n_constraints), ood_eval over the trace and aux rows at every point
    and the quotient chunks' rows at z alone, deep_inverses over the LDE
    domain at every point. Each row's own numbers are Ed25519's."""
    from tendermintx_tpu_torch.ops.goldilocks import GF
    from tendermintx_tpu_torch.stark import prover as pr

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    muls_per_ms = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    rows = {k: {} for k in ("ext_powers", "ood_eval", "deep_inverses")}

    def timed(kernel, plain, what: str, equal) -> dict:
        got, first_ms = _timed_once(kernel)
        want, plain_ms = _timed_once(plain)
        if not equal(got, want):
            raise AssertionError(f"{what} disagrees with its plain version")
        del got, want
        reps = max(2, min(50, int(1000 / max(first_ms, 1e-3))))
        return {"max_abs_err": 0.0, **_time_rounds(kernel, reps), "plain_ms": plain_ms}

    gf2_equal = lambda a, b: torch.equal(a.c0.v, b.c0.v) and torch.equal(a.c1.v, b.c1.v)
    for name, air, log_n, rate in _ood_shapes():
        n, N, K = 1 << log_n, 1 << (log_n + rate), len(air.frame_offsets)
        n_total, n_chunks = air.n_cols + air.n_aux_cols, air.constraint_degree - 1
        pts = _random_points(K, gen, dev)
        alpha = _random_points(1, gen, dev)
        n_con = air.n_constraints  # a host evaluation of the AIR: once, outside the timings
        r = timed(lambda: pr.ext_powers_cuda(pts, n, dev), lambda: pr.ext_powers_plain(pts, n, dev),
                  f"ext_powers at {name}'s {K} points x {n}", gf2_equal)
        r["burst_ms"] = _launch_burst_ms(pr, "_ood_launch", "_ood_library", lambda: pr.ext_powers_cuda(pts, n, dev))
        r["run"] = pr._powers_run(n, K)
        ra = timed(lambda: pr.ext_powers_cuda(alpha, n_con, dev), lambda: pr.ext_powers_plain(alpha, n_con, dev),
                   f"ext_powers at {name}'s alpha x {n_con}", gf2_equal)
        ra["burst_ms"] = _launch_burst_ms(pr, "_ood_launch", "_ood_library",
                                          lambda: pr.ext_powers_cuda(alpha, n_con, dev))

        rows["ext_powers"][name] = {
            "shape": [K, n], **r, **_field_bound(4 * K * n, 16 * K * n, muls_per_ms),
            "alpha": {"shape": [1, n_con], **ra, **_field_bound(4 * n_con, 16 * n_con, muls_per_ms)},
        }
        a = GF(_random_felts((n_total, n), gen, dev))
        b = GF(_random_felts((2 * n_chunks, n), gen, dev))
        powers = pr.ext_powers_cuda(pts, n, dev)
        r = timed(lambda: pr.ood_eval_cuda(a, b, powers), lambda: pr.ood_eval_plain(a, b, powers),
                  f"ood_eval over {name}'s {n_total} + {2 * n_chunks} rows x {n} at {K} points", torch.equal)
        # the function: the trace and aux rows at every point, the chunks'
        # c0 and c1 rows at z alone (as the kernel takes them)
        n_rows, n_out = n_total + 2 * n_chunks, K * n_total + 2 * n_chunks
        threads = pr._ood_threads(n_rows)
        sms_, blocks_per_sm = pr._ood_occupancy(dev, K, threads)
        _, slice_, slices = pr._ood_plan(n_rows, n, K, sms_, blocks_per_sm)
        rows["ood_eval"][name] = {
            "shape": [n_total, 2 * n_chunks, n, K], "threads": threads, "blocks_per_sm": blocks_per_sm,
            "point_groups": pr._ood_groups(K)[0], "slice": slice_, "slices": slices, **r,
            **_field_bound(2 * n_out * n, 8 * (n_rows * n + 2 * K * n + 2 * n_out), muls_per_ms),
        }
        del a, b, powers
        r = timed(lambda: pr.deep_inverses_cuda(log_n + rate, NTT_SHIFT, pts, dev),
                  lambda: pr.deep_inverses_plain(log_n + rate, NTT_SHIFT, pts, dev),
                  f"deep_inverses over {name}'s {N} points at {K} points", gf2_equal)
        r["burst_ms"] = _launch_burst_ms(pr, "_ood_launch", "_ood_library",
                                         lambda: pr.deep_inverses_cuda(log_n + rate, NTT_SHIFT, pts, dev))
        # the last point planted on the domain (z1 = 0): 0 in its column alone
        planted = (2 * N) // 3
        on_domain = [*pts[:-1], (int(pr._domain_points(log_n + rate, NTT_SHIFT)[planted]), 0)]
        got = pr.deep_inverses_cuda(log_n + rate, NTT_SHIFT, on_domain, dev)
        zero = ((got.c0.v[-1] == 0) & (got.c1.v[-1] == 0)).nonzero().flatten().tolist()
        if not gf2_equal(got, pr.deep_inverses_plain(log_n + rate, NTT_SHIFT, on_domain, dev)) or zero != [planted]:
            raise AssertionError(f"deep_inverses over {name}'s {N} points with a domain point disagrees with its "
                                 f"plain version (zero columns {zero[:4]}, {planted} wanted)")
        r["planted_zero"] = planted
        del got
        # x = x_prev w (N), then a point's norms, their batch inversion and
        # the conjugate's two products (K N (1 + BATCH_INV_MULS + 2)), one
        # inversion a point
        rows["deep_inverses"][name] = {
            "shape": [K, N], **r,
            **_field_bound(N + K * N * (3 + BATCH_INV_MULS) + K * INV_MULS, 16 * K * N, muls_per_ms),
        }
    out = {}
    parts = {"ext_powers": ("tmx_ext_powers",), "ood_eval": ("tmx_ood", "tmx_ood_sum"),
             "deep_inverses": ("tmx_deep_inverses",)}
    replaces = {
        "ext_powers": ("tendermintx_tpu/stark/prover.py:565", "_zpowers_fn (the OOD points at :932, alpha at :852)"),
        "ood_eval": ("tendermintx_tpu/stark/prover.py:588", "_ood_trace_fn over _gk_table (:617), and _ood_ext_fn (:606)"),
        "deep_inverses": ("tendermintx_tpu/stark/prover.py:103", "_deep_invs_fn"),
    }
    for kname, airs in rows.items():
        top = airs["ed25519"]
        out[kname] = {
            "route": "cuda",
            "source": "tendermintx_tpu_torch/csrc/ood.cu",
            "replaces": replaces[kname][0],
            "replaces_program": replaces[kname][1],
            "shape": top["shape"],
            **{k: top[k] for k in ("max_abs_err", "ms", "ms_min", "ms_max", "burst_ms", "plain_ms", "bound_ms",
                                   "bound_by", "operations_bound_ms", "bytes_bound_ms", "bytes") if k in top},
            "library_ms": None,
            **_registers_of(ptxas, *parts[kname]),
            "airs": airs,
        }
    return out


# (checked columns, rows, table bits) of the LogUp kernels' synthetic
# shapes beside the Ed25519 statement's: pad 2 and 3 with one and four
# table columns, 13 columns over 2^12 rows, and pad 1 with 17 terms (two
# runs of 8 and one left over)
LOGUP_SYNTHETIC = ((6, 32, 5), (5, 16, 6), (13, 1 << 12, 13), (59, 64, 7))


def _logup_case(lookup_of, n_cols: int, gen, dev):
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.ops.goldilocks import GF

    g = _random_felts((10,), gen, dev)[8:]
    return GF(_random_felts((n_cols, lookup_of.n_rows), gen, dev)), GF2(GF(g[0:1]), GF(g[1:2]))


def _kernel_logup(dev, clock_mhz: float, ptxas: dict) -> dict:
    """csrc/logup.cu's two entries at the Ed25519 statement of the N=128
    paths (its RangeLookup over a random trace: 1,788 checked columns of
    2^15 rows, one table column, pad 0), each held exactly against its
    plain version (logup_terms_plain: the w and wt rows and the groups'
    sums; logup_scan_plain: S) and the whole aux output against
    build_aux_plain, with times and bounds; then the synthetic shapes with
    pad > 0 and several table columns, checked alone."""
    from tendermintx_tpu_torch.stark import lookup
    from tendermintx_tpu_torch.stark.ed25519_air import Ed25519Air
    from tendermintx_tpu_torch.stark.lookup import BATCH, RangeLookup

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    muls_per_ms = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    air = Ed25519Air(N128_SKIP_STATEMENTS["ed25519"])
    lk = air.lookup
    trace, gamma = _logup_case(lk, air.n_cols, gen, dev)

    def check(lk, trace, gamma, what: str):
        got = lk.build_aux_cuda(trace, gamma)
        if not torch.equal(got.v, lk.build_aux_plain(trace, gamma).v):
            raise AssertionError(f"the LogUp aux columns of {what} disagree with build_aux_plain")
        out = torch.empty_like(got.v)
        partial = lk.logup_terms_cuda(trace, gamma, out)
        rows, want_partial = lk.logup_terms_plain(trace, gamma)
        if not (torch.equal(out[: rows.shape[0]], rows) and torch.equal(partial, want_partial)):
            raise AssertionError(f"logup_terms over {what} disagrees with logup_terms_plain")
        lk.logup_scan_cuda(partial, out)
        if not torch.equal(out[rows.shape[0]:], lk.logup_scan_plain(partial)):
            raise AssertionError(f"logup_scan over {what} disagrees with logup_scan_plain")
        return out, partial

    out, partial = check(lk, trace, gamma, "Ed25519 at N=128")
    n, K, nb, width = lk.n_rows, len(lk.checked_cols), lk.n_batches, lk.width
    group, n_groups = lk.logup_groups()
    _, terms_plain_ms = _timed_once(lambda: lk.logup_terms_plain(trace, gamma))
    _, scan_plain_ms = _timed_once(lambda: lk.logup_scan_plain(partial))
    _, aux_plain_ms = _timed_once(lambda: lk.build_aux_plain(trace, gamma))
    terms = _time_rounds(lambda: lk.logup_terms_cuda(trace, gamma, out), 20)
    terms["clocks_sm_mhz"] = float(_nvidia_smi("clocks.sm"))  # read just after the rounds
    scan = _time_rounds(lambda: lk.logup_scan_cuda(partial, out), 20)
    scan["burst_ms"] = _launch_burst_ms(lookup, "_logup_launch", "_logup_library",
                                        lambda: lk.logup_scan_cuda(partial, out))
    aux = _time_rounds(lambda: lk.build_aux_cuda(trace, gamma), 20)
    # the function's least multiplies a row (see BATCH_INV_MULS): a checked
    # term's norm, batch inversion and d0 / N(d), with gamma1 times the
    # batch's sum of 1 / N(d) once a batch; a table term's norm, batch
    # inversion, m / N(d) and its two products with conj(d); one inversion
    w_muls = 1 + BATCH_INV_MULS + 1
    wt_muls = 1 + BATCH_INV_MULS + 3
    terms_bound = _field_bound(n * (K * w_muls + nb + width * wt_muls) + INV_MULS,
                               8 * n * ((K + width) + 2 * (nb + width) + 2 * n_groups) + 8 * K, muls_per_ms)
    scan_bound = _field_bound(0, 8 * n * (2 * n_groups + 2), muls_per_ms)
    checked = [{"checked": K, "rows": n, "table_bits": lk.table_bits, "pad": nb * BATCH - K, "width": width,
                "max_abs_err": 0.0}]
    for k, rows_n, bits in LOGUP_SYNTHETIC:
        syn = RangeLookup(list(range(1, 2 * k, 2)), 2 * k, rows_n, bits)
        t, g = _logup_case(syn, 2 * k + syn.width, gen, dev)
        check(syn, t, g, f"{k} columns of {rows_n} rows")
        checked.append({"checked": k, "rows": rows_n, "table_bits": bits, "pad": syn.n_batches * BATCH - k,
                        "width": syn.width, "max_abs_err": 0.0})
    common = {"route": "cuda", "source": "tendermintx_tpu_torch/csrc/logup.cu", "library_ms": None,
              "max_abs_err": 0.0, "checked": checked}
    return {
        "logup_terms": {
            **common, "replaces": "tendermintx_tpu/stark/lookup.py:400",
            "replaces_program": "_aux_w_kernel (:400), _aux_wt_kernel (:443), _aux_assemble_kernel (:474)",
            "shape": [K, n, nb, width], "groups": [group, n_groups], **terms, "plain_ms": terms_plain_ms,
            **terms_bound, **_registers_of(ptxas, "tmx_logup_terms"),
            "aux": {**aux, "plain_ms": aux_plain_ms},
        },
        "logup_scan": {
            **common, "replaces": "tendermintx_tpu/stark/lookup.py:450",
            "replaces_program": "_aux_scan_kernel", "shape": [2, n_groups, n], "tiles": list(lk.scan_tiles()),
            **scan, "plain_ms": scan_plain_ms, **scan_bound,
            **_registers_of(ptxas, "tmx_logup_tile_sums", "tmx_logup_scan"),
        },
    }


# the least multiplies of a fold output: (e - o) times (2x)^-1 (2), beta
# times that (4), (e + o) / 2 (2) and (2x)^-1 from the previous one (1)
FOLD_MULS = 9
# at most this many input sets rotate under a timed FRI launch
FRI_MAX_SETS = 1024


def _fri_plan(sizes: list[int], config, shards: int = 1) -> tuple[list, list]:
    """The fold and injection calls of one FRI proof over codewords of
    `sizes` values at `config` (a StarkConfig), as stark/fri.py makes them:
    fri_prove for one codeword, fri_prove_batch for more. A fold is (log2
    N, shift, start, outputs): one a committed layer, one a row shard
    where a mesh of `shards` shards the layer (at least 4 values a shard);
    an injection is (log2 n, codewords, into a folded layer): one a
    codeword size of a batch."""
    folds, injections = [], []
    stop = config.final_poly_len << config.rate_bits
    n, shift = max(sizes), config.shift % GL_P
    while True:
        k = sizes.count(n)
        if k and len(sizes) > 1:
            injections.append((n.bit_length() - 1, k, n < max(sizes)))
        if n <= stop and n <= min(sizes):
            return folds, injections
        log_n = n.bit_length() - 1
        if shards > 1 and n >= 4 * shards:
            h = n // (2 * shards)
            folds += [(log_n, shift, d * h, h) for d in range(shards)]
        else:
            folds.append((log_n, shift, 0, n // 2))
        shift = shift * shift % GL_P
        n //= 2


def _fri_paths() -> dict:
    """{path: [(codeword sizes, StarkConfig, shards) of each FRI proof]}
    of the N=128 paths, from their configs and the statement shapes of
    _ood_shapes: the skip composite (SHA-256 plan, Ed25519, SHA-512), the
    step composite (SHA-256 step plan, Ed25519, SHA-512), the two hash
    bundles (the skip's and the step's SHA-256 plans, one FRI each), the
    wrap (WrapAir and EvalAir), the runtime operator's validator-leaf
    bundle (one SHA-256 block a lane) and the skip on the MESH_SHARDS-shard
    mesh."""
    from tendermintx_tpu_torch.circuits.composite import DEFAULT_COMPOSITE_CONFIG as composite
    from tendermintx_tpu_torch.circuits.hashing import DEFAULT_HASH_CONFIG as hashes
    from tendermintx_tpu_torch.circuits.proving import _default_config
    from tendermintx_tpu_torch.stark import sha256_air
    from tendermintx_tpu_torch.stark.recursion import default_wrap_config

    rows = {name: 1 << log_n for name, _, log_n, _ in _ood_shapes()}
    rows["leaf"] = sha256_air.SEGMENT * N128_SKIP_STATEMENTS["ed25519"]
    fri = lambda cfg, *names, shards=1: ([rows[k] << cfg.rate_bits for k in names], cfg, shards)
    wrap, leaf = default_wrap_config(), _default_config()
    return {
        "skip": [fri(composite, "sha256", "ed25519", "sha512")],
        "step": [fri(composite, "sha256_step", "ed25519", "sha512")],
        "hashes": [fri(hashes, "sha256"), fri(hashes, "sha256_step")],
        "wrap": [fri(wrap, "wrap", "evalair")],
        "leaf": [fri(leaf, "leaf")],
        "mesh": [fri(composite, "sha256", "ed25519", "sha512", shards=MESH_SHARDS)],
    }


def _fri_shapes() -> tuple[dict, dict]:
    """({fold: [paths]}, {injection: [paths]}): every distinct fold and
    injection call of the N=128 paths (_fri_paths through _fri_plan), in
    the order the paths make them."""
    folds, injections = {}, {}
    for path, fris in _fri_paths().items():
        for sizes, config, shards in fris:
            f, i = _fri_plan(sizes, config, shards)
            for table, keys in ((folds, f), (injections, i)):
                for key in keys:
                    if path not in table.setdefault(key, []):
                        table[key].append(path)
    return folds, injections


class _FriCalls:
    """The shape of every call of csrc/fri.cu's wrappers (fold_cuda,
    inject_cuda) while installed, keyed as _fri_plan keys them, so that
    the run holds every shape it launched against its plain version
    (phase_fri_shapes)."""

    def __init__(self):
        self.folds: set = set()
        self.injections: set = set()

    def install(self):
        from tendermintx_tpu_torch.stark import fri

        fold_cuda, inject_cuda = fri.fold_cuda, fri.inject_cuda

        def fold(e, o, beta, shift, start, log_n):
            self.folds.add((log_n, shift % GL_P, start, int(e.shape[0])))
            return fold_cuda(e, o, beta, shift, start, log_n)

        def inject(cur, lams, Fs):
            self.injections.add((int(Fs[0].shape[0]).bit_length() - 1, len(Fs), cur is not None))
            return inject_cuda(cur, lams, Fs)

        fri.fold_cuda, fri.inject_cuda = fold, inject


FRI_CALLS = _FriCalls()


def _fri_inputs(kind: str, key: tuple, gen, dev, cold: bool) -> tuple:
    """(wrapper, plain version, input sets, bytes a set reads, outputs,
    field multiplies, what the shape is) of one fold or injection shape (a
    _fri_plan key) on random inputs (stark/fri.py: fold_halves and
    fold_plain with the plain version's (2x)^-1 host table built here, or
    inject and inject_plain): one input set or, `cold`, as many as
    together exceed twice the card's L2 where FRI_MAX_SETS allow, so that
    a launch that rotates through them reads its inputs from HBM."""
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.ops.goldilocks import GF
    from tendermintx_tpu_torch.stark import fri

    if kind == "fold":
        log_n, shift, start, n = key
        rows_in, muls, kernel, plain = 4, FOLD_MULS * n, fri.fold_halves, fri.fold_plain
        what = {"log_n": log_n, "shift": shift, "start": start, "shape": [2, 2 * n]}
        fri._inv_x_table(log_n, shift)
        (beta,) = _random_points(1, gen, dev)
        args = lambda ext: (ext(0), ext(2), beta, shift, start, log_n)
    else:
        log_n, k, with_cur = key
        n = 1 << log_n
        rows_in, muls, kernel, plain = 2 * (k + with_cur), 4 * k * n, fri.inject, fri.inject_plain
        what = {"log_n": log_n, "codewords": k, "cur": with_cur, "shape": [k, 2, n]}
        lams = _random_points(k, gen, dev)
        args = lambda ext: (ext(2 * k) if with_cur else None, lams, [ext(2 * j) for j in range(k)])
    in_bytes = 8 * rows_in * n
    sets = min(FRI_MAX_SETS, -(-2 * torch.cuda.get_device_properties(0).L2_cache_size // in_bytes)) if cold else 1
    pool = _random_felts((rows_in, sets, n), gen, dev)
    inputs = [args(lambda r: GF2(GF(pool[r, s]), GF(pool[r + 1, s]))) for s in range(sets)]
    return kernel, plain, inputs, in_bytes, n, muls, what


def _fri_case(kind: str, key: tuple, gen, dev, muls_per_ms: float, timed: bool) -> dict:
    """One fold or injection shape on random inputs (_fri_inputs): the
    wrapper held exactly against its plain version on the whole output,
    the plain version's ms and the bytes bound; `timed`, the wrapper's
    time too (the median of five rounds, the fastest and slowest beside
    it) rotating through input sets that exceed twice the L2 (`l2_cold`
    where FRI_MAX_SETS allowed that), and `burst_ms`, raw launches on one
    input set (L2-warm where it fits the L2)."""
    from tendermintx_tpu_torch.stark import fri

    kernel, plain, inputs, in_bytes, n, muls, out = _fri_inputs(kind, key, gen, dev, timed)
    got = kernel(*inputs[0])
    want, plain_ms = _timed_once(lambda: plain(*inputs[0]))
    if not (torch.equal(got.c0.v, want.c0.v) and torch.equal(got.c1.v, want.c1.v)):
        raise AssertionError(f"fri {kind} {key} disagrees with its plain version")
    del got, want
    out.update({"max_abs_err": 0.0, "plain_ms": plain_ms, **_field_bound(muls, in_bytes + 16 * n, muls_per_ms)})
    if timed:
        turns = itertools.cycle(inputs)
        run = lambda: kernel(*next(turns))
        _, first_ms = _timed_once(run)
        reps = max(3, min(200, int(200 / max(first_ms, 1e-3))))
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        out.update({**_time_rounds(run, reps), "l2_sets": len(inputs), "l2_cold": len(inputs) * in_bytes >= 2 * l2,
                    "burst_ms": _launch_burst_ms(fri, "_fri_launch", "_fri_library", lambda: kernel(*inputs[0]))})
    return out


def _kernel_fri(dev, clock_mhz: float, ptxas: dict) -> dict:
    """csrc/fri.cu's two entries at every fold and injection shape of the
    N=128 paths (_fri_shapes), each held exactly against its plain version
    (_fri_case); each fold launch shape (outputs of a whole layer) and
    each injection timed once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    muls_per_ms = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    folds, injections = _fri_shapes()
    timed_halves = set()
    layers = []
    for key, paths in folds.items():
        _, _, start, half = key
        timed = start == 0 and half not in timed_halves
        timed_halves.add(half)
        layers.append({"paths": paths, **_fri_case("fold", key, gen, dev, muls_per_ms, timed)})
    injected = [{"paths": paths, **_fri_case("inject", key, gen, dev, muls_per_ms, True)}
                for key, paths in injections.items()]
    common = {"route": "cuda", "source": "tendermintx_tpu_torch/csrc/fri.cu", "library_ms": None}
    keys = ("shape", "max_abs_err", "ms", "ms_min", "ms_max", "burst_ms", "plain_ms", "bound_ms", "bound_by",
            "operations_bound_ms", "bytes_bound_ms", "bytes", "l2_cold")
    # the skip composite's first layer (2^19) and its 2^18 injection (two
    # codewords into the folded layer)
    top_fold = next(r for r in layers if r["log_n"] == 19 and "ms" in r)
    top_inject = next(r for r in injected if r["shape"] == [2, 2, 1 << 18] and r["cur"])
    return {
        "fri_fold": {
            **common, "replaces": "tendermintx_tpu/stark/fri.py:93",
            "replaces_program": "_fold_layer (jitted at :117 as _fold_jit)",
            **{k: top_fold[k] for k in keys}, **_registers_of(ptxas, "tmx_fri_fold"), "layers": layers,
        },
        "fri_inject": {
            **common, "replaces": "tendermintx_tpu/stark/fri.py:330",
            "replaces_program": "_inject_fn (:330) and _scale_fn (:337)",
            **{k: top_inject[k] for k in keys}, **_registers_of(ptxas, "tmx_fri_inject"),
            "injections": injected,
        },
    }


def phase_fri_shapes(rows: dict) -> dict:
    """Every fold and injection shape that csrc/fri.cu's wrappers were
    called with on the card in this run (FRI_CALLS) and the kernels phase
    did not check, held exactly against its plain version now (_fri_case,
    untimed): the N=4 proofs' (the parity prove, the runtime service's
    prewarm, the mesh's N=4 wrap), so that every shape a path launched
    was checked. Adds them to the rows' `checked_after_paths`."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    out = {"phase": "fri_shapes"}
    for name, kind, part, called in (("fri_fold", "fold", "layers", FRI_CALLS.folds),
                                     ("fri_inject", "inject", "injections", FRI_CALLS.injections)):
        row = rows[name]
        checked = {(r["log_n"], r["shift"], r["start"], r["shape"][1] // 2) if kind == "fold"
                   else (r["log_n"], r["codewords"], r["cur"]) for r in row[part]}
        row["checked_after_paths"] = [
            {k: v for k, v in _fri_case(kind, key, gen, dev, 1.0, False).items()
             if k in ("log_n", "shift", "start", "codewords", "cur", "shape", "max_abs_err")}
            for key in sorted(called - checked)
        ]
        out[name] = {"called": len(called), "checked_in_kernels_phase": len(called & checked),
                     "checked_now": row["checked_after_paths"]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# The witness programs' kernels (ROADMAP queue 2 item L): csrc/sha.cu and
# csrc/ed25519.cu
# ---------------------------------------------------------------------------

WITNESS_ENTRIES = ("sha256_blocks", "sha256_validator_root", "sha256_header_proofs", "sha512_blocks",
                   "sha512_challenge", "straus_verify", "bind_witness")
# the entries no witness program calls: sha256_blocks (the mesh's lane
# checks' leaf hashes call it) and sha512_blocks (sha512_challenge pads and
# hashes R || A || M itself); each is checked and timed at the shape of the
# calls it replaced
NOT_IN_PROGRAMS = ("sha256_blocks", "sha512_blocks")
# the entries of csrc/sha.cu's tree and proof kernels, which the witness
# programs call through circuits/gadgets.py: (their wrapper and plain twin
# there)
SHA256_GADGETS = {"sha256_validator_root": ("validator_root_cuda", "validator_root_plain"),
                  "sha256_header_proofs": ("header_proofs_cuda", "header_proof_root_plain")}
# circuits/gadgets.py::header_proof_root: a header Merkle proof's depth
HEADER_PROOF_DEPTH = 4
# the byte rows the witness packs (circuits/variables.py): a validator leaf
# (0x00 and its encoding), a header proof's leaf
VALIDATOR_LEAF_WIDTH = 47
HEADER_LEAF_WIDTH = 73
# circuits/variables.py: a signed message's row
MESSAGE_WIDTH = 124
# Hopper instructions of one compression, at 64 a clock per SM (the
# integer pipe's rate): a rotation or shift is one SHF, a 3-input xor, Ch
# or Maj one LOP3, a 3-input add one IADD3. A schedule word: two sigmas of
# 3 SHF and a LOP3, and 2 IADD3 for its 4 terms (10); a round: two Sigmas
# (8), Ch and Maj (2), T1's 5 terms in 2 IADD3, e = d + T1 and a = T1 +
# Sigma0 + Maj (14); 8 feed-forward adds. A 64-bit word operation of
# SHA-512 is two 32-bit ones (a 3-input 64-bit add is IADD3 and IADD3.X).
SHA256_OPS_PER_BLOCK = 48 * 10 + 64 * 14 + 8  # 1,384
SHA512_OPS_PER_BLOCK = 2 * (64 * 10 + 80 * 14 + 8)  # 3,536
# 32-bit multiply-adds of a field product in radix 2^25.5 (10 x 10 limbs)
# and of a squaring (the 10 squares and the 45 cross products, doubled
# through a premultiplied operand)
FE_MACS = 100
FE_SQ_MACS = 55
# field products and squarings of a ladder step (the doubling's 4
# squarings and 4 products, the mixed addition's 3 + 4 products), and the
# products of a lane outside the steps (the table's 2d t, 4; the final rx
# Z and ry Z, 2)
LADDER_STEP_PRODUCTS = 11
LADDER_STEP_SQUARINGS = 4
LADDER_LANE_PRODUCTS = 4 + 2
# the binding's field products (two curve checks of 2 products and 2
# squarings, t = x y in 4 slots, the slot-3 addition's 8 with its 2d t,
# its 2-product check) and squarings, and the 20 x 20 13-bit multiply-adds
# of k_q L
BIND_PRODUCTS = 2 * 2 + 4 + 8 + 2
BIND_SQUARINGS = 2 * 2
BIND_MOD_L_MACS = 20 * 20
# A ladder step's dependent chain, in dependent 32-bit instructions: 4
# field products and 4 sums or differences in sequence (the doubling's
# x + y, its square, E = (x + y)^2 - A - B, E F; the addition's Y - X, its
# product, E = B - A, E F). A product's own chain: the 19 g premultiply,
# one output limb's 10 multiply-adds in sequence, and the 12-step carry
# chain at 3 a step (shift, add, add with carry); a sum's: the add and a
# carry pass's shift and add. Each dependent instruction waits at least 4
# clocks (Hopper's integer and IMAD dependent-issue latency).
PRODUCT_CHAIN = 1 + 10 + 12 * 3
SUM_CHAIN = 3
LADDER_STEP_CHAIN = 4 * PRODUCT_CHAIN + 4 * SUM_CHAIN
DEPENDENT_ISSUE_CLOCKS = 4
# A SHA-256 round's dependent chain: e's next value waits on Sigma1 (an SHF,
# then a LOP3 of the three rotations), Ch's LOP3 and two IADD3; a's
# (Sigma0 and Maj beside t1) is no longer. A compression is 64 such rounds.
SHA256_ROUND_CHAIN = 4
# A SHA-512 round's: Sigma1's SHF and LOP3, then e = d + h + K + W + Sigma1
# + Ch as two 64-bit adds (d + h + K + W is ready a round early), each an
# IADD3 and an IADD3.X.
SHA512_ROUND_CHAIN = 6
# The binding's longest dependent chain: slot 3's check, four field products
# in sequence (2d t_2, C = t_B 2d t_2, Z_3 = F G, x_3 Z_3) with the sum F =
# 2 - C between, then a canonical comparison (three sequential carries over
# ten limbs, a shift and an add a step).
CANON_CHAIN = 3 * 2 * 10
BIND_CHAIN = 4 * PRODUCT_CHAIN + SUM_CHAIN + CANON_CHAIN


def _witness_launches(n_validators: int, kind: str) -> dict:
    """Each witness kernel's launches in one skip_verify or step_verify of
    n_validators lanes, from circuits/verify.py's structure: the validator
    tree once a lane set (the target's, and for a skip the trusted set's),
    the header proofs once (all of a program's in one batch); the SHA-512
    challenge, the binding and the ladder once (verify_bound);
    sha256_blocks and sha512_blocks none."""
    return {"sha256_blocks": 0, "sha256_validator_root": 2 if kind == "skip" else 1,
            "sha256_header_proofs": 1, "sha512_blocks": 0, "sha512_challenge": 1, "straus_verify": 1,
            "bind_witness": 1}


def _witness_sha256_shapes(n_validators: int, kind: str) -> dict:
    """The byte rows of the SHA-256 gadget calls of one skip_verify or
    step_verify: the validator trees' (n_validators, VALIDATOR_LEAF_WIDTH)
    and the header proofs' (4 in a skip, 5 in a step, HEADER_LEAF_WIDTH)."""
    return {"sha256_validator_root": {(n_validators, VALIDATOR_LEAF_WIDTH)},
            "sha256_header_proofs": {(4 if kind == "skip" else 5, HEADER_LEAF_WIDTH)}}


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


def _decodable(pt: bytes) -> bytes:
    """A valid point encoding near pt (low y bits flipped until it decodes)."""
    from tendermintx_tpu_torch.ops import ed25519 as ed

    for i in range(1, 64):
        pt = _flip(pt, i % 31)
        if ed.decompress(pt) is not None:
            return pt
    raise AssertionError("no decodable point found")


def _witness_cases(dev) -> tuple[tuple, tuple]:
    """(ladder inputs, binding inputs) of lanes on `dev` where both
    outcomes occur. A small chain's 8 signature lanes: 4 honest, then a
    tampered R, S, message and public key, each with the witness its bytes
    derive (bound; the ladder rejects them). Then copies of honest lanes
    with witness-only tampering: a scalar bit, a k_q limb, a table limb,
    R's parity (the binding rejects them); one in a non-canonical form (rx
    and two table values plus p, limbs still below 2^13: both accept it);
    and one with selectors 7 and -3 (the all-zero operand zeroes the point,
    which the ladder's projective check accepts; the binding rejects it).
    The binding's inputs add two lanes outside the ladder's limb domain, a
    table limb of 8192 and a k_q limb of -1. Ladder inputs are the six
    int64 arrays; binding inputs those and sig_r, sig_s, sig_pk, the
    SHA-512 digests (uint8) and k_q."""
    from tendermintx_tpu_torch.inputs.conversion import get_validator_data_from_block, signature_lanes
    from tendermintx_tpu_torch.inputs.testchain import TestChain
    from tendermintx_tpu_torch.ops import ed25519 as ed

    chain = TestChain(n_validators=6, chain_id=CHAIN_ID)
    h = chain.extend()
    pks, msgs, sigs = (list(x) for x in signature_lanes(
        get_validator_data_from_block(chain.val_set, chain.commits[h], chain.chain_id, 8)))
    sigs[4] = _decodable(sigs[4][:32]) + sigs[4][32:]
    sigs[5] = sigs[5][:32] + _flip(sigs[5], 40)[32:]
    msgs[6] = _flip(msgs[6], 30)
    pks[7] = _decodable(pks[7])
    ladder = [t.numpy() for t in ed.prepare_batch(pks, msgs, sigs)]
    sig_r, sig_s, sig_pk, k_q = (t.numpy() for t in ed.prepare_binding(pks, msgs, sigs))
    digest = np.stack([np.frombuffer(hashlib.sha512(s[:32] + pk + m).digest(), dtype=np.uint8)
                       for pk, m, s in zip(pks, msgs, sigs)])
    bind = [sig_r, sig_s, sig_pk, digest, k_q]
    take = [0, 1, 2, 3, 0, 1]  # lanes 8-13 copy these
    ladder = [np.concatenate([a, a[take]]) for a in ladder]
    bind = [np.concatenate([b, b[take]]) for b in bind]
    table_x, table_y, table_t, bits2, rx, _ = ladder
    bits2[8, 100] ^= 1
    bind[4][9, 0] ^= 1
    table_x[10, 3, 5] ^= 1
    rx[11] = ed.int_to_limbs((ed.P25519 - ed.limbs_to_int(rx[11])) % ed.P25519)
    rx[12] = ed.int_to_limbs(ed.limbs_to_int(rx[12]) + ed.P25519)
    table_y[12, 1] = ed.int_to_limbs(ed.limbs_to_int(table_y[12, 1]) + ed.P25519)
    table_t[12, 3] = ed.int_to_limbs(ed.limbs_to_int(table_t[12, 3]) + ed.P25519)
    bits2[13, 50], bits2[13, 51] = 7, -3
    wide = [np.concatenate([a, a[:2]]) for a in ladder]
    wide_bind = [np.concatenate([b, b[:2]]) for b in bind]
    wide[2][14, 1, 7] = 8192
    wide_bind[4][15, 19] = -1
    on = lambda arrays: tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
    return on(ladder), on(wide + wide_bind)


def _ops_bound(ops: int, nbytes: int, ops_per_ms: float) -> dict:
    """The larger of the bytes at 3.35 TB/s and 32-bit operations at 64 a
    clock per SM."""
    ops_ms = ops / ops_per_ms
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "operations_bound_ms": ops_ms,
        "bytes_bound_ms": bytes_ms,
        "operations": ops,
        "bytes": nbytes,
    }


def _sha_bound(kind: str, blocks: torch.Tensor, n_active: torch.Tensor, ops_per_ms: float) -> dict:
    """A SHA call's bound over the blocks this call's lanes compress (each
    such block's words read once, n_active read, the digests written)."""
    compressed = int(torch.clamp(n_active, min=0, max=int(blocks.shape[1])).sum())
    ops = compressed * (SHA256_OPS_PER_BLOCK if kind == "sha256" else SHA512_OPS_PER_BLOCK)
    return _ops_bound(ops, compressed * 16 * 8 + 8 * int(blocks.shape[0]) * (1 + 8), ops_per_ms)


def _sha256_chain_ms(compressions: int, clock_mhz: float) -> float:
    """A run of dependent SHA-256 compressions: 64 rounds of
    SHA256_ROUND_CHAIN dependent instructions of DEPENDENT_ISSUE_CLOCKS
    clocks each, at the maximum SM clock."""
    return compressions * 64 * SHA256_ROUND_CHAIN * DEPENDENT_ISSUE_CLOCKS / (clock_mhz * 1e3)


def _tree_bound(leaf_bytes: torch.Tensor, leaf_len: torch.Tensor, n_enabled: torch.Tensor, ops_per_ms: float,
                clock_mhz: float) -> dict:
    """A validator tree's bound over what its root needs: the first n of
    its leaves (n = n_enabled within 1..lanes; one block each, their bytes
    and lengths read once) and the n - 1 pairs that merge them (two blocks
    each), the root written; its dependent-chain floor beside, the leaf and
    two compressions a level on the path of ceil(log2 n) levels."""
    lanes, width = int(leaf_bytes.shape[0]), int(leaf_bytes.shape[1])
    n = min(max(int(n_enabled), 1), lanes)
    levels = (n - 1).bit_length()
    return {**_ops_bound((n + 2 * (n - 1)) * SHA256_OPS_PER_BLOCK, n * (width + 8) + 8 + 32, ops_per_ms),
            "compressions": n + 2 * (n - 1), "chain_floor_ms": _sha256_chain_ms(1 + 2 * levels, clock_mhz)}


def _proofs_bound(leaf_len: torch.Tensor, width: int, ops_per_ms: float, clock_mhz: float) -> dict:
    """k header proofs' bound: each leaf's blocks (one or two by its
    length) and four pairs of two blocks, the leaf bytes, lengths, aunts
    and path bits read once, the roots written; the chain floor of the
    longest proof beside."""
    blocks = [(int(n) + 9 + 63) // 64 for n in leaf_len.tolist()]
    k = len(blocks)
    compressions = sum(blocks) + k * 2 * HEADER_PROOF_DEPTH
    nbytes = k * (width + 8 + HEADER_PROOF_DEPTH * (32 + 8) + 32)
    return {**_ops_bound(compressions * SHA256_OPS_PER_BLOCK, nbytes, ops_per_ms), "compressions": compressions,
            "chain_floor_ms": _sha256_chain_ms(max(blocks, default=0) + 2 * HEADER_PROOF_DEPTH, clock_mhz)}


def _ladder_bound(lanes: int, steps: int, ops_per_ms: float, clock_mhz: float) -> dict:
    """The ladder's throughput bound (field products' multiply-adds, or
    the inputs' bytes) and, beside it, its dependent-chain floor: one
    lane's `steps` sequential steps at LADDER_STEP_CHAIN dependent
    instructions of DEPENDENT_ISSUE_CLOCKS clocks, at the maximum SM clock."""
    from tendermintx_tpu_torch.ops.ed25519 import N_LIMBS

    products = lanes * (steps * LADDER_STEP_PRODUCTS + LADDER_LANE_PRODUCTS)
    squarings = lanes * steps * LADDER_STEP_SQUARINGS
    nbytes = lanes * (8 * (3 * 4 * N_LIMBS + steps + 2 * N_LIMBS) + 1)
    chain_ms = steps * LADDER_STEP_CHAIN * DEPENDENT_ISSUE_CLOCKS / (clock_mhz * 1e3)
    return {**_ops_bound(products * FE_MACS + squarings * FE_SQ_MACS, nbytes, ops_per_ms),
            "field_products": products, "field_squarings": squarings,
            "chain_floor_ms": chain_ms, "step_chain_instructions": LADDER_STEP_CHAIN}



def _bind_bound(lanes: int, ops_per_ms: float, clock_mhz: float) -> dict:
    """Every input read once (the ladder's, the signature bytes, the
    digest, k_q), one flag written; or the field products' and k_q L's
    multiply-adds. Beside it the dependent-chain floor, as the ladder's:
    BIND_CHAIN dependent instructions of DEPENDENT_ISSUE_CLOCKS clocks at
    the maximum SM clock."""
    from tendermintx_tpu_torch.ops.ed25519 import N_BITS, N_LIMBS

    nbytes = lanes * (8 * (3 * 4 * N_LIMBS + N_BITS + 3 * N_LIMBS) + 3 * 32 + 64 + 1)
    macs = BIND_PRODUCTS * FE_MACS + BIND_SQUARINGS * FE_SQ_MACS + BIND_MOD_L_MACS
    return {**_ops_bound(lanes * macs, nbytes, ops_per_ms),
            "chain_floor_ms": BIND_CHAIN * DEPENDENT_ISSUE_CLOCKS / (clock_mhz * 1e3),
            "chain_instructions": BIND_CHAIN}


def _challenge_bound(sig_r: torch.Tensor, sig_pk: torch.Tensor, messages: torch.Tensor, msg_len: torch.Tensor,
                     ops_per_ms: float, clock_mhz: float) -> dict:
    """The challenge's bound over what this call's lanes need: each lane's
    active blocks (by its clamped byte length) at SHA512_OPS_PER_BLOCK, or
    R, A, msg_len and the message bytes below each length read once and
    the digests written; its dependent-chain floor beside, the longest
    lane's compressions of 80 rounds of SHA512_ROUND_CHAIN dependent
    instructions of DEPENDENT_ISSUE_CLOCKS clocks."""
    from tendermintx_tpu_torch.ops.sha512 import challenge_byte_len

    width = int(messages.shape[1])
    byte_len = challenge_byte_len(msg_len, width)
    blocks = (byte_len + 17 + 127) // 128
    compressions = int(blocks.sum())
    nbytes = int(sig_r.shape[0]) * (32 + 32 + 8 + 64) + int(torch.clamp(byte_len - 64, 0, width).sum())
    chain_ms = int(blocks.max()) * 80 * SHA512_ROUND_CHAIN * DEPENDENT_ISSUE_CLOCKS / (clock_mhz * 1e3)
    return {**_ops_bound(compressions * SHA512_OPS_PER_BLOCK, nbytes, ops_per_ms), "compressions": compressions,
            "chain_floor_ms": chain_ms}


class _WitnessCheck:
    """While installed, holds every call of the seven witness wrappers
    (ops/sha256.py, circuits/gadgets.py, ops/sha512.py, ops/ed25519.py:
    *_cuda) exactly against
    its plain twin on the same CUDA tensors, and keeps the first inputs of
    each shape (name -> {shape: args}). The twins' launches are not
    counted."""

    def __init__(self):
        self.calls: dict = {name: {} for name in WITNESS_ENTRIES}
        self.checked = dict.fromkeys(WITNESS_ENTRIES, 0)

    def __enter__(self):
        from tendermintx_tpu_torch.circuits import gadgets
        from tendermintx_tpu_torch.ops import ed25519 as ed
        from tendermintx_tpu_torch.ops import sha256, sha512

        self.saved = []
        rows = lambda a: tuple(a[0].shape)
        for name, mod, cuda, plain, key in (
            ("sha256_blocks", sha256, "sha256_blocks_cuda", sha256.sha256_blocks_plain, lambda a: tuple(a[0].shape[:2])),
            *((name, gadgets, cuda, getattr(gadgets, plain), rows) for name, (cuda, plain) in SHA256_GADGETS.items()),
            ("sha512_blocks", sha512, "sha512_blocks_cuda", sha512.sha512_blocks_plain, lambda a: tuple(a[0].shape[:2])),
            ("sha512_challenge", sha512, "sha512_challenge_cuda", sha512.sha512_challenge_plain,
             lambda a: tuple(a[2].shape)),
            ("straus_verify", ed, "straus_verify_cuda", ed.straus_verify_plain, lambda a: tuple(a[3].shape)),
            ("bind_witness", ed, "bind_witness_cuda", ed.bind_witness_plain, lambda a: tuple(a[3].shape)),
        ):
            kernel = getattr(mod, cuda)
            self.saved.append((mod, cuda, kernel))

            def checked(*args, name=name, kernel=kernel, plain=plain, key=key):
                got = kernel(*args)
                want = plain(*args)
                _check_equal(got.to(torch.int64), want.to(torch.int64), f"{name} at {key(args)}")
                self.calls[name].setdefault(key(args), args)
                self.checked[name] += 1
                return got

            setattr(mod, cuda, checked)
        return self

    def __exit__(self, *exc):
        for mod, cuda, kernel in self.saved:
            setattr(mod, cuda, kernel)


def _sha_edge_cases(kind: str, gen, dev) -> list[dict]:
    """Random words (SHA-256: below 2^32; SHA-512: any int64) at B = 1, 7
    and 129 lanes of 1 and 2 blocks, n_active cycling through -1, 0, 1,
    n_blocks and n_blocks + 3, each held exactly against the plain twin."""
    from tendermintx_tpu_torch.ops import sha256, sha512

    kernel, plain = ((sha256.sha256_blocks_cuda, sha256.sha256_blocks_plain) if kind == "sha256"
                     else (sha512.sha512_blocks_cuda, sha512.sha512_blocks_plain))
    cases = []
    for lanes in (1, 7, 129):
        for n_blocks in (1, 2):
            half = lambda: torch.randint(0, 1 << 32, (lanes, n_blocks, 16), generator=gen, device=dev)
            words = half() if kind == "sha256" else (half() << 32) | half()
            cycle = torch.tensor([-1, 0, 1, n_blocks, n_blocks + 3], device=dev)
            n_active = cycle[(torch.arange(lanes, device=dev) + lanes) % 5].contiguous()
            _check_equal(kernel(words, n_active), plain(words, n_active), f"{kind} edge case {lanes} x {n_blocks}")
            cases.append({"lanes": lanes, "n_blocks": n_blocks, "n_active": sorted(set(n_active.tolist())),
                          "max_abs_err": 0.0})
    return cases


def _challenge_edge_cases(gen, dev) -> list[dict]:
    """csrc/sha.cu's challenge on random bytes (past each length too, which
    the padding must mask) at B = 1, 7, 33 and 129 lanes (a block of 32
    lanes, ragged), message widths 0, 124 (the witness's) and 300 (three
    blocks: a schedule slot reused), msg_len cycling through the edges 0,
    1, 47, 48, W - 1 and W (one and two blocks at W = 124) in one call and
    outside [0, W] in another: -2^40, -65, -64 and -1 (a prefix of R || A,
    none at -64 and below), W + 1, the clamp's last length 128 n - 81 and
    the first past it, 2^40. Each call held exactly against its twin."""
    from tendermintx_tpu_torch.ops import sha512

    cases = []
    for width in (0, MESSAGE_WIDTH, 300):
        cap = 128 * sha512.challenge_blocks(width) - 81
        edges = {"inside": sorted({0, 1, 47, 48, width - 1, width} & set(range(width + 1))),
                 "outside": [-(1 << 40), -65, -64, -1, width + 1, cap, cap + 1, 1 << 40]}
        for lanes in (1, 7, 33, 129):
            rand = lambda *shape: torch.randint(0, 256, shape, generator=gen, device=dev).to(torch.uint8)
            sig_r, sig_pk, msgs = rand(lanes, 32), rand(lanes, 32), rand(lanes, width)
            for where, lens in edges.items():
                msg_len = torch.tensor(lens, device=dev)[(torch.arange(lanes, device=dev) + lanes) % len(lens)]
                _check_equal(sha512.sha512_challenge_cuda(sig_r, sig_pk, msgs, msg_len),
                             sha512.sha512_challenge_plain(sig_r, sig_pk, msgs, msg_len),
                             f"sha512_challenge at {lanes} lanes x {width} bytes, msg_len {where} [0, W]")
                cases.append({"lanes": lanes, "width": width, "msg_len": sorted(set(msg_len.tolist())),
                              "max_abs_err": 0.0})
    return cases


def _sha256_gadget_cases(gen, dev) -> dict:
    """csrc/sha.cu's tree and proof entries on random bytes, each call held
    exactly against its twin (circuits/gadgets.py): validator trees of 1,
    5, 100 and 128 lanes (5 and 100 padded to 8 and 128 rows) at n_enabled
    0, 1, odd, even and B, leaf lengths 1 to 55 (55 in lane 0: one block's
    most, past the 47-byte row) with bytes past each length that the
    padding must mask; header proofs of 1, 5 and 33 (two blocks of 32
    threads) with leaves of one and two blocks (55 and 119 bytes) and path
    bits both ways (all 0, all 1, and a 2, which is a left child).
    -> {entry: [case, ...]}."""
    from tendermintx_tpu_torch.circuits import gadgets as g

    rand = lambda high, *shape: torch.randint(0, high, shape, generator=gen, device=dev)
    out = {"sha256_validator_root": [], "sha256_header_proofs": []}
    for lanes in (1, 5, 100, 128):
        data = rand(256, lanes, VALIDATOR_LEAF_WIDTH).to(torch.uint8)
        lens = (rand(55, lanes) + 1).index_fill_(0, torch.tensor([0], device=dev), 55)
        counts = sorted({0, 1, lanes, lanes // 2, (lanes // 2) | 1} & set(range(lanes + 1)))
        for n in counts:
            n_t = torch.tensor(n, device=dev)
            _check_equal(g.validator_root_cuda(data, lens, n_t), g.validator_root_plain(data, lens, n_t),
                         f"sha256_validator_root at {lanes} lanes, n_enabled {n}")
        out["sha256_validator_root"].append({"lanes": lanes, "n_enabled": counts, "max_abs_err": 0.0})
    for k in (1, 5, 33):
        data = rand(256, k, HEADER_LEAF_WIDTH).to(torch.uint8)
        lens = rand(119, k) + 1
        lens[0] = 119
        bits = rand(2, k, HEADER_PROOF_DEPTH)
        bits[0] = 0
        if k > 1:
            lens[1] = 55
            bits[1] = 1
            bits[-1, 2] = 2
        args = (data, lens, rand(256, k, HEADER_PROOF_DEPTH, 32).to(torch.uint8), bits)
        _check_equal(g.header_proofs_cuda(*args), g.header_proof_root_plain(*args),
                     f"sha256_header_proofs at {k} proofs")
        out["sha256_header_proofs"].append({"proofs": k, "leaf_len": sorted(set(lens.tolist())), "max_abs_err": 0.0})
    return out


def phase_witness(sc: SkipChain, build: dict) -> dict:
    """The witness programs' kernels on the card (part of the kernels
    line). skip_verify (skip 2 -> 6) and step_verify (4 -> 5) at N=128
    run with every call of the wrappers held exactly against its plain
    twin (_WitnessCheck): every shape these paths give them, on their own
    data; the calls (_witness_launches) and the tree and proof entries'
    byte rows (_witness_sha256_shapes) must be circuits/verify.py's
    structure's. Then the SHA entries on random words at ragged lane
    counts with n_active 0, below and above the block count
    (_sha_edge_cases), the challenge on random bytes at its edge lengths
    (_challenge_edge_cases), the tree and proof entries on random trees
    and proofs (_sha256_gadget_cases), and the ladder and the binding on
    lanes with both outcomes (_witness_cases). sha256_blocks, which no
    witness program calls now, is checked and timed at a lane-check shard
    of the mesh phase (N / MESH_SHARDS leaves, one block), and
    sha512_blocks at the skip's challenge blocks (N lanes, two blocks, as
    the reference's byte assembly pads them). Each entry is timed at its
    N=128 shapes (the median of five rounds) beside its plain twin and its
    bound; the ladder's, the binding's, the challenge's and the tree and
    proof entries' dependent-chain floors beside their bounds."""
    from tendermintx_tpu_torch.circuits import gadgets
    from tendermintx_tpu_torch.circuits.variables import pack_skip_witness, pack_step_witness
    from tendermintx_tpu_torch.circuits.verify import chain_id_leaf_const, skip_verify, step_verify
    from tendermintx_tpu_torch.ops import ed25519 as ed
    from tendermintx_tpu_torch.ops import sha256, sha512

    dev = torch.device(RUNTIME_DEVICE)
    clock_mhz = float(_nvidia_smi("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_per_ms = MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e3
    cl, cn = chain_id_leaf_const(CHAIN_ID)
    trusted, _, skip_inputs = sc.skip(2, 6)
    prev, step_inputs = sc.step(4)
    skip_witness = pack_skip_witness(skip_inputs).to(dev)
    runs = {
        "skip": lambda: skip_verify(skip_witness, torch.frombuffer(bytearray(trusted), dtype=torch.uint8),
                                    2, 0, 6, 0, cl, cn, SKIP_MAX)[0],
        "step": lambda: step_verify(pack_step_witness(step_inputs).to(dev),
                                    torch.frombuffer(bytearray(prev), dtype=torch.uint8), 4, 0, cl, cn)[0],
    }
    out = {"phase": "witness"}
    with _WitnessCheck() as check:
        for kind, run in runs.items():
            before = dict(check.checked)
            if not bool(run()):
                raise AssertionError(f"the N={sc.n} {kind}_verify rejected a valid witness")
            n_calls = {k: check.checked[k] - before[k] for k in WITNESS_ENTRIES}
            if n_calls != _witness_launches(sc.n, kind):
                raise AssertionError(f"the N={sc.n} {kind}_verify called the witness kernels {n_calls} times; "
                                     f"its structure gives {_witness_launches(sc.n, kind)}")
            out[f"{kind}_calls"] = n_calls
        for name in SHA256_GADGETS:
            want = _witness_sha256_shapes(sc.n, "skip")[name] | _witness_sha256_shapes(sc.n, "step")[name]
            if set(check.calls[name]) != want:
                raise AssertionError(f"the N={sc.n} witness programs call {name} at {sorted(check.calls[name])}; "
                                     f"their structure gives {sorted(want)}")
        # a lane-check shard's leaves (parallel/sharding.py hashes each
        # shard's with sha256_blocks), checked as the programs' calls are
        shard = sc.n // MESH_SHARDS
        lanes = skip_witness.lanes
        sha256.sha256_blocks_cuda(*gadgets.bytes_to_blocks(lanes.leaf_bytes[:shard], lanes.leaf_len[:shard], 1))
        # the skip's challenge blocks, as the reference pads them
        width = int(lanes.messages.shape[1])
        sha512.sha512_blocks_cuda(*sha512.bytes_to_blocks512(
            torch.cat([lanes.sig_r, lanes.sig_pubkeys, lanes.messages], 1),
            sha512.challenge_byte_len(lanes.msg_len, width), sha512.challenge_blocks(width)))
        calls = check.calls
    out["checked_calls"] = check.checked
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    edges = {kind: _sha_edge_cases(kind, gen, dev) for kind in ("sha256", "sha512")}
    edges["sha512_challenge"] = _challenge_edge_cases(gen, dev)
    edges.update(_sha256_gadget_cases(gen, dev))
    ladder, bind = _witness_cases(dev)
    outcomes = {}
    for name, kernel, plain, args in (("straus_verify", ed.straus_verify_cuda, ed.straus_verify_plain, ladder),
                                      ("bind_witness", ed.bind_witness_cuda, ed.bind_witness_plain, bind)):
        got, want = kernel(*args), plain(*args)
        _check_equal(got.to(torch.int64), want.to(torch.int64), f"{name} on the tampered lanes")
        outcomes[name] = got.tolist()
        if all(outcomes[name]) or not any(outcomes[name]):
            raise AssertionError(f"{name}'s check lanes all have one outcome: {outcomes[name]}")

    def timed(kernel, plain, args, burst) -> dict:
        rounds = _time_rounds(lambda: kernel(*args), 20)
        _, plain_ms = _timed_once(lambda: plain(*args))
        return {**rounds, "burst_ms": _launch_burst_ms(*burst, lambda: kernel(*args)), "plain_ms": plain_ms}

    sha_burst, ed_burst = (sha256, "sha_launch", "_sha_library"), (ed, "_ed_launch", "_ed_library")
    row_keys = ("shape", "ms", "ms_min", "ms_max", "burst_ms", "plain_ms", "bound_ms", "bound_by",
                "operations_bound_ms", "bytes_bound_ms", "max_abs_err")
    sha_common = {"route": "cuda", "source": "tendermintx_tpu_torch/csrc/sha.cu", "library_ms": None}

    sha_rows = {}
    for name, kind, mod, kernel, plain in (
        ("sha256_blocks", "sha256", sha256, sha256.sha256_blocks_cuda, sha256.sha256_blocks_plain),
        ("sha512_blocks", "sha512", sha512, sha512.sha512_blocks_cuda, sha512.sha512_blocks_plain),
    ):
        shapes = []
        for shape, args in sorted(calls[name].items(), key=lambda kv: (-kv[0][0], -kv[0][1])):
            shapes.append({"shape": [*shape, 16], **timed(kernel, plain, args, sha_burst),
                           **_sha_bound(kind, *args, ops_per_ms), "max_abs_err": 0.0})
        top = shapes[0]  # SHA-256's lane-check shard, SHA-512's challenge blocks
        sha_rows[name] = {
            **sha_common, "replaces": f"tendermintx_tpu/ops/{kind}.py:{82 if kind == 'sha256' else 143}",
            "replaces_program": f"{kind}_blocks (jitted as {kind}_blocks_jit)",
            **{k: top[k] for k in row_keys}, **_registers_of(build["sha"]["ptxas"], f"tmx_{kind}"),
            "shapes": shapes, "edge_cases": edges[kind],
        }
    # the challenge at the programs' one shape (the skip's lanes; the
    # step's are as many)
    (cshape, chal_args), = calls["sha512_challenge"].items()
    sha_rows["sha512_challenge"] = {
        **sha_common, "replaces": "tendermintx_tpu/ops/ed25519.py:536",
        "replaces_program": "verify_bound's byte assembly (:536-541: the concatenation, sha512.py:160 "
                            "bytes_to_blocks512, :193 digest_words_to_bytes_dev) and sha512.py:143 sha512_blocks, "
                            "in verify_bound (:524), jitted whole",
        "shape": list(cshape),
        **timed(sha512.sha512_challenge_cuda, sha512.sha512_challenge_plain, chal_args, sha_burst),
        **_challenge_bound(*chal_args, ops_per_ms, clock_mhz), "max_abs_err": 0.0,
        **_registers_of(build["sha"]["ptxas"], "tmx_sha512_challenge"), "edge_cases": edges["sha512_challenge"],
    }
    # the validator tree at the skip's target set (the trusted set's and
    # the step's have the same shape); the header proofs at the skip's 4
    # and the step's 5
    (tshape, tree_args), = calls["sha256_validator_root"].items()
    sha_rows["sha256_validator_root"] = {
        **sha_common, "replaces": "tendermintx_tpu/circuits/gadgets.py:94",
        "replaces_program": "merkle_root_dynamic over hash_validator_leaves (:89), traced into the jitted "
                            "skip / step verification",
        "shape": list(tshape), "n_enabled": int(tree_args[2]),
        **timed(gadgets.validator_root_cuda, gadgets.validator_root_plain, tree_args, sha_burst),
        **_tree_bound(*tree_args, ops_per_ms, clock_mhz), "max_abs_err": 0.0,
        **_registers_of(build["sha"]["ptxas"], "tmx_sha256_root"), "edge_cases": edges["sha256_validator_root"],
    }
    proofs = []
    for shape, args in sorted(calls["sha256_header_proofs"].items()):
        proofs.append({"shape": list(shape), **timed(gadgets.header_proofs_cuda, gadgets.header_proof_root_plain,
                                                     args, sha_burst),
                       **_proofs_bound(args[1], int(shape[1]), ops_per_ms, clock_mhz), "max_abs_err": 0.0})
    sha_rows["sha256_header_proofs"] = {
        **sha_common, "replaces": "tendermintx_tpu/circuits/gadgets.py:123",
        "replaces_program": "header_proof_root, traced into the jitted skip / step verification",
        **{k: proofs[0][k] for k in row_keys}, "chain_floor_ms": proofs[0]["chain_floor_ms"],
        **_registers_of(build["sha"]["ptxas"], "tmx_sha256_proofs"), "shapes": proofs,
        "edge_cases": edges["sha256_header_proofs"],
    }
    (lshape, ladder_args), = calls["straus_verify"].items()
    (_, bind_args), = calls["bind_witness"].items()
    lanes, steps = lshape
    ed_common = {"route": "cuda", "source": "tendermintx_tpu_torch/csrc/ed25519.cu", "library_ms": None,
                 "max_abs_err": 0.0}
    rows = {
        **sha_rows,
        "straus_verify": {
            **ed_common, "replaces": "tendermintx_tpu/ops/ed25519.py:312",
            "replaces_program": "straus_verify (jitted as straus_verify_jit)", "shape": [lanes, steps],
            **timed(ed.straus_verify_cuda, ed.straus_verify_plain, ladder_args, ed_burst),
            **_ladder_bound(lanes, steps, ops_per_ms, clock_mhz),
            **_registers_of(build["ed25519"]["ptxas"], "tmx_straus"), "check_lanes": outcomes["straus_verify"],
        },
        "bind_witness": {
            **ed_common, "replaces": "tendermintx_tpu/ops/ed25519.py:448",
            "replaces_program": "bind_witness (in verify_bound, :524, jitted whole)", "shape": [lanes],
            **timed(ed.bind_witness_cuda, ed.bind_witness_plain, bind_args, ed_burst),
            **_bind_bound(lanes, ops_per_ms, clock_mhz),
            **_registers_of(build["ed25519"]["ptxas"], "tmx_bind"), "check_lanes": outcomes["bind_witness"],
        },
    }
    for row in rows.values():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if "chain_floor_ms" in row:
            row["chain_floor_share"] = row["chain_floor_ms"] / row["ms"]
    out.update(rows)
    emit(out)
    return rows


def phase_kernels(build: dict) -> dict:
    """Each Poseidon entry against its plain torch version on the same
    CUDA tensors (exact: integer field arithmetic) and the host oracle,
    the quotient tape kernel against its plain twin and the DeviceAlgebra
    evaluation for every AIR of the N=128 paths, each NTT entry at every
    transform of the N=128 paths and the DEEP kernel at each AIR's shard
    against their plain versions, each with its time, its plain
    version's, and its bound."""
    from tendermintx_tpu_torch.ops import poseidon as ps

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    clock_mhz = float(_nvidia_smi("clocks.max.sm"))
    rows = {
        "poseidon_permute": _kernel_permute(ps, rng, dev, clock_mhz),
        "poseidon_sponge_cols": _kernel_sponge(ps, rng, dev, clock_mhz),
        "poseidon_merkle_layer": _kernel_layer(ps, rng, dev, clock_mhz),
        "quotient": _kernel_quotient(dev, clock_mhz, build["quotient"]["ptxas"]),
        "ntt": _kernel_ntt(dev, clock_mhz, build["ntt"]["ptxas"]),
        "deep": _kernel_deep(dev, clock_mhz, build["deep"]["ptxas"]),
        **_kernel_ood(dev, clock_mhz, build["ood"]["ptxas"]),
        **_kernel_logup(dev, clock_mhz, build["logup"]["ptxas"]),
        **_kernel_fri(dev, clock_mhz, build["fri"]["ptxas"]),
    }
    for row in rows.values():
        row["bound_share"] = row["bound_ms"] / row["ms"]
    for name in ("poseidon_permute", "poseidon_sponge_cols", "poseidon_merkle_layer"):
        rows[name]["design_bound_share"] = rows[name]["design_bound_ms"] / rows[name]["ms"]
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


# kernel entry -> (module of its wrapper, launch counter)
LAUNCH_COUNTERS = {
    "poseidon_permute": ("tendermintx_tpu_torch.ops.poseidon", "permute_kernel_launches"),
    "poseidon_sponge_cols": ("tendermintx_tpu_torch.ops.poseidon", "sponge_kernel_launches"),
    "poseidon_merkle_layer": ("tendermintx_tpu_torch.ops.poseidon", "layer_kernel_launches"),
    "quotient": ("tendermintx_tpu_torch.stark.quotient_tape", "quotient_kernel_launches"),
    "ntt_forward": ("tendermintx_tpu_torch.ops.ntt", "ntt_kernel_launches"),
    "ntt_inverse": ("tendermintx_tpu_torch.ops.ntt", "intt_kernel_launches"),
    "ntt_coset_lde": ("tendermintx_tpu_torch.ops.ntt", "lde_kernel_launches"),
    "deep": ("tendermintx_tpu_torch.stark.prover", "deep_kernel_launches"),
    "ext_powers": ("tendermintx_tpu_torch.stark.prover", "ext_powers_kernel_launches"),
    "ood_eval": ("tendermintx_tpu_torch.stark.prover", "ood_kernel_launches"),
    "deep_inverses": ("tendermintx_tpu_torch.stark.prover", "deep_inverses_kernel_launches"),
    "logup_terms": ("tendermintx_tpu_torch.stark.lookup", "logup_terms_kernel_launches"),
    "logup_scan": ("tendermintx_tpu_torch.stark.lookup", "logup_scan_kernel_launches"),
    "fri_fold": ("tendermintx_tpu_torch.stark.fri", "fri_fold_kernel_launches"),
    "fri_inject": ("tendermintx_tpu_torch.stark.fri", "fri_inject_kernel_launches"),
    "sha256_blocks": ("tendermintx_tpu_torch.ops.sha256", "sha256_kernel_launches"),
    "sha256_validator_root": ("tendermintx_tpu_torch.circuits.gadgets", "validator_root_kernel_launches"),
    "sha256_header_proofs": ("tendermintx_tpu_torch.circuits.gadgets", "header_proofs_kernel_launches"),
    "sha512_blocks": ("tendermintx_tpu_torch.ops.sha512", "sha512_kernel_launches"),
    "sha512_challenge": ("tendermintx_tpu_torch.ops.sha512", "sha512_challenge_kernel_launches"),
    "straus_verify": ("tendermintx_tpu_torch.ops.ed25519", "straus_kernel_launches"),
    "bind_witness": ("tendermintx_tpu_torch.ops.ed25519", "bind_kernel_launches"),
    "eval_aux": ("tendermintx_tpu_torch.stark.evalair", "eval_aux_kernel_launches"),
    "poseidon_expand": ("tendermintx_tpu_torch.ops.poseidon", "expand_kernel_launches"),
    "poseidon_grind": ("tendermintx_tpu_torch.ops.poseidon", "grind_kernel_launches"),
}
# the rows of the kernels line that sum several counted entries of one
# kernel: csrc/ntt.cu's forward, inverse and coset LDE entries
KERNEL_ENTRIES = {"ntt": ("ntt_forward", "ntt_inverse", "ntt_coset_lde")}
# entries no prove runs: the forward NTT is the mesh phase's four-step
# NTT's (its launches are checked there); a prove's LDEs are the inverse
# and coset LDE entries
NOT_PROVED_BY = ("ntt_forward",)
# the LogUp kernels run only where an Ed25519 statement is proven: not in
# the hash bundles or the wrap
LOGUP_ENTRIES = ("logup_terms", "logup_scan")
# the hash bundles' single-statement FRI injects nothing
NOT_INJECTED_BY = ("fri_inject",)
# the recursion wrap's kernels (EvalAir's aux columns, WrapAir's round
# states): only a path that wraps launches them
WRAP_ENTRIES = ("eval_aux", "poseidon_expand")


class _NttCalls:
    """Every transform the NTT kernel's wrapper is asked for while
    installed, as (entry, rows, log2 n, rate) with the coset iNTT apart,
    and the pass kernels ntt_plan gives each entry for them: each path's
    expected launches, derived from the plan."""

    ENTRY = {"ntt": "ntt_forward", "intt": "ntt_inverse", "coset_lde": "ntt_coset_lde"}

    def __init__(self):
        self.calls: list[tuple] = []
        self.planned = dict.fromkeys(self.ENTRY.values(), 0)

    def install(self):
        from tendermintx_tpu_torch.ops import ntt

        launch = ntt._launch

        def recorded(entry, x, rate_bits=0, shift=1, powers=None):
            n = int(x.shape[-1])
            rows = x.numel() // max(1, n)
            if rows:
                log_n, rate = n.bit_length() - 1, rate_bits if entry == "coset_lde" else 0
                kind = "coset_intt" if entry == "intt" and powers is not None else entry
                self.calls.append((kind, rows, log_n, rate))
                self.planned[self.ENTRY[entry]] += len(_ntt_plan_of(entry, log_n, rate))
            return launch(entry, x, rate_bits, shift, powers)

        ntt._launch = recorded


NTT_CALLS = _NttCalls()


def _launch_counts() -> dict:
    import importlib

    counts = {name: getattr(importlib.import_module(mod), counter)
              for name, (mod, counter) in LAUNCH_COUNTERS.items()}
    counts.update({f"{e}_planned": n for e, n in NTT_CALLS.planned.items()})
    return counts


def _reset_launch_counts():
    import importlib

    for mod, counter in LAUNCH_COUNTERS.values():
        setattr(importlib.import_module(mod), counter, 0)
    NTT_CALLS.planned = dict.fromkeys(NTT_CALLS.planned, 0)


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


def _check_launched(launches: dict, path: str, absent: tuple = (), witness: bool = False, wrap: bool = False):
    """Every kernel launched by the path, but those of `absent`, which
    must not be; the witness programs' kernels only on a `witness` path
    (no prove runs them), and NOT_IN_PROGRAMS' on none (sha256_blocks
    runs only in the mesh's lane checks, sha512_blocks on no path); the
    wrap's only on a path that wraps."""
    absent = absent + NOT_IN_PROGRAMS if witness else absent + WITNESS_ENTRIES
    absent = absent if wrap else absent + WRAP_ENTRIES
    for name, n in launches.items():
        if name in absent:
            if n:
                raise AssertionError(f"kernel {name} was launched {n} times by the {path} path, which runs none")
        elif n <= 0 and name not in NOT_PROVED_BY and not name.endswith("_planned"):
            raise AssertionError(f"kernel {name} was not launched by the {path} path")
    _check_ntt_plan(launches, path)


def _check_witness_launches(launches: dict, n_validators: int, kind: str, what: str):
    """A skip_verify or step_verify of n_validators lanes launched each
    witness kernel exactly as its structure gives (_witness_launches)."""
    got = {k: launches[k] for k in WITNESS_ENTRIES}
    if got != _witness_launches(n_validators, kind):
        raise AssertionError(f"the {what} launched the witness kernels {got}; "
                             f"{kind}_verify at N={n_validators} gives {_witness_launches(n_validators, kind)}")


def _check_ntt_plan(launches: dict, path: str):
    """Each NTT entry launched the pass kernels ntt_plan gives the
    transforms the path asked of it."""
    for e in KERNEL_ENTRIES["ntt"]:
        if launches[e] != launches[f"{e}_planned"]:
            raise AssertionError(f"the {path} path launched {e} {launches[e]} times; its transforms' plans "
                                 f"give {launches[f'{e}_planned']}")


def _check_ood_launches(launches: dict, statements: int, ed25519: int, path: str):
    """A statement's OOD is one ood_eval call (its slice and sum kernels:
    two launches) and two ext_powers launches (alpha's powers and the
    opening points'), its DEEP inverses one launch (on the mesh's first
    device); each Ed25519 statement launches the LogUp terms kernel once
    and one logup_scan call (its tile-sum and scan kernels: two)."""
    want = {"ood_eval": 2 * statements, "deep_inverses": statements, "ext_powers": 2 * statements,
            "logup_terms": ed25519, "logup_scan": 2 * ed25519}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"the {path} path has {statements} statements ({ed25519} Ed25519) and "
                             f"launched {got}; {want} wanted")


def _grind_spans(proof, pow_bits: int) -> int:
    """The grinding launches of one FRI proof on the card: one a span of
    GRIND_SPAN candidates searched up to its nonce; none at 0 bits."""
    from tendermintx_tpu_torch.stark.fri import GRIND_SPAN

    return proof.pow_nonce // GRIND_SPAN + 1 if pow_bits else 0


def _check_fri_launches(launches: dict, fris: list, sizes: int, path: str, shards: int = 1):
    """FRI proofs, (proof, n_max, pow_bits) each over codewords of at most
    n_max values, fold once a committed layer (once a shard where a mesh of
    `shards` shards the layer: at least 4 values a shard), inject once
    a codeword size of a batch (`sizes` in all; none in a
    single-statement FRI) and grind once a span searched."""
    folds = sum(shards if shards > 1 and (n_max >> l) >= 4 * shards else 1
                for proof, n_max, _ in fris for l in range(len(proof.layer_caps)))
    want = {"fri_fold": folds, "fri_inject": sizes,
            "poseidon_grind": sum(_grind_spans(proof, bits) for proof, _, bits in fris)}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"the {path} path launched {got}; its FRI layers and codeword sizes give {want}")


def _check_batch_fri(launches: dict, batch, config, path: str, shards: int = 1):
    """_check_fri_launches for one BatchStarkProof at its StarkConfig."""
    rows = {st.n_rows for st in batch.statements}
    _check_fri_launches(launches, [(batch.fri_proof, max(rows) << config.rate_bits, config.proof_of_work_bits)],
                        len(rows), path, shards)


def _check_wrap_launches(launches: dict, wraps: int, path: str):
    """A wrap on the card launches EvalAir's aux kernel once and WrapAir's
    round-state kernel once."""
    want = {"eval_aux": wraps, "poseidon_expand": wraps}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"the {path} path launched {got}; {wraps} wrap(s) give {want}")


def _check_deep_launches(launches: dict, statements: int, shards: int, path: str):
    """The card's DEEP composition is one launch a shard a statement."""
    if launches["deep"] != statements * shards:
        raise AssertionError(f"the {path} prove has {statements} statements over {shards} shard(s) "
                             f"and {launches['deep']} DEEP launches")


def phase_slice(sc: SkipChain) -> tuple[dict, dict, object]:
    from tendermintx_tpu_torch.circuits.composite import DEFAULT_COMPOSITE_CONFIG

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    cold, cold_proof = _prove_and_verify(sc, 1, 5)
    cold_launches = _launch_counts()
    first_call = len(NTT_CALLS.calls)
    warm, warm_proof = _prove_and_verify(sc, 2, 6)
    launches = _launch_counts()
    warm_ntt_calls = NTT_CALLS.calls[first_call:]
    warm_launches = {k: launches[k] - cold_launches[k] for k in launches}
    _check_launched(cold_launches, "cold skip")
    _check_launched(warm_launches, "warm skip")
    counts = {"sha256": warm_proof.n_hash_segments, "ed25519": warm_proof.n_ed_segments,
              "sha512": warm_proof.n_sha512_blocks}
    if counts != N128_SKIP_STATEMENTS:
        raise AssertionError(f"the warm skip proves {counts}, the quotient check {N128_SKIP_STATEMENTS}")
    # one quotient launch per statement (one device: one shard each)
    n_stmts = len(warm_proof.batch.statements)
    if warm_launches["quotient"] != n_stmts or cold_launches["quotient"] != n_stmts:
        raise AssertionError(
            f"{n_stmts} statements with {cold_launches['quotient']} / {warm_launches['quotient']} "
            "quotient launches (cold / warm); the card's quotient is one launch per shard"
        )
    _check_deep_launches(warm_launches, n_stmts, 1, "warm skip")
    _check_deep_launches(cold_launches, n_stmts, 1, "cold skip")
    _check_ood_launches(warm_launches, n_stmts, 1, "warm skip")
    _check_ood_launches(cold_launches, n_stmts, 1, "cold skip")
    _check_batch_fri(warm_launches, warm_proof.batch, DEFAULT_COMPOSITE_CONFIG, "warm skip")
    _check_batch_fri(cold_launches, cold_proof.batch, DEFAULT_COMPOSITE_CONFIG, "cold skip")
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
    return out, cold_launches, warm_launches, warm_proof, warm_ntt_calls


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
    _check_deep_launches(launches, len(proof.batch.statements), 1, "step")
    _check_ood_launches(launches, len(proof.batch.statements), 1, "step")
    _check_batch_fri(launches, proof.batch, DEFAULT_COMPOSITE_CONFIG, "step")
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
    _check_launched(launches, "hashes", absent=LOGUP_ENTRIES + NOT_INJECTED_BY)
    # two single-statement SHA-256 proves
    _check_ood_launches(launches, 2, 0, "hashes")
    rate = DEFAULT_HASH_CONFIG.rate_bits
    _check_fri_launches(launches, [(b.proof.fri_proof, b.proof.n_rows << rate, DEFAULT_HASH_CONFIG.proof_of_work_bits)
                                   for b in (skip, step)], 0, "hashes")

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


class _WrapCalls:
    """While installed: the inputs of the latest call of each shape of the
    wrap's kernel wrappers (stark/evalair.py: eval_aux_cuda, the trace,
    static rows and challenges; ops/poseidon.py: expand_cuda, the states)
    and every grinding span (ops/poseidon.py: grind_cuda) with its result,
    so that phase_wrap_kernels and phase_grind hold the kernels against
    their twins on what the paths gave them. `originals` are the
    wrappers, for those checks."""

    def __init__(self):
        self.eval: dict = {}
        self.expand: dict = {}
        self.grinds: list = []
        self.originals: dict = {}

    def install(self):
        from tendermintx_tpu_torch.ops import poseidon as ps
        from tendermintx_tpu_torch.ops.ext import GF2
        from tendermintx_tpu_torch.ops.goldilocks import GF
        from tendermintx_tpu_torch.stark import evalair as ev

        aux, expand, grind = ev.eval_aux_cuda, ps.expand_cuda, ps.grind_cuda
        self.originals = {"eval_aux": aux, "expand": expand, "grind": grind}
        copy = lambda g: GF2(GF(g.c0.v.clone()), GF(g.c1.v.clone()))

        def eval_aux(trace, rows, gamma, delta):
            self.eval[int(trace.v.shape[-1])] = (GF(trace.v.clone()), rows, copy(gamma), copy(delta))
            return aux(trace, rows, gamma, delta)

        def expand_states(states):
            self.expand[int(states.shape[0])] = states.clone()
            return expand(states)

        def grind_span(seed, pow_bits, start, span, device):
            nonce = grind(seed, pow_bits, start, span, device)
            self.grinds.append((seed, pow_bits, start, span, nonce))
            return nonce

        ev.eval_aux_cuda, ps.expand_cuda, ps.grind_cuda = eval_aux, expand_states, grind_span


WRAP_CALLS = _WrapCalls()
# the least field multiplies of an EvalAir row: a term's delta v0 and
# delta^2 v1 (2 each), its norm (2), its share of a batch inversion
# (BATCH_INV_MULS) and m conj(D) / N(D) (4); one inversion a launch
EVAL_TERM_MULS = 2 + 2 + 2 + 3 + 4


def _alone_ms(fn, reps: int = 50) -> float | None:
    """torch.profiler's device time of the port's kernels (names holding
    tmx_) over `reps` calls of `fn`, a call: the kernels alone, without
    the gaps between launches; None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages() if "tmx_" in e.key)
    return us / 1e3 / reps if us else None


def _planted_eval_case(trace, srows, delta, cells) -> tuple:
    """The EvalAir inputs with gamma equal to cell (k, r)'s a + delta v0 +
    delta^2 v1 for the first of `cells`, copied to the others' (k', r')
    (trace pair and address): every such term has a zero denominator."""
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.ops.goldilocks import GF, tensor_from_u64, tensor_to_u64

    v, rows = trace.v.clone(), srows.clone()
    (k, r), *others = cells
    for k2, r2 in others:
        v[2 * k2 : 2 * k2 + 2, r2] = v[2 * k : 2 * k + 2, r]
        rows[k2, r2] = rows[k, r]
    d = tensor_to_u64(torch.cat([delta.c0.v, delta.c1.v])).tolist()
    d2 = ((d[0] * d[0] + 7 * d[1] * d[1]) % GL_P, 2 * d[0] * d[1] % GL_P)
    v0, v1 = tensor_to_u64(v[2 * k : 2 * k + 2, r]).tolist()
    g = [(int(rows[k, r]) + d[0] * v0 + d2[0] * v1) % GL_P, (d[1] * v0 + d2[1] * v1) % GL_P]
    gamma = GF2(*(GF(tensor_from_u64(np.array([x], dtype=np.uint64), v.device)) for x in g))
    return GF(v), rows, gamma


def phase_wrap_kernels(rows: dict, build: dict, wrap_rows: list[int]) -> dict:
    """csrc/logup.cu's EvalAir kernel and csrc/poseidon.cu's round-state
    kernel on the inputs the wraps of the run gave them (WRAP_CALLS: the
    latest call of each shape, the N=128 wrap's and, where it differs, the
    card's N=4 parity wrap's), each held exactly against its plain twin on
    the whole output (eval_aux_plain's (10, n) aux rows, from two launches
    back to back, the look-back's scratch left zeroed; expand_plain: the
    106 columns); eval_aux also at the N=128 shape less 37 rows (a ragged
    last tile) and there with two zero denominators planted in one
    thread's rows; at the N=128 wrap's shapes (`wrap_rows`: WrapAir's and
    EvalAir's rows) each timed (the median of five rounds, a raw-launch
    burst and torch.profiler's kernel time alone for eval_aux) beside its
    plain twin's time and its bound. Adds rows eval_aux and
    poseidon_expand."""
    from tendermintx_tpu_torch.ops import poseidon as ps
    from tendermintx_tpu_torch.ops.goldilocks import GF
    from tendermintx_tpu_torch.stark import evalair as ev

    dev = torch.device("cuda", 0)
    clock_mhz = float(_nvidia_smi("clocks.max.sm"))
    muls_per_ms = MULS_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * clock_mhz * 1e3
    aux_fn, expand_fn = WRAP_CALLS.originals["eval_aux"], WRAP_CALLS.originals["expand"]
    wrap_n, eval_n = wrap_rows
    if eval_n not in WRAP_CALLS.eval or wrap_n not in WRAP_CALLS.expand:
        raise AssertionError(f"the N=128 wrap's shapes {wrap_rows} were not recorded: {list(WRAP_CALLS.eval)}, "
                             f"{list(WRAP_CALLS.expand)}")

    def check_eval(trace, srows, gamma, delta, what: str) -> torch.Tensor:
        n = int(trace.v.shape[-1])
        want = ev.eval_aux_plain(trace, srows, gamma, delta).v
        for _ in range(2):
            _check_equal(aux_fn(trace, srows, gamma, delta).v, want, f"eval_aux at {n} rows{what}")
        tiles, _ = ev._lookback_scratch(dev, -(-n // ev.EVAL_TILE))
        if bool(tiles.any()):
            raise AssertionError(f"eval_aux at {n} rows{what} left its look-back scratch non-zero")
        return want

    checked_eval, checked_expand = [], []
    for n, args in sorted(WRAP_CALLS.eval.items()):
        check_eval(*args, "")
        checked_eval.append({"rows": n, "max_abs_err": 0.0})
    trace, srows, gamma, delta = WRAP_CALLS.eval[eval_n]
    ragged = eval_n - 37
    check_eval(GF(trace.v[:, :ragged]), srows[:, :ragged].contiguous(), gamma, delta, " (ragged)")
    checked_eval.append({"rows": ragged, "ragged": True, "max_abs_err": 0.0})
    r = eval_n // 3 // ev.EVAL_TILE * ev.EVAL_TILE + 42  # a thread's first row; its next, r + EVAL_THREADS
    cells = [(1, r), (3, r + ev.EVAL_THREADS)]
    p_trace, p_rows, p_gamma = _planted_eval_case(trace, srows, delta, cells)
    want = check_eval(p_trace, p_rows, p_gamma, delta, " (planted zero denominators)")
    if any(int(want[2 * k + c, rr]) for k, rr in cells for c in (0, 1)):
        raise AssertionError("the planted zero denominators gave non-zero terms")
    checked_eval.append({"rows": eval_n, "planted_zero": cells, "max_abs_err": 0.0})
    for n, states in sorted(WRAP_CALLS.expand.items()):
        _check_equal(expand_fn(states), ps.expand_plain(states), f"poseidon_expand at {n} states")
        checked_expand.append({"rows": n, "max_abs_err": 0.0})

    n = eval_n
    run = lambda: aux_fn(trace, srows, gamma, delta)
    _timed_once(lambda: ev.eval_aux_plain(trace, srows, gamma, delta))
    _, aux_plain_ms = _timed_once(lambda: ev.eval_aux_plain(trace, srows, gamma, delta))
    aux = _time_rounds(run, 20)
    aux["burst_ms"] = _launch_burst_ms(ev, "_eval_launch", "_eval_library", run)
    aux["alone_ms"] = _alone_ms(run)
    states = WRAP_CALLS.expand[wrap_n]
    _, expand_plain_ms = _timed_once(lambda: ps.expand_plain(states))
    expand = _time_rounds(lambda: expand_fn(states), 20)
    # reads: the 8 trace and 8 static rows; writes: the 10 aux rows
    aux_bound = _field_bound(n * 4 * EVAL_TERM_MULS + INV_MULS, 8 * n * (8 + 8 + 10), muls_per_ms)
    expand_bound = _bound(wrap_n, 8 * wrap_n * (ps.WIDTH + ps.EXPAND_COLS), clock_mhz, EXPAND_MULS_PER_STATE,
                          DESIGN_EXPAND_MULS_PER_STATE, EXPAND_MDS_PRODUCTS_PER_STATE,
                          DESIGN_EXPAND_MDS_PRODUCTS_PER_STATE)
    out_rows = {
        "eval_aux": {
            "route": "cuda", "source": "tendermintx_tpu_torch/csrc/logup.cu",
            "replaces": "tendermintx_tpu/stark/evalair.py:945",
            "replaces_program": "_eval_terms_kernel (:945), _eval_scan_kernel (:966) and _eval_assemble_kernel (:987)",
            "library_ms": None, "library": "none: no PyTorch call computes GF(p^2) inverses or scans",
            "max_abs_err": 0.0, "checked": checked_eval, "shape": [8, n],
            "tiles": [ev.EVAL_TILE, -(-n // ev.EVAL_TILE)], "rows_a_thread": ev.EVAL_ROWS, **aux,
            "plain_ms": aux_plain_ms, **aux_bound, **_registers_of(build["logup"]["ptxas"], "tmx_eval_aux"),
        },
        "poseidon_expand": {
            "route": "cuda", "source": "tendermintx_tpu_torch/csrc/poseidon.cu",
            "replaces": "tendermintx_tpu/stark/recursion.py:220",
            "replaces_program": "expand_perm_states (jitted at :275 as _expand_jit)",
            "library_ms": None, "library": "none: no PyTorch call computes Poseidon rounds",
            "max_abs_err": 0.0, "checked": checked_expand, "shape": [wrap_n, ps.WIDTH], **expand,
            "plain_ms": expand_plain_ms, **expand_bound,
            **_registers_of(build["poseidon"]["ptxas"], "tmx_poseidon_expand"),
        },
    }
    for row in out_rows.values():
        row["bound_share"] = row["bound_ms"] / row["ms"]
    if out_rows["eval_aux"]["alone_ms"]:
        out_rows["eval_aux"]["alone_bound_share"] = aux_bound["bound_ms"] / out_rows["eval_aux"]["alone_ms"]
    emit({"phase": "wrap_kernels", **out_rows})
    rows.update(out_rows)
    return out_rows


# the pow_bits of the seed phase_grind searches past GRIND_PAST_NONCE
# candidates in one launch: several waves of the card's resident threads
GRIND_PAST_BITS = 20
GRIND_PAST_NONCE = 1 << 18


def _grind_burst_ms(seed: int, pow_bits: int, span: int, dev, reps: int = 200) -> float:
    """ms a launch of csrc/poseidon.cu's grinding search from a burst of
    raw C-entry calls on one span (each zeroes its scratch and launches; no
    read-back between them). The scratch starts zeroed, which also serves an
    earlier checkout's batch kernel (an atomicMin into its first word, its
    work the same whatever that word holds)."""
    from tendermintx_tpu_torch.ops import poseidon as ps

    scratch = torch.zeros((2,), dtype=torch.int64, device=dev)
    entry = ps._library().tmx_poseidon_grind
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry(seed, pow_bits, 0, span, scratch.data_ptr(), stream)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    errs = [entry(seed, pow_bits, 0, span, scratch.data_ptr(), stream) for _ in range(reps)]
    end.record()
    torch.cuda.synchronize()
    if any(errs):
        raise RuntimeError(f"tmx_poseidon_grind launch failed: CUDA error {max(errs)}")
    return start.elapsed_time(end) / reps


def phase_grind(rows: dict, build: dict) -> dict:
    """csrc/poseidon.cu's grinding kernel on every span the run's FRIs
    searched (WRAP_CALLS.grinds: every path's seeds), each launched again
    and held exactly against grind_plain over the same span on the card
    (the span's first hit or None, which must also be what the path got),
    each search's nonce accepted by check_grind; then a seed whose first
    hit at GRIND_PAST_BITS lies past GRIND_PAST_NONCE candidates, searched
    by fri.grind on the card in one launch and held to grind_plain over the
    same span. Timed (the median of five rounds through the wrapper, with
    its read-back, and a raw-launch burst) at the run's first 16-bit
    search beside grind_plain's time; the bound counts the candidates that
    search needs (its nonce + 1 permutations), the span's beside it. Adds
    the row poseidon_grind."""
    from tendermintx_tpu_torch.ops import poseidon as ps
    from tendermintx_tpu_torch.stark import fri

    dev = torch.device("cuda", 0)
    clock_mhz = float(_nvidia_smi("clocks.max.sm"))
    grind_fn = WRAP_CALLS.originals["grind"]
    calls = list(dict.fromkeys(WRAP_CALLS.grinds))
    for seed, bits, start, span, nonce in calls:
        got = grind_fn(seed, bits, start, span, dev)
        want = ps.grind_plain(seed, bits, start, span, dev)
        if not got == want == nonce:
            raise AssertionError(f"grinding span {(seed, bits, start, span)}: the path got {nonce}, the kernel "
                                 f"{got}, grind_plain {want}")
        if nonce is not None and not fri.check_grind(seed, nonce, bits):
            raise AssertionError(f"check_grind refuses nonce {nonce} of seed {seed} at {bits} bits")
    span = fri.GRIND_SPAN
    for seed in range(SEED, SEED + 32):
        before = ps.grind_kernel_launches
        nonce = fri.grind(seed, GRIND_PAST_BITS, dev)
        if nonce >= GRIND_PAST_NONCE:
            break
    else:
        raise AssertionError(f"no seed of 32 has its first {GRIND_PAST_BITS}-bit hit past {GRIND_PAST_NONCE}")
    searched = ps.grind_kernel_launches - before
    plain = ps.grind_plain(seed, GRIND_PAST_BITS, 0, span, dev)
    if searched != 1 or plain != nonce or not fri.check_grind(seed, nonce, GRIND_PAST_BITS):
        raise AssertionError(f"seed {seed} at {GRIND_PAST_BITS} bits: nonce {nonce} in {searched} launches, "
                             f"grind_plain's {plain}")
    past = {"seed": seed, "pow_bits": GRIND_PAST_BITS, "nonce": nonce, "launches": searched}
    # the run's first 16-bit search
    t_seed, t_bits, _, _, t_nonce = next(c for c in calls if c[1] == 16 and c[2] == 0 and c[4] is not None)
    timed = _time_rounds(lambda: grind_fn(t_seed, t_bits, 0, span, dev), 20)
    timed["burst_ms"] = _grind_burst_ms(t_seed, t_bits, span, dev)
    _, plain_ms = _timed_once(lambda: ps.grind_plain(t_seed, t_bits, 0, span, dev))
    grind_bound = lambda n: _bound(n, 0, clock_mhz, fp64=MDS_PRODUCTS_PER_PERMUTATION,
                                   design_fp64=DESIGN_MDS_PRODUCTS_PER_PERMUTATION)
    bound = grind_bound(t_nonce + 1)
    row = {
        "route": "cuda", "source": "tendermintx_tpu_torch/csrc/poseidon.cu",
        "replaces": "tendermintx_tpu/stark/fri.py:624", "replaces_program": "_grind_fn",
        "library_ms": None, "library": "none: no PyTorch call computes Poseidon",
        "max_abs_err": 0.0, "shape": [span], "seed": t_seed, "pow_bits": t_bits, "nonce": t_nonce, **timed,
        "plain_ms": plain_ms, **bound, "span_bound_ms": grind_bound(span)["bound_ms"],
        **_registers_of(build["poseidon"]["ptxas"], "tmx_poseidon_grind"),
        "checked": {"spans": len(calls), "searches": len({c[:2] for c in calls}), "past": past},
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit({"phase": "grind", "poseidon_grind": row})
    rows["poseidon_grind"] = row
    return row


# the torch.profiler ranges around the wrap's former plain programs, now
# around the kernels that replace them (stark/recursion.py: witness_trace,
# stark/evalair.py: eval_aux_cuda)
PLAIN_RANGES = ("expand_perm_states", "eval_aux")


def _range_times(prof, names) -> dict:
    """Seconds of each named record_function range in a torch.profiler
    run: `host` is the range's wall time, `device` the summed time of the
    card's work (kernels, copies, fills) whose CUDA API call (a CPU event
    named cuda* or cu*, paired with its device event by correlation id)
    started inside it: torch ops' and the ctypes-launched hand kernels'
    alike. Raises if a range is missing."""
    from torch.autograd import DeviceType

    events = prof.events()
    calls = {e.id: e.time_range.start for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    on_card = [(calls[e.id], e.time_range.elapsed_us()) for e in events
               if e.device_type == DeviceType.CUDA and e.id in calls]
    out: dict[str, dict] = {}
    for evt in events:
        if evt.name in names and evt.device_type == DeviceType.CPU:
            row = out.setdefault(evt.name, {"count": 0, "host_seconds": 0.0, "device_seconds": 0.0})
            t0, t1 = evt.time_range.start, evt.time_range.end
            row["count"] += 1
            row["host_seconds"] += evt.cpu_time_total / 1e6
            row["device_seconds"] += sum(us for t, us in on_card if t0 <= t <= t1) / 1e6
    missing = [n for n in names if n not in out]
    if missing:
        raise AssertionError(f"the profiled run passed through no range {missing}")
    return out


def phase_wrap(sc: SkipChain, proof, profile: bool) -> tuple[dict, dict, bytes]:
    """wrap_composite of the warm N=128 skip proof at default_wrap_config()
    on the card, timed as bench.py times it, then verified after a wire
    round trip at the default 100-bit floor on both configs. With
    `profile`, the second wrap runs under torch.profiler and the line
    gives the times of the ranges around the round-state and EvalAir
    kernels (PLAIN_RANGES) in it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tendermintx_tpu_torch.circuits.composite import (
        CompositeProof,
        verify_skip_composite,
        wrap_composite,
    )
    from tendermintx_tpu_torch.stark.recursion import default_wrap_config

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with _PhaseLog() as phases:
        t0 = time.perf_counter()
        wrapped = wrap_composite(proof, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = _launch_counts()
    _check_launched(launches, "wrap", absent=LOGUP_ENTRIES, wrap=True)
    _check_wrap_launches(launches, 1, "wrap")
    _check_deep_launches(launches, len(wrapped.batch.wrapper.statements), 1, "wrap")
    _check_ood_launches(launches, len(wrapped.batch.wrapper.statements), 0, "wrap")
    _check_batch_fri(launches, wrapped.batch.wrapper, default_wrap_config(), "wrap")
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
        "wrapped_sha256": hashlib.sha256(blob).hexdigest(),
        "unwrapped_proof_gz_bytes": len(proof.to_bytes()),
        "wrapped_proof_json_bytes": len(json.dumps(wrapped.to_dict(), separators=(",", ":"))),
        "wrap_rows": [st.n_rows for st in wrapped.batch.wrapper.statements],
        "launches": launches,
        "max_memory_allocated": peak,
        "phases": phases.lines,
    }
    if plain_programs is not None:
        out["wrap_range_seconds"] = plain_programs
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


def _witness_programs(sc: SkipChain, profile: bool, count_launches: bool = True) -> dict:
    """The witness programs at N=128 on the card: seconds of one call
    (CUDA events; the CLI's witness prove ran the same programs at the
    same shapes before) of skip_verify on the skip 2 -> 6 witness and,
    with `profile`, of each program below (step_verify on the step 4 -> 5
    witness; the challenge where the checkout has it) and the torch ops
    one call dispatches. With
    `count_launches`, each program's witness kernel launches, held
    exactly for skip_verify and step_verify; without, for a checkout
    whose witness programs have no kernels (tools/kernel_times.py's
    `--root`)."""
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
        "sha512_challenge": (lambda: sha512.sha512_challenge(lanes.sig_r, lanes.sig_pubkeys, lanes.messages,
                                                             lanes.msg_len),
                             f"{sc.n} lanes x {lanes.messages.shape[1]} bytes"),
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
    if not hasattr(sha512, "sha512_challenge"):  # a checkout from before the challenge kernel
        del programs["sha512_challenge"]
    if profile:
        prev, step_inputs = sc.step(4)
        sw = pack_step_witness(step_inputs).to(RUNTIME_DEVICE)
        prev_t = torch.frombuffer(bytearray(prev), dtype=torch.uint8)
        programs["step_verify"] = (lambda: step_verify(sw, prev_t, 4, 0, cl, cn)[0], f"N={sc.n} step 4->5")
    else:
        programs = {"skip_verify": programs["skip_verify"]}
    out, valid = {}, {}
    for name, (fn, shape) in programs.items():
        before = _launch_counts() if count_launches else None
        valid[name], seconds = _card_seconds(fn)
        out[name] = {"shape": shape, "card_seconds": seconds}
        if count_launches:
            after = _launch_counts()
            out[name]["launches"] = {k: after[k] - before[k] for k in WITNESS_ENTRIES}
            if name in ("skip_verify", "step_verify"):
                _check_witness_launches(out[name]["launches"], sc.n, name[:4], name)
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
    sc: SkipChain, workdir: str, wrapped_blob: bytes, step_blob: bytes, profile: bool, proved: tuple
) -> tuple[dict, dict]:
    """The port's entry points on the card: CLI, prover service, operator;
    with `profile`, the witness programs' torch op counts too. `proved`:
    the launch counts of the warm skip, wrap and step paths, whose proofs
    the service makes again (its FRI launches are checked exactly against
    them, the prewarm's and the operator's leaf bundle's)."""
    from tendermintx_tpu_torch.circuits.composite import CompositeProof
    from tendermintx_tpu_torch.circuits.proving import _default_config, verify_leaf_bundle
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
    before = _launch_counts()
    rc_prove, _ = _cli_quiet(["prove", "--artifact", build, "--input", os.path.join(rt, "input.json"),
                              "--out", os.path.join(rt, "witness.json"),
                              "--fixture-path", sc.fixture_path, "--device", RUNTIME_DEVICE])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    witness_prove = {k: n - before[k] for k, n in _launch_counts().items()}
    _check_witness_launches(witness_prove, sc.n, "skip", "witness-only cli prove")
    with open(os.path.join(rt, "witness.json")) as f:
        witness = json.load(f)
    if rc or rc_prove or witness["valid"] is not True or witness["output"] != "0x" + headers[6].hash().hex():
        raise AssertionError(f"cli build/prove: rc {rc}/{rc_prove}, {witness}")
    out["cli"] = {"build_seconds": t1 - t0, "witness_prove_seconds": t2 - t1, "valid": True, "output_is_header_6": True,
                  "launches": {k: witness_prove[k] for k in WITNESS_ENTRIES}}
    out["witness_programs"] = _witness_programs(sc, profile)

    # 2. the prover service: prewarm, a wrapped skip and a step request
    svc = ProverService(allowed_fixture_roots=[workdir], device=RUNTIME_DEVICE)
    before = _launch_counts()
    prewarm_seconds = svc.prewarm()
    prewarm = {k: n - before[k] for k, n in _launch_counts().items()}
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
    before = _launch_counts()
    t0 = time.perf_counter()
    moved = op.tick(chain_tip=7)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tick = {k: n - before[k] for k, n in _launch_counts().items()}
    _check_witness_launches(tick, sc.n, "step", "operator tick")
    _, step_inputs = sc.step(6)
    bundle_ok = verify_leaf_bundle(op.last_bundle, step_inputs.next_block_validators)
    t2 = time.perf_counter()
    if moved != ("step", 7) or contract.latest_block() != 7 or contract.header_hash(7) != headers[7].hash():
        raise AssertionError(f"the operator did not move the head to 7: {moved}, {contract.latest_block()}")
    if not bundle_ok:
        raise AssertionError("the operator's leaf STARK bundle failed to verify")
    out["operator"] = {"tick": list(moved), "tick_seconds": t1 - t0, "bundle_verify_seconds": t2 - t1,
                       "head": contract.latest_block(), "leaf_bundle_ok": True,
                       "witness_launches": {k: tick[k] for k in WITNESS_ENTRIES}}

    launches = _launch_counts()
    _check_launched(launches, "runtime", witness=True, wrap=True)
    # the FRI and the wrap: the prewarm's N=4 proof (its launches as
    # counted around it), the service's wrapped skip and step (their paths'
    # launches) and the leaf bundle's single FRI (one fold a committed
    # layer, its grinding spans)
    want = {k: prewarm[k] + sum(p[k] for p in proved) for k in ("fri_fold", "fri_inject", "poseidon_grind",
                                                                 *WRAP_ENTRIES)}
    leaf = op.last_bundle.proof.fri_proof
    want["fri_fold"] += len(leaf.layer_caps)
    want["poseidon_grind"] += _grind_spans(leaf, _default_config().proof_of_work_bits)
    got = {k: launches[k] for k in want}
    if got != want or not prewarm["fri_fold"]:
        raise AssertionError(f"the runtime path launched {got}; the prewarm ({prewarm['fri_fold']} folds), "
                             f"the service's proofs and the leaf bundle give {want}")
    out["launches"] = launches
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out, launches, witness_prove


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
    if launches["quotient"] != MESH_SHARDS * len(proof.batch.statements):
        raise AssertionError(
            f"the mesh prove has {len(proof.batch.statements)} statements over {MESH_SHARDS} shards "
            f"and {launches['quotient']} quotient launches"
        )
    _check_deep_launches(launches, len(proof.batch.statements), MESH_SHARDS, "mesh")
    # OOD and the DEEP inverses run once a statement on the mesh's first device
    _check_ood_launches(launches, len(proof.batch.statements), 1, "mesh")
    _check_batch_fri(launches, proof.batch, DEFAULT_COMPOSITE_CONFIG, "mesh", MESH_SHARDS)
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
    before = _launch_counts()
    t0 = time.perf_counter()
    sig_ok, digests, signed, total = sharded_lane_checks(mesh)(*args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    after = _launch_counts()
    lane_path = {k: after[k] - before[k] for k in after}
    lane_launches = {k: lane_path[k] for k in WITNESS_ENTRIES}
    # per shard: verify_bound (the SHA-512 challenge, binding, ladder) and
    # the leaf hashes (sha256_blocks); no tree, header proof or
    # sha512_blocks
    want_lanes = {k: 0 if k in SHA256_GADGETS or k == "sha512_blocks" else MESH_SHARDS for k in WITNESS_ENTRIES}
    if lane_launches != want_lanes:
        raise AssertionError(f"the sharded lane checks launched {lane_launches}; {want_lanes} wanted")
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
                          "total_power": want_total, "signed_power": want_signed, "launches": lane_launches}

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

    # the four-step's own launches, read around one run of it alone: per
    # shard one column DFT over rows of MESH_SHARDS points and one row DFT
    # over C = 2^log_n / MESH_SHARDS points, each its plan's pass kernels
    _reset_launch_counts()
    sharded_ntt()
    torch.cuda.synchronize()
    four_step = _launch_counts()
    log_d = MESH_SHARDS.bit_length() - 1
    want_forward = MESH_SHARDS * (len(nttmod.ntt_plan(log_d)) + len(nttmod.ntt_plan(log_n - log_d)))
    if four_step["ntt_forward"] != want_forward:
        raise AssertionError(
            f"the four-step NTT launched the forward NTT kernel {four_step['ntt_forward']} times, "
            f"{want_forward} wanted (one column and one row DFT a shard, by their pass plans)"
        )
    times, got, want = _timed_pair(sharded_ntt, lambda: nttmod.ntt(GF(coeffs)).v)
    _check_equal(got, want, "four-step NTT")
    # the kernels' four-step against the plain single-device NTT too
    _check_equal(got, nttmod.ntt_plain(GF(coeffs)).v, "four-step NTT against the plain NTT")
    out["ntt"] = {"log_n": log_n, "identical": True, "identical_to_plain": True, **times,
                  "launches": four_step}
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
    return out, launches, four_step, lane_path


def _time_fri_tables(n: int, config, card: bool = False) -> float:
    """Seconds to build, cache cold, the host FRI fold tables of one batch
    FRI over an n-point domain: the plain fold's (2x)^-1 tables
    (stark/fri.py::_inv_x_table) or, `card`, what the fold kernel takes
    from the host instead (_fold_constants: powers of w_N^-1, a layer)."""
    from tendermintx_tpu_torch.stark import fri

    build = fri._fold_constants if card else fri._inv_x_table
    build.cache_clear()
    stop = config.final_poly_len << config.rate_bits
    cur_n, cur_shift = n, config.shift % GL_P
    t0 = time.perf_counter()
    while cur_n > stop:
        log_n = cur_n.bit_length() - 1
        build(log_n, cur_shift, cur_n // 2) if card else build(log_n, cur_shift)
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
    FRI's host fold tables alone (the plain fold's, and what the card's
    fold takes from the host for the same domain)."""
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
        "wrap_fri_tables": {"domain": wrap_n, "cold_seconds": _time_fri_tables(wrap_n, wrap_cfg),
                            "card_host_seconds": _time_fri_tables(wrap_n, wrap_cfg, card=True)},
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
    build = phase_build()
    NTT_CALLS.install()
    FRI_CALLS.install()
    WRAP_CALLS.install()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        parity = parity_start(workdir)
        try:
            rows = phase_kernels(build)
            n128 = SkipChain(128, os.path.join(workdir, "n128"))
            rows.update(phase_witness(n128, build))
            _, cold_launches, warm_launches, warm_proof, warm_ntt_calls = phase_slice(n128)
            _, step_launches, step_blob = phase_step(n128)
            _, hashes_launches = phase_hashes(n128, parity, card)
            profile = "--profile" in argv
            wrap, wrap_launches, wrapped_blob = phase_wrap(n128, warm_proof, profile)
            phase_wrap_kernels(rows, build, wrap["wrap_rows"])
            _, runtime_launches, witness_launches = phase_runtime(n128, workdir, wrapped_blob, step_blob, profile,
                                                (warm_launches, wrap_launches, step_launches))
            _, mesh_launches, four_step_launches, lane_launches = phase_mesh(n128, warm_proof, parity)
            phase_grind(rows, build)
            phase_fri_shapes(rows)
            phase_parity(parity)  # before the profile, which the CPU jobs would disturb
            if profile:
                phase_profile(n128, wrapped_blob, wrap["wrap_rows"])
        finally:
            for job in parity["jobs"].values():
                job.stop()
    kept = ("route", "source", "replaces", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_share", "library_ms")
    paths = {"skip_cold": cold_launches, "skip_warm": warm_launches, "step": step_launches,
             "hashes": hashes_launches, "wrap": wrap_launches, "runtime": runtime_launches,
             "witness_prove": witness_launches,
             "mesh": mesh_launches, "mesh_four_step": four_step_launches, "mesh_lane_checks": lane_launches}
    count = lambda launches, name: sum(launches[e] for e in KERNEL_ENTRIES.get(name, (name,)))
    kernels = []
    for name, row in rows.items():
        # the witness kernels' main path is the witness-only cli prove
        # (sha256_blocks's the mesh's lane checks, the one path that still
        # calls it), the wrap kernels' the N=128 wrap; every other kernel's
        # the two N=128 skip proves
        main_launches = (count(lane_launches, name) if name == "sha256_blocks"
                         else count(witness_launches, name) if name in WITNESS_ENTRIES
                         else count(wrap_launches, name) if name in WRAP_ENTRIES
                         else count(cold_launches, name) + count(warm_launches, name))
        entry = {"name": name, **{k: row[k] for k in kept}, "launches": main_launches,
                 "launches_by_path": {path: count(launches, name) for path, launches in paths.items()}}
        entry.update({k: row[k] for k in ("ms_min", "ms_max", "burst_ms", "alone_ms", "alone_bound_share", "tiles",
                                          "rows_a_thread", "registers", "spill_bytes", "check_lanes") if k in row})
        if name in WITNESS_ENTRIES and "shapes" in row:
            entry["shapes"] = [{k: r[k] for k in ("shape", "ms", "burst_ms", "plain_ms", "bound_ms", "bound_by")}
                               for r in row["shapes"]]
        if name in KERNEL_ENTRIES:
            entry["launches_by_entry"] = {
                e: {path: launches[e] for path, launches in paths.items()} for e in KERNEL_ENTRIES[name]
            }
            entry["entries"] = {
                e: {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")}
                for e, r in row["entries"].items()
            }
            entry["shapes"] = [{k: r[k] for k in ("use", "entry", "rows", "log_n", "rate", "plan", "ms", "bound_ms",
                                                  "bound_by")} for r in row["shapes"]]
            entry["warm_skip"] = _ntt_path_sums(row["shapes"], warm_ntt_calls)
        kernels.append(entry)
    # the quotient per AIR: times, bounds, launch shape, slots and loads
    per_air = ("ms", "plain_ms", "block_rows", "block_ms", "block_plain_ms", "slots", "threads", "shared_bytes", "blocks_per_sm", "instructions", "bundles", "chunks", "reads",
               "distinct_reads", "loads")
    for entry in kernels:
        if entry["name"] == "quotient":
            entry["airs"] = {
                air: {**{k: a[k] for k in per_air}, "bound_ms": a["bound"]["bound_ms"],
                      "block_bound_ms": a["block_bound"]["bound_ms"],
                      "block_per_offset_bound_ms": a["block_bound"]["per_offset_bound_ms"]}
                for air, a in rows[entry["name"]]["airs"].items()
            }
    for entry in kernels:
        if entry["name"] == "deep":
            entry["airs"] = {
                air: {k: a[k] for k in ("shape", "groups", "chunks", "ms", "plain_ms", "bound_ms", "bound_by")}
                for air, a in rows["deep"]["airs"].items()
            }
        if entry["name"] in ("ext_powers", "ood_eval", "deep_inverses"):
            entry["airs"] = {
                air: {k: a[k] for k in ("shape", "run", "ms", "ms_min", "ms_max", "burst_ms", "plain_ms", "bound_ms",
                                        "bound_by", "max_abs_err", "planted_zero", "alpha") if k in a}
                for air, a in rows[entry["name"]]["airs"].items()
            }
        if "checked_after_paths" in rows[entry["name"]]:  # listed in the fri_shapes line
            entry["checked_after_paths"] = len(rows[entry["name"]]["checked_after_paths"])
        for part in ("layers", "injections"):
            if part in rows[entry["name"]]:
                entry[part] = [{k: r[k] for k in ("paths", "log_n", "shift", "start", "codewords", "cur", "shape",
                                                  "ms", "burst_ms", "l2_cold", "plain_ms", "bound_ms", "bound_by",
                                                  "max_abs_err") if k in r}
                               for r in rows[entry["name"]][part]]
        if entry["name"] in LOGUP_ENTRIES + WRAP_ENTRIES + ("poseidon_grind",):
            entry["checked"] = rows[entry["name"]]["checked"]
        if entry["name"] == "poseidon_grind":
            entry.update({k: rows["poseidon_grind"][k] for k in ("pow_bits", "nonce", "span_bound_ms")})
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
