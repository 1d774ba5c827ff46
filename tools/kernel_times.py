"""Time the NTT and DEEP kernels of one checkout of the port at every
main-path shape on one card, and the LogUp and OOD kernels round by round.

    python3 tools/kernel_times.py [--root DIR] [--label NAME]
        [--only ntt,deep,logup,ood,deep_inverses,logup_scan,ext_powers,fri_fold,fri_inject,
                sha256_blocks,sha256_validator_root,sha256_header_proofs,sha512_blocks,sha512_challenge,
                straus_verify,bind_witness,witness_programs,eval_aux,poseidon_expand,
                poseidon_grind] [--rounds R]

Imports tendermintx_tpu_torch from DIR (default: this checkout) and, from
this checkout's chip_smoke.py, the shapes and inputs: every distinct NTT
transform of the N=128 paths (`_ntt_shapes()`) through the checkout's
`ntt_cuda` / `intt_cuda` / `coset_lde_cuda`, and the DEEP composition at
each AIR's one-device shard (`_quotient_airs()`) through its
`deep_cuda`. Each kernel is timed alone with CUDA events after a warm-up
(no plain version, no check: chip_smoke.py holds the kernels against
their plain versions). `logup` times `logup_terms_cuda` at the Ed25519
statement of the N=128 paths in R rounds of 20 launches, with the SM
clock and the power draw that nvidia-smi reads after each round, to show
how far its time spreads within one process and why; `ood` times
`ood_eval_cuda` the same way at every statement shape of the N=128 paths
(`_ood_shapes()`: the trace and aux rows and the quotient chunks' rows
over the opening points' powers). `deep_inverses` (every `_ood_shapes`
statement's LDE domain at its opening points), `logup_scan` (the Ed25519
statement's group sums) and `ext_powers` (every statement's opening
points and alpha) are timed in rounds the same way, each round also
with `burst_ms`: a launch's time from CUDA events around a burst of raw
ctypes launches with the arguments the wrapper built (chip_smoke.py:
`_launch_burst_ms`; the kernel or the C entry's host cost, whichever is
longer), for kernels shorter than their Python wrapper; and each shape
with `kernel_ms`, torch.profiler's device time of the kernels alone a
call. `fri_fold` (each fold launch shape of the N=128 paths: a whole
layer's outputs, `_fri_shapes()`) and `fri_inject` (each injection shape)
are timed in rounds the same way, each launch rotating through input
sets that together exceed twice the card's L2 (`_fri_inputs`; `l2_cold`
false where `FRI_MAX_SETS` sets stay under that), so that `ms` and
`kernel_ms` read the inputs from HBM as the bytes bound counts them;
`burst_ms` launches on one input set. The witness programs' kernels
(csrc/sha.cu, csrc/ed25519.cu) are timed in rounds the same way at their
N=128 shapes: `sha256_blocks` at a mesh lane-check shard (32 lanes x 1
block, the one path that calls it) on random words, every lane's blocks
active;
`sha256_validator_root` over 128 random leaves (lengths 1 to 47) with all
128 enabled; `sha256_header_proofs` at a skip's 4 and a step's 5 proofs
(leaves of 73 bytes, one of 119); `sha512_blocks` at 128 lanes x 2
blocks; `sha512_challenge` at 128 lanes of random R, A and 124-byte
message rows with msg_len 110 (two blocks, as a precommit's; in a checkout
without the challenge kernel, the byte assembly and `sha512_blocks` its
`verify_bound` ran instead, `composition` true); `straus_verify` and
`bind_witness` at 128 lanes repeated from `_witness_cases`' 8 chain
lanes (in every range, so that no binding lane stops early).
`burst_ms` launches on one input set. `witness_programs` runs
chip_smoke.py's `_witness_programs` with its profile (skip_verify on skip
2 -> 6, step_verify on step 4 -> 5 and the programs inside them: card
seconds of one call and its torch ops) R times after a first call, on
`SkipChain(128)`, then times the witness-only `cli prove` of skip 2 -> 6
(`--device cuda`, host clock) R times after a warm-up; in a checkout
without the challenge kernel it counts no launches. The recursion wrap's
kernels are timed in rounds the same way at the N=128 wrap's shapes
(`_ood_shapes()`' EvalAir and WrapAir rows) on random inputs, each with
`kernel_ms`, and beside each the checkout's plain program on the card
(`plain_ms`, the median of R calls): `eval_aux` (`eval_aux_cuda`, the
EvalAir aux rows: one launch where the checkout has
`eval_aux_kernel_launches`, with its burst, else the terms kernel and the
scan's two, `kernel_ms` summing them; plain: `eval_aux_plain`), `poseidon_expand`
(`expand_cuda`; plain: `expand_plain`, or `expand_perm_states` in a
checkout without the kernel) and `poseidon_grind`: 16-bit searches of the first GRIND_SEEDS seeds from
chip_smoke.py's SEED, each one `grind_cuda` launch from 0 over the
checkout's GRIND_SPAN (a 2^18 GRIND_BATCH in a checkout that hashes a
whole batch) with its read-back, its burst and `kernel_ms`, beside the
whole `fri.grind` on the card (`grind_ms`: two launches in such a
checkout where the nonce lies past its batch; the permutation kernel over
a state tensor, a mask and a nonzero in a checkout without the kernel)
and `grind_plain` over the same candidates; and, with GRIND_SPAN, a
32-bit search's first span (`no_hit`: a span hashed whole where it holds
no hit). A checkout without a kernel gives its plain program alone. Prints one JSON line: the card's
name and power limit, the label, and per shape the ms. Two checkouts are compared by running
this in turns from one call (parent, change, change, parent); a
measuring aid that nothing else uses.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# poseidon_grind: the 16-bit searches timed, of consecutive seeds
GRIND_SEEDS = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="ntt,deep")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tendermintx_tpu_torch.ops import ntt
    from tendermintx_tpu_torch.ops.ext import GF2
    from tendermintx_tpu_torch.ops.goldilocks import GF, P
    from tendermintx_tpu_torch.stark import prover as pr

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 1)
    out = {
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, check=True).stdout.strip(),
        "label": args.label,
        "root": os.path.abspath(args.root),
    }

    def timed(fn) -> float:
        _, first = cs._timed_once(fn)
        return cs._time_ms(fn, max(3, min(20, int(200 / max(first, 1e-3)))))

    def timed_rounds(fn, reps: int, burst=None) -> list[dict]:
        """args.rounds rounds of `reps` launches, each with the SM clock and
        power draw nvidia-smi reads just after it; with `burst`, (module,
        launcher, library) of the wrapper `fn` calls, each round's burst of
        raw launches too."""
        rounds = []
        for _ in range(args.rounds):
            ms = cs._time_ms(fn, reps)
            more = {"burst_ms": cs._launch_burst_ms(*burst, fn)} if burst else {}
            clock, power = cs._nvidia_smi("clocks.sm,power.draw").split(", ")
            rounds.append({"ms": ms, **more, "clocks_sm_mhz": float(clock), "power_draw_w": float(power)})
        return rounds

    def reps_for(fn) -> int:
        return max(3, min(50, int(200 / max(cs._timed_once(fn)[1], 1e-3))))

    kernel_ms = cs._alone_ms

    only = args.only.split(",")
    if "ntt" in only:
        shapes = []
        for use, entry, rows, log_n, rate in cs._ntt_shapes():
            x = cs._random_felts((rows, 1 << log_n), gen, dev)
            if entry == "coset_lde":
                run = lambda: ntt.coset_lde_cuda(x, rate, cs.NTT_SHIFT)
            elif entry == "coset_intt":
                pw = ntt.power_tensor(pow(cs.NTT_SHIFT, P - 2, P), 1 << log_n, dev)
                run = lambda: ntt.intt_cuda(x, pw)
            elif entry == "intt":
                run = lambda: ntt.intt_cuda(x)
            else:
                run = lambda: ntt.ntt_cuda(x)
            shapes.append({"use": use, "entry": entry, "rows": rows, "log_n": log_n, "rate": rate, "ms": timed(run)})
            del x
        out["ntt"] = shapes
    if "deep" in only:
        airs = {}
        for name, air, N, _ in cs._quotient_airs():
            f = lambda *shape: GF(cs._random_felts(shape, gen, dev))
            nc, ng = air.constraint_degree - 1, len(air.frame_offsets)
            n_total = air.n_cols + air.n_aux_cols
            q = f(2 * nc, N)
            args_ = (f(air.n_cols, N), f(air.n_aux_cols, N) if air.n_aux_cols else None, GF2(q[0::2], q[1::2]),
                     GF2(f(ng, n_total), f(ng, n_total)), GF2(f(nc), f(nc)), GF2(f(ng), f(ng)), GF2(f(ng, N), f(ng, N)))
            airs[name] = {"shape": [air.n_cols, air.n_aux_cols, N], "groups": ng, "chunks": nc,
                          "ms": timed(lambda: pr.deep_cuda(*args_))}
            del args_, q
        out["deep"] = airs
    if "logup" in only:
        from tendermintx_tpu_torch.stark.ed25519_air import Ed25519Air

        air = Ed25519Air(cs.N128_SKIP_STATEMENTS["ed25519"])
        lk = air.lookup
        trace, gamma = cs._logup_case(lk, air.n_cols, gen, dev)
        aux = torch.empty((lk.n_aux_cols, lk.n_rows), dtype=torch.int64, device=dev)
        rounds = timed_rounds(lambda: lk.logup_terms_cuda(trace, gamma, aux), 20)
        out["logup_terms"] = {"shape": [len(lk.checked_cols), lk.n_rows], "rounds": rounds}
    if "ood" in only:
        airs = {}
        for name, air, log_n, _ in cs._ood_shapes():
            n, K = 1 << log_n, len(air.frame_offsets)
            n_total, n_chunks = air.n_cols + air.n_aux_cols, air.constraint_degree - 1
            a = GF(cs._random_felts((n_total, n), gen, dev))
            b = GF(cs._random_felts((2 * n_chunks, n), gen, dev))
            powers = pr.ext_powers_cuda(cs._random_points(K, gen, dev), n, dev)
            run = lambda: pr.ood_eval_cuda(a, b, powers)
            reps = max(3, min(50, int(200 / max(cs._timed_once(run)[1], 1e-3))))
            airs[name] = {"shape": [n_total, 2 * n_chunks, n, K], "rounds": timed_rounds(run, reps)}
            del a, b, powers
        out["ood_eval"] = airs
    ood_burst = (pr, "_ood_launch", "_ood_library")
    if "deep_inverses" in only:
        airs = {}
        for name, air, log_n, rate in cs._ood_shapes():
            K = len(air.frame_offsets)
            pts = cs._random_points(K, gen, dev)
            run = lambda: pr.deep_inverses_cuda(log_n + rate, cs.NTT_SHIFT, pts, dev)
            airs[name] = {"shape": [K, 1 << (log_n + rate)], "rounds": timed_rounds(run, reps_for(run), ood_burst),
                          "kernel_ms": kernel_ms(run)}
        out["deep_inverses"] = airs
    if "ext_powers" in only:
        airs = {}
        for name, air, log_n, _ in cs._ood_shapes():
            n, K, n_con = 1 << log_n, len(air.frame_offsets), air.n_constraints
            pts, alpha = cs._random_points(K, gen, dev), cs._random_points(1, gen, dev)
            run = lambda: pr.ext_powers_cuda(pts, n, dev)
            run_alpha = lambda: pr.ext_powers_cuda(alpha, n_con, dev)
            airs[name] = {"shape": [K, n], "rounds": timed_rounds(run, reps_for(run), ood_burst),
                          "kernel_ms": kernel_ms(run),
                          "alpha": {"shape": [1, n_con], "rounds": timed_rounds(run_alpha, reps_for(run_alpha),
                                                                                ood_burst),
                                    "kernel_ms": kernel_ms(run_alpha)}}
        out["ext_powers"] = airs
    if "logup_scan" in only:
        from tendermintx_tpu_torch.stark import lookup
        from tendermintx_tpu_torch.stark.ed25519_air import Ed25519Air

        air = Ed25519Air(cs.N128_SKIP_STATEMENTS["ed25519"])
        lk = air.lookup
        trace, gamma = cs._logup_case(lk, air.n_cols, gen, dev)
        aux = torch.empty((lk.n_aux_cols, lk.n_rows), dtype=torch.int64, device=dev)
        partial = lk.logup_terms_cuda(trace, gamma, aux)
        del trace
        run = lambda: lk.logup_scan_cuda(partial, aux)
        out["logup_scan"] = {"shape": list(partial.shape),
                             "rounds": timed_rounds(run, 20, (lookup, "_logup_launch", "_logup_library")),
                             "kernel_ms": kernel_ms(run)}
    if "fri_fold" in only or "fri_inject" in only:
        from tendermintx_tpu_torch.stark import fri

        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        for name, kind, shapes in zip(("fri_fold", "fri_inject"), ("fold", "inject"), cs._fri_shapes()):
            if name not in only:
                continue
            rows, halves = [], set()
            for key, paths in shapes.items():
                if kind == "fold":
                    if key[2] or key[3] in halves:
                        continue  # one timing a launch shape: a whole layer's
                    halves.add(key[3])
                kernel, _, inputs, in_bytes, _, _, what = cs._fri_inputs(kind, key, gen, dev, cold=True)
                turns = itertools.cycle(inputs)
                run = lambda: kernel(*next(turns))
                rows.append({"paths": paths, **what, "l2_sets": len(inputs),
                             "l2_cold": len(inputs) * in_bytes >= 2 * l2,
                             "rounds": timed_rounds(run, reps_for(run), (fri, "_fri_launch", "_fri_library")),
                             "kernel_ms": kernel_ms(run)})
                del inputs
            out[name] = rows
    witness = [name for name in cs.WITNESS_ENTRIES if name in only]
    if witness:
        from tendermintx_tpu_torch.circuits import gadgets
        from tendermintx_tpu_torch.ops import ed25519, sha256, sha512

        sha_burst, ed_burst = (sha256, "sha_launch", "_sha_library"), (ed25519, "_ed_launch", "_ed_library")
        ladder, bind = cs._witness_cases(dev)
        # the chain's 8 signature lanes (in every range: each binding check
        # runs to its end), repeated
        lanes = lambda args, n: tuple(a[torch.arange(n, device=dev) % 8].contiguous() for a in args)
        runs = {}
        if "sha256_blocks" in only:
            shape = (128 // cs.MESH_SHARDS, 1)  # a lane-check shard, its one path
            runs["sha256_blocks"] = [(shape, sha256.sha256_blocks_cuda, sha_burst, (
                torch.randint(0, 1 << 32, (*shape, 16), generator=gen, device=dev),
                torch.full((shape[0],), shape[1], dtype=torch.int64, device=dev)))]
        if "sha256_validator_root" in only:
            leaf_len = torch.randint(1, 48, (128,), generator=gen, device=dev)
            runs["sha256_validator_root"] = [((128, cs.VALIDATOR_LEAF_WIDTH), gadgets.validator_root_cuda, sha_burst, (
                torch.randint(0, 256, (128, cs.VALIDATOR_LEAF_WIDTH), generator=gen, device=dev).to(torch.uint8),
                leaf_len, torch.tensor(128, device=dev)))]
        if "sha256_header_proofs" in only:
            runs["sha256_header_proofs"] = []
            for k in (4, 5):
                leaf_len = torch.full((k,), cs.HEADER_LEAF_WIDTH, dtype=torch.int64, device=dev)
                leaf_len[0] = 119
                runs["sha256_header_proofs"].append(((k, cs.HEADER_LEAF_WIDTH), gadgets.header_proofs_cuda, sha_burst, (
                    torch.randint(0, 256, (k, cs.HEADER_LEAF_WIDTH), generator=gen, device=dev).to(torch.uint8),
                    leaf_len, torch.randint(0, 256, (k, cs.HEADER_PROOF_DEPTH, 32), generator=gen,
                                            device=dev).to(torch.uint8),
                    torch.randint(0, 2, (k, cs.HEADER_PROOF_DEPTH), generator=gen, device=dev))))
        if "sha512_blocks" in only:
            words = (torch.randint(0, 1 << 32, (128, 2, 16), generator=gen, device=dev) << 32) | torch.randint(
                0, 1 << 32, (128, 2, 16), generator=gen, device=dev)
            runs["sha512_blocks"] = [((128, 2), sha512.sha512_blocks_cuda, sha_burst,
                                      (words, torch.full((128,), 2, dtype=torch.int64, device=dev)))]
        if "sha512_challenge" in only:
            rand = lambda *shape: torch.randint(0, 256, shape, generator=gen, device=dev).to(torch.uint8)
            chal = (rand(128, 32), rand(128, 32), rand(128, cs.MESSAGE_WIDTH),
                    torch.full((128,), 110, dtype=torch.int64, device=dev))
            if hasattr(sha512, "sha512_challenge_cuda"):
                run = sha512.sha512_challenge_cuda
            else:  # the parent's verify_bound: byte assembly, then sha512_blocks
                run = lambda r, pk, m, n: sha512.digest_words_to_bytes_dev(
                    sha512.sha512_bytes_var(torch.cat([r, pk, m], 1), n + 64, 2))
            runs["sha512_challenge"] = [((128, cs.MESSAGE_WIDTH), run, sha_burst, chal)]
        if "straus_verify" in only:
            runs["straus_verify"] = [((128, 253), ed25519.straus_verify_cuda, ed_burst, lanes(ladder, 128))]
        if "bind_witness" in only:
            runs["bind_witness"] = [((128,), ed25519.bind_witness_cuda, ed_burst, lanes(bind, 128))]
        for name, cases in runs.items():
            rows = []
            for shape, kernel, burst, kargs in cases:
                run = lambda: kernel(*kargs)
                composition = name == "sha512_challenge" and not hasattr(sha512, "sha512_challenge_cuda")
                rows.append({"shape": list(shape), "rounds": timed_rounds(run, reps_for(run), burst),
                             "kernel_ms": kernel_ms(run), **({"composition": True} if composition else {})})
            out[name] = rows
    wrap_kernels = [k for k in ("eval_aux", "poseidon_expand", "poseidon_grind") if k in only]
    if wrap_kernels:
        from tendermintx_tpu_torch.ops import poseidon as ps
        from tendermintx_tpu_torch.stark import evalair as ev
        from tendermintx_tpu_torch.stark import fri
        from tendermintx_tpu_torch.stark import recursion as rec

        log_n = {name: k for name, _, k, _ in cs._ood_shapes()}
        n, R = 1 << log_n["evalair"], 1 << log_n["wrap"]
        median_ms = lambda fn: sorted(cs._timed_once(fn)[1] for _ in range(args.rounds))[args.rounds // 2]
        felt = lambda: cs._random_felts((1,), gen, dev)
        trace = GF(cs._random_felts((8, n), gen, dev))
        srows = torch.cat([torch.randint(0, n, (4, n), generator=gen, device=dev),
                           torch.randint(0, 1 << 32, (1, n), generator=gen, device=dev),
                           torch.randint(0, 2, (3, n), generator=gen, device=dev)])
        gamma, delta = GF2(GF(felt()), GF(felt())), GF2(GF(felt()), GF(felt()))
        if "eval_aux" in only:
            fused = hasattr(ev, "eval_aux_kernel_launches")
            run = lambda: ev.eval_aux_cuda(trace, srows, gamma, delta)
            burst = (ev, "_eval_launch", "_eval_library") if fused else None
            out["eval_aux"] = {"shape": [8, n], "launches": 1 if fused else 3,
                               "plain_ms": median_ms(lambda: ev.eval_aux_plain(trace, srows, gamma, delta)),
                               "rounds": timed_rounds(run, reps_for(run), burst), "kernel_ms": kernel_ms(run)}
        if "poseidon_expand" in only:
            states = cs._random_felts((R, 12), gen, dev)
            row = {"shape": [R, 12]}
            if hasattr(ps, "expand_cuda"):
                run = lambda: ps.expand_cuda(states)
                row.update(plain_ms=median_ms(lambda: ps.expand_plain(states)),
                           rounds=timed_rounds(run, reps_for(run)), kernel_ms=kernel_ms(run))
            else:
                row["plain_ms"] = median_ms(lambda: rec.expand_perm_states(GF(states)))
            out["poseidon_expand"] = row
        if "poseidon_grind" in only:
            n = getattr(fri, "GRIND_SPAN", None) or fri.GRIND_BATCH
            searches = []
            for seed in range(cs.SEED, cs.SEED + GRIND_SEEDS):
                nonce = fri.grind(seed, 16, dev)
                row = {"seed": seed, "pow_bits": 16, "nonce": nonce, "candidates": n,
                       "grind_ms": median_ms(lambda: fri.grind(seed, 16, dev))}
                if hasattr(ps, "grind_cuda"):
                    run = lambda: ps.grind_cuda(seed, 16, 0, n, dev)
                    row.update(found=run(), plain_ms=median_ms(lambda: ps.grind_plain(seed, 16, 0, n, dev)),
                               rounds=timed_rounds(run, reps_for(run)), kernel_ms=kernel_ms(run),
                               burst_ms=cs._grind_burst_ms(seed, 16, n, dev))
                searches.append(row)
            out["poseidon_grind"] = {"searches": searches}
            if hasattr(fri, "GRIND_SPAN"):
                run = lambda: ps.grind_cuda(cs.SEED, 32, 0, n, dev)
                out["poseidon_grind"]["no_hit"] = {"seed": cs.SEED, "pow_bits": 32, "found": run(),
                                                   "rounds": timed_rounds(run, 3), "kernel_ms": kernel_ms(run, 5)}
    if "witness_programs" in only:
        import tempfile

        from tendermintx_tpu_torch.circuits.skip import encode_skip_input

        # launches are held to this checkout's structure (_witness_launches):
        # another checkout's (an earlier one's sha512_blocks after torch
        # byte assembly) are not counted
        kernels = hasattr(importlib.import_module("tendermintx_tpu_torch.ops.sha512"),
                          "sha512_challenge_kernel_launches")
        with tempfile.TemporaryDirectory(prefix="kernel_times_") as workdir:
            sc = cs.SkipChain(128, os.path.join(workdir, "n128"))
            first, *rounds = [cs._witness_programs(sc, True, kernels) for _ in range(args.rounds + 1)]
            out["witness_programs"] = {"first": first, "rounds": rounds}
            trusted, _, _ = sc.skip(2, 6)
            build, inp, res = (os.path.join(workdir, f) for f in ("build", "input.json", "witness.json"))
            rc, _ = cs._cli_quiet(["build", "--circuit", "skip", "--chain", cs.CHAIN_ID, "--max-validators", "128",
                                   "--out", build])
            with open(inp, "w") as f:
                json.dump({"input": "0x" + encode_skip_input(2, trusted, 6).hex()}, f)
            seconds = []
            for _ in range(args.rounds + 1):  # the first is the warm-up
                t0 = time.perf_counter()
                rc_prove, _ = cs._cli_quiet(["prove", "--artifact", build, "--input", inp, "--out", res,
                                             "--fixture-path", sc.fixture_path, "--device", "cuda"])
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                with open(res) as f:
                    if rc or rc_prove or json.load(f)["valid"] is not True:
                        raise AssertionError(f"the witness-only cli prove failed: rc {rc} / {rc_prove}")
            out["witness_cli_prove"] = {"first_seconds": seconds[0], "seconds": seconds[1:]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
