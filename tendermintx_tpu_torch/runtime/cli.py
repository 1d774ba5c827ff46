"""`tendermintx-tpu-torch` CLI: build / prove / verify / operator / serve / submit.

Counterpart of ``tendermintx_tpu/runtime/cli.py``, with the same
subcommands, flags and output files (each package's ``verify`` reads the
other's proof file), plus ``--device`` on prove, operator and serve: the
work runs on the card unless another device is named, and a missing card
is an error.

    tendermintx-tpu-torch build --circuit step --chain mocha-4 \\
        --max-validators 128 --out build/step
    tendermintx-tpu-torch prove --artifact build/step --input input.json \\
        --out proof.json [--composite [--wrap]] [--stark] [--device cuda]
    tendermintx-tpu-torch verify --proof proof.json
    tendermintx-tpu-torch operator --config operator.json
    tendermintx-tpu-torch serve --port 8642 --fixture-root DIR --prewarm
    tendermintx-tpu-torch submit --url http://127.0.0.1:8642 --circuit skip ...

prove's input.json: {"input": "0x<hex>"} with the abi.encodePacked public
input bytes (step: uint64 ‖ bytes32; skip: uint64 ‖ bytes32 ‖ uint64);
output: {"output": "0x<hex>", "valid": true, ...}.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def cmd_build(args) -> int:
    from .artifact import build_artifact

    artifact = build_artifact(args.circuit, args.chain, args.max_validators)
    artifact.save(args.out)
    print(f"built {args.circuit} circuit for {args.chain} "
          f"(max_validators={args.max_validators}) -> {args.out}")
    return 0


def cmd_prove(args) -> int:
    from ..circuits.skip import decode_skip_input
    from ..circuits.step import decode_step_input
    from ..circuits.variables import pack_skip_witness, pack_step_witness
    from ..circuits.verify import chain_id_leaf_const
    from ..inputs.fetcher import InputDataFetcher
    from .artifact import CircuitArtifact
    from .devices import require_device

    device = require_device(args.device)
    with open(args.input) as f:
        request = json.load(f)
    input_bytes = bytes.fromhex(request["input"].removeprefix("0x"))

    artifact = CircuitArtifact.load(args.artifact, device=device)
    fetcher = InputDataFetcher(fixture_path=args.fixture_path or "")
    cid_leaf, cid_len = chain_id_leaf_const(artifact.chain)

    if artifact.circuit == "step":
        prev_block, prev_hash = decode_step_input(input_bytes)
        inputs = fetcher.get_step_inputs(prev_block, prev_hash, artifact.max_validators)
        valid, out = artifact.call(
            pack_step_witness(inputs),
            torch.frombuffer(bytearray(prev_hash), dtype=torch.uint8),
            prev_block & 0xFFFFFFFF,
            prev_block >> 32,
            cid_leaf,
            cid_len,
        )
    else:
        trusted_block, trusted_hash, target_block = decode_skip_input(input_bytes)
        inputs = fetcher.get_skip_inputs(
            trusted_block, trusted_hash, target_block, artifact.max_validators
        )
        valid, out = artifact.call(
            pack_skip_witness(inputs),
            torch.frombuffer(bytearray(trusted_hash), dtype=torch.uint8),
            trusted_block & 0xFFFFFFFF,
            trusted_block >> 32,
            target_block & 0xFFFFFFFF,
            target_block >> 32,
            cid_leaf,
            cid_len,
        )

    result = {
        "input": request["input"],
        "circuit": artifact.circuit,
        "chain": artifact.chain,
        "max_validators": artifact.max_validators,
        "output": "0x" + bytes(out.cpu().numpy()).hex(),
        "valid": bool(valid),
    }
    if args.stark and result["valid"]:
        from ..circuits.proving import prove_validator_leaves

        lanes = (
            inputs.next_block_validators
            if artifact.circuit == "step"
            else inputs.target_block_validators
        )
        bundle = prove_validator_leaves(lanes, device=device)
        result["stark_leaf_proof"] = bundle.to_dict()
        print(f"proved validator-leaf SHA-256 STARK over {bundle.n_lanes} lanes")
    if args.composite and result["valid"]:
        from ..circuits.composite import (
            prove_skip_composite,
            prove_step_composite,
            runtime_configs,
            wrap_composite,
        )

        base_cfg, wrap_cfg, _ = runtime_configs()
        if artifact.circuit == "step":
            cp = prove_step_composite(prev_block, prev_hash, inputs, base_cfg, device=device)
        else:
            cp = prove_skip_composite(
                trusted_block, trusted_hash, target_block, inputs, base_cfg, device=device
            )
        if args.wrap:
            cp = wrap_composite(cp, base_cfg, wrap_cfg, device=device)
            print("recursion-wrapped the composite (constant-size proof)")
        result["composite_proof"] = cp.to_dict()
        print(
            f"proved composite {artifact.circuit} statement "
            f"({cp.n_hash_segments} hash segments, "
            f"{cp.n_ed_segments} signature segments)"
        )
    if not result["valid"]:
        print("verification FAILED", file=sys.stderr)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"proved: output {result['output']} valid={result['valid']} -> {args.out}")
    return 0 if result["valid"] else 1


def cmd_verify(args) -> int:
    """Host-side verification of a proof file."""
    from ..circuits.proving import LeafProofBundle, verify_leaf_bundle
    from ..circuits.skip import decode_skip_input
    from ..circuits.step import decode_step_input

    with open(args.proof) as f:
        result = json.load(f)
    input_bytes = bytes.fromhex(result["input"].removeprefix("0x"))

    if "composite_proof" in result:
        # standalone: the composite proof plus the chain config suffice,
        # no witness is fetched again
        from ..circuits.composite import (
            CompositeProof,
            runtime_configs,
            verify_skip_composite,
            verify_step_composite,
        )
        from ..circuits.config import TendermintConfig

        try:
            cp = CompositeProof.from_dict(result["composite_proof"])
        except (ValueError, KeyError, TypeError) as e:
            # a malformed proof file is an invalid proof
            print(f"composite proof: MALFORMED ({e!r})")
            return 1
        cfg = TendermintConfig(chain_id=result["chain"])
        base_cfg, wrap_cfg, min_bits = runtime_configs()
        if cp.abi_inputs != input_bytes:
            print("composite proof: INPUT MISMATCH")
            return 1
        if cp.kind == "step":
            out = verify_step_composite(
                cp, cfg.chain_id, config=base_cfg, min_security_bits=min_bits, wrap_config=wrap_cfg,
            )
            header = out[2] if out else None
        else:
            out = verify_skip_composite(
                cp, cfg.chain_id, cfg.skip_max, config=base_cfg,
                min_security_bits=min_bits, wrap_config=wrap_cfg,
            )
            header = out[3] if out else None
        ok = out is not None and result["output"] == "0x" + header.hex()
        print(f"composite proof: {'OK' if ok else 'FAILED'}")
        return 0 if ok else 1

    from ..inputs.fetcher import InputDataFetcher

    fetcher = InputDataFetcher(fixture_path=args.fixture_path or "")
    max_validators = int(result["max_validators"])
    if result["circuit"] == "step":
        prev_block, prev_hash = decode_step_input(input_bytes)
        inputs = fetcher.get_step_inputs(prev_block, prev_hash, max_validators)
        lanes = inputs.next_block_validators
        expected = inputs.next_header
    else:
        t_block, t_hash, target = decode_skip_input(input_bytes)
        inputs = fetcher.get_skip_inputs(t_block, t_hash, target, max_validators)
        lanes = inputs.target_block_validators
        expected = inputs.target_header
    ok = result["output"] == "0x" + expected.hex()
    if "stark_leaf_proof" in result:
        bundle = LeafProofBundle.from_dict(result["stark_leaf_proof"])
        stark_ok = verify_leaf_bundle(bundle, lanes)
        print(f"leaf STARK proof: {'OK' if stark_ok else 'FAILED'}")
        ok = ok and stark_ok
    print(f"output binding: {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


def cmd_operator(args) -> int:
    from .operator import OperatorConfig, TendermintXOperator

    with open(args.config) as f:
        d = json.load(f)
    if args.device is not None:
        d["device"] = args.device
    op = TendermintXOperator(OperatorConfig.from_dict(d))
    op.run(max_iterations=args.iterations)
    return 0


def cmd_serve(args) -> int:
    """Run the local prover-service queue on this process's card."""
    import time

    from .service import ProverService

    svc = ProverService(
        port=args.port,
        allowed_fixture_roots=args.fixture_root,
        max_pending=args.max_pending,
        device=args.device,
    )
    if args.prewarm:
        print("prewarming the prover (one synthetic composite)...", flush=True)
        dt = svc.prewarm(max_validators=args.prewarm_validators)
        print(f"prewarmed in {dt:.1f}s", flush=True)
    svc.start()
    print(f"prover service listening on {svc.url}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        svc.stop()
    return 0


def cmd_submit(args) -> int:
    """Submit a proof request to a running service and wait for the proof."""
    from .service import ProverClient

    client = ProverClient(args.url)
    req_id = client.submit(
        args.circuit,
        args.chain,
        args.input,
        max_validators=args.max_validators,
        fixture_path=args.fixture_path,
        rpc_urls=args.rpc_url or None,
        wrap=args.wrap,
    )
    print(f"request {req_id}", flush=True)
    result = client.wait(req_id, timeout=args.timeout)
    # the wrapper cmd_verify reads (input/chain/circuit/composite_proof)
    with open(args.out, "w") as f:
        json.dump(submit_file(args.input, args.circuit, args.chain, args.max_validators, result), f)
    print(f"output {result['output']}")
    print(f"proof written to {args.out}")
    return 0


def submit_file(input_hex: str, circuit: str, chain: str, max_validators: int, result: dict) -> dict:
    """The proof file `submit` writes for a service result."""
    return {
        "input": input_hex,
        "circuit": circuit,
        "chain": chain,
        "max_validators": max_validators,
        "output": result["output"],
        "valid": True,
        "composite_proof": result["proof"],
    }


def _device_arg(parser, default):
    parser.add_argument(
        "--device",
        default=default,
        help="torch device the work runs on (default: cuda; cpu for tests)",
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tendermintx-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build", help="write a circuit artifact")
    b.add_argument("--circuit", choices=["step", "skip"], required=True)
    b.add_argument("--chain", default="celestia")
    b.add_argument("--max-validators", type=int, default=128)
    b.add_argument("--out", required=True)
    b.set_defaults(fn=cmd_build)

    pr = sub.add_parser("prove", help="run a proof request against an artifact")
    pr.add_argument("--artifact", required=True)
    pr.add_argument("--input", required=True)
    pr.add_argument("--out", default="proof.json")
    pr.add_argument("--fixture-path", default=None)
    pr.add_argument(
        "--stark",
        action="store_true",
        help="also produce the validator-leaf SHA-256 STARK proof",
    )
    pr.add_argument(
        "--composite",
        action="store_true",
        help="produce the full composite proof (hash STARK + Ed25519 STARK "
        "+ wiring), verifiable without refetching any witness data",
    )
    pr.add_argument(
        "--wrap",
        action="store_true",
        help="recursion-wrap the composite: drop openings/query rounds in "
        "favor of one wrapper STARK (constant-size proof)",
    )
    _device_arg(pr, "cuda")
    pr.set_defaults(fn=cmd_prove)

    ver = sub.add_parser("verify", help="verify a proof file (on the host)")
    ver.add_argument("--proof", required=True)
    ver.add_argument("--fixture-path", default=None)
    ver.set_defaults(fn=cmd_verify)

    op = sub.add_parser("operator", help="run the light-client operator loop")
    op.add_argument("--config", required=True)
    op.add_argument("--iterations", type=int, default=None)
    op.add_argument(
        "--device",
        default=None,
        help="torch device, overriding the config's `device` (default: cuda)",
    )
    op.set_defaults(fn=cmd_operator)

    sv = sub.add_parser("serve", help="run the local prover-service queue")
    sv.add_argument("--port", type=int, default=8642)
    sv.add_argument(
        "--fixture-root",
        action="append",
        default=None,
        help="directory requests' fixture_path may point into (repeatable);"
        " without it, request-supplied fixture paths are ignored",
    )
    sv.add_argument("--max-pending", type=int, default=64)
    sv.add_argument(
        "--prewarm",
        action="store_true",
        help="prove one synthetic composite before serving, so the first "
        "request does not pay for first-use work",
    )
    sv.add_argument("--prewarm-validators", type=int, default=8)
    _device_arg(sv, "cuda")
    sv.set_defaults(fn=cmd_serve)

    sm = sub.add_parser("submit", help="submit a request to a prover service")
    sm.add_argument("--url", required=True)
    sm.add_argument("--circuit", choices=["step", "skip"], required=True)
    sm.add_argument("--chain", default="celestia")
    sm.add_argument("--input", required=True, help="abi.encodePacked hex")
    sm.add_argument("--max-validators", type=int, default=128)
    sm.add_argument("--fixture-path", default=None)
    sm.add_argument(
        "--wrap",
        action="store_true",
        help="request a recursion-wrapped (constant-size) composite",
    )
    sm.add_argument("--rpc-url", action="append", default=None)
    sm.add_argument("--timeout", type=float, default=3600)
    sm.add_argument("--out", default="proof.json")
    sm.set_defaults(fn=cmd_submit)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
