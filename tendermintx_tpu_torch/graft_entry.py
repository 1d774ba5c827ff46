"""Entry points of the port: the skip verification program, and a
multi-device dry run over a lane mesh.

Counterpart of the repository root's ``__graft_entry__.py``.

``entry(device)`` returns ``(fn, example_args)``: ``fn`` is the full skip
verification (Ed25519 batch ladder + SHA-256 validator hashing + dynamic
CometBFT Merkle + voting thresholds + header proofs) over a synthetic
witness of 4 validators in 8 lanes, whose arguments are on `device`.

``dryrun_multichip(n_devices, devices=None, shape="default")`` builds an
n-device lane mesh (parallel/sharding.py) and runs the sharded lane checks,
a data-parallel Poseidon batch and a sharded prove of one statement (the
shape: a 2-block SHA-256 STARK, the 16-column toy mix AIR, or a 7-block
SHA-256 STARK at 12 queries), each checked against its single-device
result; the sharded proof is also verified on the host.

    python -m tendermintx_tpu_torch.graft_entry [--device cpu] [--mesh N] [--shape toy]
"""

from __future__ import annotations

import argparse
import tempfile

import torch

CHAIN_ID = "graft-chain"


def _build_skip_witness(n_validators: int, max_validators: int):
    from .circuits.variables import pack_skip_witness
    from .inputs.fetcher import InputDataFetcher, InputDataMode
    from .inputs.testchain import TestChain

    chain = TestChain(n_validators=n_validators, chain_id=CHAIN_ID)
    for _ in range(4):
        chain.extend()
    with tempfile.TemporaryDirectory(prefix="graft_fixtures_") as tmp:
        chain.write_fixtures(tmp)
        fetcher = InputDataFetcher(fixture_path=tmp, mode=InputDataMode.FIXTURE)
        inputs = fetcher.get_skip_inputs(1, chain.headers[1].hash(), 5, max_validators=max_validators)
    return chain, pack_skip_witness(inputs)


def entry(device="cuda"):
    """(fn, example_args): fn(*example_args) -> (valid, target_header),
    the skip verification of block 1 -> 5 on `device` (the card unless
    the caller names another; raises when CUDA is asked for and absent)."""
    from .circuits.verify import chain_id_leaf_const, skip_verify
    from .runtime.devices import require_device

    dev = require_device(device)
    chain, witness = _build_skip_witness(n_validators=4, max_validators=8)
    cid_leaf, cid_len = chain_id_leaf_const(CHAIN_ID)
    trusted_hash = torch.frombuffer(bytearray(chain.headers[1].hash()), dtype=torch.uint8)

    def fn(w, trusted_hash, cid_leaf, cid_len):
        return skip_verify(w, trusted_hash, 1, 0, 5, 0, cid_leaf, cid_len, skip_max=100_800)

    return fn, (witness.to(dev), trusted_hash.to(dev), cid_leaf.to(dev), cid_len)


SHAPES = ("default", "toy", "full")


def dryrun_multichip(n_devices: int, devices=None, *, shape: str = "default") -> None:
    """One sharded verification step and one sharded prove on an
    n-device lane mesh (``make_lane_mesh(n_devices, devices)``: the
    visible cards unless `devices` lists others); raises AssertionError
    when a sharded result differs from its single-device counterpart or
    the sharded proof does not verify. `shape` picks the proven statement
    (``dryrun_statement``)."""
    from .circuits import gadgets as g
    from .ops import poseidon as ps
    from .ops.goldilocks import GF
    from .parallel.sharding import make_lane_mesh, sharded_lane_checks, sharded_poseidon_throughput
    from .stark.prover import prove
    from .stark.serialize import stark_proof_to_dict
    from .stark.verifier import verify

    if shape not in SHAPES:
        raise ValueError(f"unknown dry-run shape {shape!r}; one of {SHAPES}")
    mesh = make_lane_mesh(n_devices, devices)
    dev = mesh.first
    # the lane count must divide over the mesh; max_validators is 2n
    max_validators = max(2 * n_devices, 8)
    n_validators = max(4, n_devices)
    chain, witness = _build_skip_witness(n_validators, max_validators)
    lv = witness.lanes.to(dev)
    sig_ok, digests, signed_power, total_power = sharded_lane_checks(mesh)(
        lv.table_x, lv.table_y, lv.table_t, lv.bits2, lv.rx, lv.ry,
        lv.sig_r, lv.sig_s, lv.sig_pubkeys, lv.messages, lv.msg_len, lv.k_q,
        lv.leaf_bytes, lv.leaf_len, lv.vp_lo, lv.vp_hi, lv.signed, lv.enabled,
    )
    _check(bool(sig_ok), "sharded signature verification failed")
    single = g.hash_validator_leaves(lv.leaf_bytes, lv.leaf_len)
    _check(torch.equal(digests, single), "sharded leaf digests differ from the single-device gadget")
    total = sum(v.voting_power for v in chain.val_set)
    got = int(total_power[0]) | (int(total_power[1]) << 32)
    _check(got == total, f"sharded total voting power {got} != {total}")
    _check(int(signed_power[0]) | (int(signed_power[1]) << 32) <= total, "signed power above the total")

    # data-parallel Poseidon batch over the same mesh
    states = GF(torch.arange(n_devices * 4 * 12, dtype=torch.int64, device=dev).reshape(n_devices * 4, 12))
    out = sharded_poseidon_throughput(mesh)(states)
    _check(torch.equal(out.v, ps.permute(states).v), "sharded Poseidon batch differs")

    # sharded PROVE of the shape's statement, verified on the host and
    # equal to the single-device proof of the same statement
    air, trace, publics, cfg = dryrun_statement(shape, dev)
    proof = prove(air, trace, publics, cfg, mesh=mesh)
    _check(verify(air, proof, cfg), f"sharded {shape} proof invalid")
    alone = prove(air, trace, publics, cfg)
    _check(
        stark_proof_to_dict(proof) == stark_proof_to_dict(alone),
        f"sharded {shape} proof differs from the single-device proof",
    )


def dryrun_statement(shape: str, device):
    """(air, trace on `device`, publics, config) of a dry-run shape:
    "default", the smallest real product statement, a 2-block SHA-256 AIR
    (170 columns, full compression constraints); "toy", the 16-column
    degree-2 mix AIR at 256 rows; "full", a 7-block SHA-256 AIR at 12
    queries."""
    from .stark.prover import StarkConfig
    from .stark.sha256_air import Sha256Air, schedule_messages, sha256_batch_trace

    if shape == "toy":
        air, trace, publics = dryrun_air(256, device)
        return air, trace, publics, StarkConfig(rate_bits=2, n_queries=4, final_poly_len=4)
    if shape == "full":
        msgs = [bytes([i]) * (20 + i) for i in range(6)] + [b"x" * 90]
        cfg = StarkConfig(rate_bits=2, n_queries=12, final_poly_len=8)
    elif shape == "default":
        msgs = [b"ab", b"x" * 40]
        cfg = StarkConfig(rate_bits=2, n_queries=4, final_poly_len=8, proof_of_work_bits=4)
    else:
        raise ValueError(f"unknown dry-run shape {shape!r}; one of {SHAPES}")
    blocks, chain_flags, _ = schedule_messages(msgs)
    trace, publics = sha256_batch_trace(blocks, chain_flags, device)
    return Sha256Air(len(blocks)), trace, publics, cfg


def dryrun_air(n_rows: int, device=None):
    """A 16-column degree-2 'mix' AIR, its trace on `device` and its
    publics: next[i] = local[i] * local[(i+1) % 16] + local[(i+2) % 16],
    the first row pinned to the 16 public inputs."""
    import numpy as np

    from .ops.goldilocks import GF, P
    from .stark.air import Air

    class MixAir(Air):
        n_cols = 16
        n_public = 16
        constraint_degree = 2

        def eval_transition(self, frame, alg):
            loc, nxt = frame.local, frame.next
            return [nxt[i] - (loc[i] * loc[(i + 1) % 16] + loc[(i + 2) % 16]) for i in range(16)]

        def eval_first(self, frame, alg):
            return [frame.local[i] - frame.public[i] for i in range(16)]

    rows = [[(i * 7 + 3) % P for i in range(16)]]
    for _ in range(n_rows - 1):
        r = rows[-1]
        rows.append([(r[i] * r[(i + 1) % 16] + r[(i + 2) % 16]) % P for i in range(16)])
    cols = np.array(rows, dtype=object).T
    return MixAir(), GF.from_ints(cols, device), list(rows[0])


def _check(ok: bool, what: str):
    # an explicit raise, not an assert: the dry run is a check under -O too
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="device of entry() and of the mesh's shards")
    ap.add_argument("--mesh", type=int, default=0, help="shards of the dry run (0: no dry run)")
    ap.add_argument("--shape", choices=SHAPES, default="default", help="statement the dry run proves")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    valid, _ = fn(*example)
    print("entry() skip_verify valid:", bool(valid))
    if args.mesh:
        # the visible cards, or as many CPU shards as asked for
        dev = torch.device(args.device)
        dryrun_multichip(args.mesh, None if dev.type == "cuda" else [dev] * args.mesh, shape=args.shape)
        print(f"dryrun_multichip({args.mesh}, shape={args.shape!r}) OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
