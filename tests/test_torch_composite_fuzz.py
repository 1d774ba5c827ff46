"""Composite-proof deserialization/verification robustness of the port
(tendermintx_tpu_torch), the counterpart of tests/test_composite_fuzz.py.

Contract: a malformed composite proof must fail CLEANLY —
`CompositeProof.from_dict` may raise ValueError/KeyError/TypeError at the
boundary, and `verify_{skip,step}_composite` must return None, never
raise — so a structurally broken proof file is indistinguishable from a
cryptographically invalid one all the way through the CLI's verify and
the service result path. These tests fabricate structurally plausible
(but cryptographically meaningless) proof dicts — real hash-statement
publics and real signer keys (so publics reconstruction succeeds) wrapped
around fake STARK content — and stress-mutate them. The same nine tests,
the same seeds and mutants as the reference's, against the port's
modules; nothing here proves or imports jax.
"""

from __future__ import annotations

import random
import tempfile

import torch

torch.set_num_threads(2)

from tendermintx_tpu_torch.circuits.composite import (
    CompositeProof,
    verify_skip_composite,
    verify_step_composite,
)
from tendermintx_tpu_torch.circuits.hashing import HashBundle
from tendermintx_tpu_torch.stark.serialize import _pack

DESER_EXC = (ValueError, KeyError, TypeError, AttributeError, IndexError)

CHAIN_ID = "fuzz-chain"


def _pack_exts_flat(vals):
    return _pack([c for v in vals for c in v])


def _fake_statement_dict(publics: list[int] | None, n_rows: int, n_cols: int) -> dict:
    digest = _pack([1, 2, 3, 4])
    d = {
        "n_rows": n_rows,
        "trace_cap": digest,
        "quotient_cap": digest,
        "aux_cap": None,
        "ood_trace": [
            _pack_exts_flat([(5, 6)] * n_cols),
            _pack_exts_flat([(7, 8)] * n_cols),
        ],
        "ood_quotient": _pack_exts_flat([(9, 10)]),
        "openings": [
            [7, _pack([1] * n_cols), digest, _pack([]), _pack([]),
             _pack([1, 2]), digest]
        ],
    }
    if publics is not None:
        d["public_inputs"] = _pack(publics)
    return d


_CACHED = {}


def _real_pieces(kind: str):
    """Real hash-statement publics + signers for a tiny synthetic chain —
    enough for from_dict's publics reconstruction to succeed while every
    cryptographic claim stays fake."""
    if kind in _CACHED:
        return _CACHED[kind]
    from tendermintx_tpu_torch.circuits.hashing import (
        skip_hash_statement,
        step_hash_statement,
    )
    from tendermintx_tpu_torch.inputs.fetcher import InputDataFetcher, InputDataMode
    from tendermintx_tpu_torch.inputs.testchain import TestChain

    chain = TestChain(n_validators=2, chain_id=CHAIN_ID)
    for _ in range(4):
        chain.extend()
    tmp = tempfile.mkdtemp(prefix="fuzz_fixtures_")
    chain.write_fixtures(tmp)
    f = InputDataFetcher(fixture_path=tmp, mode=InputDataMode.FIXTURE)
    if kind == "skip":
        inputs = f.get_skip_inputs(
            1, chain.headers[1].hash(), 4, max_validators=2
        )
        air, _trace, publics, nb, nbt = skip_hash_statement(inputs)
        lanes = inputs.target_block_validators
        abi = (
            (1).to_bytes(8, "big")
            + chain.headers[1].hash()
            + (4).to_bytes(8, "big")
        )
        out = inputs.target_header
    else:
        inputs = f.get_step_inputs(3, chain.headers[3].hash(), max_validators=2)
        air, _trace, publics, nb = step_hash_statement(inputs)
        nbt = 0
        lanes = inputs.next_block_validators
        abi = (3).to_bytes(8, "big") + chain.headers[3].hash()
        out = inputs.next_header
    from tendermintx_tpu_torch.stark.ed25519_air import derive_lane_final

    signer_blobs = []
    final_blobs = []
    for i, l in enumerate(lanes[:nb]):
        if l.signed:
            msg = l.message[: l.message_byte_length]
            signer_blobs.append(i.to_bytes(2, "little") + l.signature + msg)
            fin = derive_lane_final(l.pubkey, msg, l.signature)
            final_blobs.append(
                b"".join(int(v).to_bytes(2, "little") for v in fin)
            )
    from tendermintx_tpu_torch.circuits.composite import (
        _free_hash_data,
        _pack_blobs,
    )

    hash_data, hash_aunts = _free_hash_data(
        kind, nb, nbt, air.n_blocks, publics
    )
    res = (
        _pack_blobs(hash_data), _pack_blobs(hash_aunts),
        nb, nbt, _pack_blobs(signer_blobs),
        abi.hex(), out.hex(), air.n_blocks, _pack_blobs(final_blobs),
    )
    _CACHED[kind] = res
    return res


def _fake_composite_dict(kind: str = "skip") -> dict:
    (hash_data, hash_aunts, nb, nbt, signers, abi_hex, out_hex,
     n_segments, ed_finals) = _real_pieces(kind)
    B = 2
    return {
        "kind": f"{kind}-composite",
        "version": 5,
        "ed_finals": ed_finals,
        "abi_inputs": abi_hex,
        "abi_output": out_hex,
        "round": 0,
        "nb": nb,
        "nb_trusted": nbt,
        "n_hash_segments": n_segments,
        "n_ed_segments": B,
        "n_sha512_blocks": 4,
        "hash_data": hash_data,
        "hash_aunts": hash_aunts,
        "signers": signers,
        "batch": {
            "statements": [
                _fake_statement_dict(None, n_segments * 64, 170),
                _fake_statement_dict(None, B * 256, 8),
                _fake_statement_dict(None, 4 * 128, 8),
            ],
            "fri": {
                "pow_nonce": "0",
                "layer_caps": [_pack([1, 2, 3, 4])],
                "final_poly": _pack_exts_flat([(1, 0)]),
                "query_rounds": [
                    [
                        [
                            _pack_exts_flat([(1, 2), (3, 4)]),
                            _pack([1, 2, 3, 4]),
                            _pack([1, 2, 3, 4]),
                        ]
                    ]
                ],
            },
        },
    }


def _leaf_paths(obj, prefix=()):
    """Every path to a scalar leaf, plus every (path, key/index) that can
    be dropped."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaf_paths(v, prefix + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _leaf_paths(v, prefix + (i,))
    else:
        yield prefix


def _set_path(obj, path, value):
    for k in path[:-1]:
        obj = obj[k]
    obj[path[-1]] = value


def _del_path(obj, path):
    for k in path[:-1]:
        obj = obj[k]
    del obj[path[-1]]


MUTANTS = [None, "zz", -1, str((1 << 64) - (1 << 32) + 1), 1 << 70, [], {}, "QUJDRA=="]


def fuzz_composite_dict(base: dict, verify_fn, rng: random.Random, n: int):
    """Mutate up to n sampled leaf paths; each mutant must either fail
    deserialization with a clean exception or verify to None."""
    import json

    blob = json.dumps(base)  # fast per-mutant copies (dicts are JSON-plain)
    paths = list(_leaf_paths(base))
    rng.shuffle(paths)
    # every path once if budget allows, else a sample
    for path in paths[:n]:
        for mutant in rng.sample(MUTANTS, 3) + ["__drop__"]:
            d = json.loads(blob)
            if mutant == "__drop__":
                _del_path(d, path)
            else:
                _set_path(d, path, mutant)
            try:
                proof = CompositeProof.from_dict(d)
            except DESER_EXC:
                continue  # clean rejection at the boundary
            out = verify_fn(proof)
            assert out is None, f"mutation at {path} -> {mutant!r} accepted"


def test_fabricated_skip_dict_never_raises():
    base = _fake_composite_dict("skip")
    # the unmutated fake parses (reconstruction succeeds on the real
    # pieces) but must verify to None (fake crypto)
    proof = CompositeProof.from_dict(base)
    assert verify_skip_composite(proof, CHAIN_ID, 100) is None
    fuzz_composite_dict(
        base,
        lambda p: verify_skip_composite(p, CHAIN_ID, 100),
        random.Random(7),
        n=120,
    )


def test_fabricated_step_dict_never_raises():
    base = _fake_composite_dict("step")
    proof = CompositeProof.from_dict(base)
    assert verify_step_composite(proof, CHAIN_ID) is None
    fuzz_composite_dict(
        base,
        lambda p: verify_step_composite(p, CHAIN_ID),
        random.Random(11),
        n=120,
    )


def test_hash_bundle_from_dict_rejects_cleanly():
    from tendermintx_tpu_torch.stark.serialize import stark_proof_to_dict

    def _fake_stark_dict():
        digest = ["1", "2", "3", "4"]
        return {
            "version": 3,
            "n_rows": 64,
            "public_inputs": [str(i + 1) for i in range(25)],
            "trace_cap": [digest],
            "aux_cap": None,
            "quotient_cap": [digest],
            "ood_trace": [[["5", "6"]] * 3, [["7", "8"]] * 3],
            "ood_quotient": [["9", "10"]],
            "fri": {
                "pow_nonce": "0",
                "layer_caps": [[digest]],
                "final_poly": [["1", "0"]],
                "query_rounds": [
                    [
                        {
                            "val_i": ["1", "2"],
                            "val_j": ["3", "4"],
                            "path_i": [digest],
                            "path_j": [digest],
                        }
                    ]
                ],
            },
            "openings": {
                "7": {
                    "trace_row": ["1"] * 3,
                    "trace_path": [digest],
                    "aux_row": [],
                    "aux_path": [],
                    "quot_row": ["1", "2"],
                    "quot_path": [digest],
                }
            },
        }

    good = {
        "kind": "skip-hashes",
        "n_segments": 32,
        "nb": 2,
        "nb_trusted": 2,
        "proof": _fake_stark_dict(),
    }
    HashBundle.from_dict(good)
    for bad in [
        {**good, "kind": "skip"},
        {**good, "kind": 5},
        {**good, "n_segments": "x"},
        {k: v for k, v in good.items() if k != "proof"},
    ]:
        try:
            HashBundle.from_dict(bad)
        except DESER_EXC:
            continue
        raise AssertionError(f"malformed bundle accepted: {bad.get('kind')}")


def test_composite_from_dict_kind_validation():
    d = _fake_composite_dict("skip")
    d["kind"] = "skip"  # missing suffix
    try:
        CompositeProof.from_dict(d)
    except ValueError:
        pass
    else:
        raise AssertionError("bad kind accepted")


def test_composite_from_dict_rejects_v1():
    d = _fake_composite_dict("skip")
    d["version"] = 1
    try:
        CompositeProof.from_dict(d)
    except ValueError:
        pass
    else:
        raise AssertionError("v1 composite accepted")


def test_wrong_kind_for_verifier_returns_none():
    skip = CompositeProof.from_dict(_fake_composite_dict("skip"))
    step = CompositeProof.from_dict(_fake_composite_dict("step"))
    assert verify_step_composite(skip, CHAIN_ID) is None
    assert verify_skip_composite(step, CHAIN_ID, 100) is None


def test_weak_config_rejected():
    """A config below MIN_SECURITY_BITS is refused
    before any proof content is examined."""
    from tendermintx_tpu_torch.stark.prover import StarkConfig

    weak = StarkConfig(
        rate_bits=2, n_queries=10, final_poly_len=64, proof_of_work_bits=16
    )
    assert weak.fri.security_bits < 100
    proof = CompositeProof.from_dict(_fake_composite_dict("skip"))
    assert verify_skip_composite(proof, CHAIN_ID, 100, config=weak) is None
    assert verify_step_composite(
        CompositeProof.from_dict(_fake_composite_dict("step")),
        CHAIN_ID,
        config=weak,
    ) is None


def test_plan_inner_rejects_two_free_sides():
    import pytest

    from tendermintx_tpu_torch.circuits.hashing import Plan

    plan = Plan()
    j = plan.data(1)
    plan.inner(("job", j), ("free",))  # one free side: fine
    plan.inner(("free",), ("job", j))
    with pytest.raises(ValueError):
        plan.inner(("free",), ("free",))


def test_parse_time_dos_bounds_reject_fast():
    """A crafted blob claiming a huge lane count (or spamming signer
    records) must be rejected in well under 100 ms — BEFORE the per-lane
    native EC ladder replay that from_dict runs for every signer. The
    structural format would otherwise admit 2^20 lanes at ~2-3 ms of ladder work each."""
    import time

    from tendermintx_tpu_torch.circuits.composite import MAX_ED_LANES, _pack_blobs

    base = _fake_composite_dict("skip")

    # huge claimed lane count
    huge_b = dict(base)
    huge_b["n_ed_segments"] = 1 << 20
    t0 = time.perf_counter()
    try:
        CompositeProof.from_dict(huge_b)
    except DESER_EXC:
        pass
    else:
        raise AssertionError("huge-B blob accepted")
    assert time.perf_counter() - t0 < 0.1

    # just above the deployment max
    over = dict(base)
    over["n_ed_segments"] = 2 * MAX_ED_LANES
    try:
        CompositeProof.from_dict(over)
    except DESER_EXC:
        pass
    else:
        raise AssertionError("over-max-B blob accepted")

    # lane count exceeding the claimed validator set
    wide = dict(base)
    wide["n_ed_segments"] = 64  # nb is 2 for the fuzz chain
    try:
        CompositeProof.from_dict(wide)
    except DESER_EXC:
        pass
    else:
        raise AssertionError("B > next_pow2(nb) accepted")

    # many duplicate signer records: rejected by the strictly-increasing
    # index rule before any ladder replay
    spam = dict(base)
    sig = bytes(64)
    msg = b"m" * 32
    spam["signers"] = _pack_blobs(
        [(0).to_bytes(2, "little") + sig + msg] * 256
    )
    spam["n_ed_segments"] = 256
    t0 = time.perf_counter()
    try:
        CompositeProof.from_dict(spam)
    except DESER_EXC:
        pass
    else:
        raise AssertionError("signer-spam blob accepted")
    assert time.perf_counter() - t0 < 0.1
