"""The comparison that decides ``correct``.

Every answer due in the window is judged after the window closes, on the
host, by the benchmark's own reference alone: ``ref/cometbft.py`` (header,
validator-set and sign-bytes hashing written from the CometBFT
specification), ``hashlib`` and ``cryptography``'s Ed25519. Nothing of the
port is imported. It reads the fixture files the service read, and works
out again from them what each answer has to say and hold. The proof is
read as the wire carries it (``ref/wire.py``).

- ``unanswered``: requests sent in the window that failed or never came;
- ``weak_proofs``: proofs that cannot be read, or whose FRI, as the proof
  shows it, opens another number of queries, folds another number of
  layers, ends in another final polynomial or commits to caps of another
  size than the configuration states, wrapped or not;
- ``wrong_claims``: proofs whose kind, wrapping, ABI input or output, or
  whose header leaves and Merkle aunts, are not the chain's: the trusted
  (or previous) and target heights and header hashes;
- ``wrong_validators``: proofs whose validator leaves are not the
  fixture's sets (keys and powers, in order), or whose counts differ, or
  sets whose hash is not the one their header commits to;
- ``wrong_signatures``: signer lanes that are not a valid precommit
  signature of the target commit by the validator the lane names, or a
  lane count other than the commit's signers.

Whether the STARK itself is sound, that its openings and constraints hold,
has no independent reference here: the port's own host verifier accepts
each proof before the service answers.

Each limit is 0: a count of wrong answers.
"""

from __future__ import annotations

import json
import os

from ref import cometbft, wire

LIMITS = {
    "unanswered": 0,
    "weak_proofs": 0,
    "wrong_claims": 0,
    "wrong_validators": 0,
    "wrong_signatures": 0,
}

# header leaves a hash statement proves, in its plan's order: (header,
# field index); "target" is the target (next) header, "start" the trusted
# (previous) one
VALIDATORS_HASH, CHAIN_ID, HEIGHT, LAST_BLOCK_ID, NEXT_VALIDATORS_HASH = 7, 1, 2, 4, 8
HEADER_LEAVES = {
    "skip": [("target", VALIDATORS_HASH), ("target", CHAIN_ID), ("target", HEIGHT), ("start", VALIDATORS_HASH)],
    "step": [("target", VALIDATORS_HASH), ("target", CHAIN_ID), ("target", HEIGHT), ("target", LAST_BLOCK_ID),
             ("start", NEXT_VALIDATORS_HASH)],
}


def _fixture(fixtures_dir: str, height: int) -> tuple[dict, dict, list]:
    with open(os.path.join(fixtures_dir, str(height), "commit.json")) as f:
        sh = json.load(f)["result"]["signed_header"]
    with open(os.path.join(fixtures_dir, str(height), "validators_1.json")) as f:
        vals = json.load(f)["result"]["validators"]
    return sh["header"], sh["commit"], vals


def _signatures_wrong(proof: dict, commit: dict, vals: list, chain_id: str) -> int:
    import base64

    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

    sigs = commit["signatures"]
    signing = {i for i, s in enumerate(sigs) if s["block_id_flag"] == cometbft.BLOCK_ID_FLAG_COMMIT}
    lanes = wire.signers(proof)
    wrong = abs(len(lanes) - len(signing)) + len(lanes) - len({i for i, _, _ in lanes})
    for index, signature, message in lanes:
        if index not in signing or index >= len(vals):
            wrong += 1
            continue
        sig = sigs[index]
        msg = cometbft.precommit_sign_bytes(commit, sig, chain_id)
        if signature != base64.b64decode(sig["signature"]) or message != msg:
            wrong += 1
            continue
        try:
            Ed25519PublicKey.from_public_bytes(base64.b64decode(vals[index]["pub_key"]["value"])).verify(
                signature, msg)
        except InvalidSignature:
            wrong += 1
    return wrong


def _validators_wrong(proof: dict, circuit: str, sets: list[tuple[dict, list]]) -> bool:
    """`sets`: (header, validators) of the target, then, for a skip, of the
    trusted height: the sets whose leaves the hash statement carries."""
    leaves = wire.blobs(proof["hash_data"])
    counts = [int(proof["nb"])] + ([int(proof["nb_trusted"])] if circuit == "skip" else [])
    at = 0
    for (header, vals), n in zip(sets, counts):
        enc = [cometbft.simple_validator(v) for v in vals]
        if n != len(vals) or leaves[at:at + n] != [b"\x00" + e for e in enc]:
            return True
        if cometbft.merkle_root(enc) != cometbft.hexbytes(header["validators_hash"]):
            return True
        at += n
    return False


def _header_leaves_wrong(proof: dict, circuit: str, headers: dict, n_leaves: int) -> bool:
    """The header leaves after the validator leaves, and the Merkle aunts
    that carry each to its header's hash, against the headers' own."""
    want_leaves, want_aunts = [], []
    for which, index in HEADER_LEAVES[circuit]:
        fields = cometbft.header_fields(headers[which])
        want_leaves.append(b"\x00" + fields[index])
        want_aunts += cometbft.merkle_aunts(fields, index)
    return (wire.blobs(proof["hash_data"])[n_leaves:] != want_leaves
            or wire.blobs(proof["hash_aunts"]) != want_aunts)


def judge(cfg: dict, wrapped: bool, fixtures_dir: str, answers: list[tuple]) -> tuple[dict, list]:
    """answers: (request, result dict or None) for every request sent in
    the window; `wrapped`: whether the requests asked for the wrapped
    proof. Returns ({name: value}, the proofs, as dicts, of the answers
    whose FRI reads as stated)."""
    base, wrap = cfg["stark"], cfg["wrap_stark"]
    chain_id = cfg["chain_id"]
    counts = dict.fromkeys(LIMITS, 0)
    readable = []
    for req, result in answers:
        if result is None:
            counts["unanswered"] += 1
            continue
        proof = result.get("proof") if isinstance(result, dict) else None
        try:
            weak = wire.fri_shape_wrong(proof, base, wrap)
        except (ValueError, KeyError, TypeError, IndexError, AttributeError):
            weak = True
        if weak:
            counts["weak_proofs"] += 1
            continue
        readable.append(proof)
        start_h, _, start_v = _fixture(fixtures_dir, req.start)
        target_h, target_c, target_v = _fixture(fixtures_dir, req.target)
        start_hash, target_hash = cometbft.header_hash(start_h), cometbft.header_hash(target_h)
        try:
            abi_in, abi_out = bytes.fromhex(proof["abi_inputs"]), bytes.fromhex(proof["abi_output"])
            claims_bad = (
                proof["kind"] != f"{req.circuit}-composite"
                or wire.is_wrapped(proof) != wrapped
                or abi_in != bytes.fromhex(req.input_hex.removeprefix("0x"))
                or abi_in[8:40] != start_hash
                or int.from_bytes(abi_in[:8], "big") != req.start
                or (req.circuit == "skip" and int.from_bytes(abi_in[40:48], "big") != req.target)
                or int(target_h["height"]) != req.target
                or abi_out != target_hash
                or result.get("output") != "0x" + target_hash.hex()
                or _header_leaves_wrong(proof, req.circuit, {"start": start_h, "target": target_h},
                                        int(proof["nb"]) + int(proof["nb_trusted"]))
            )
        except (ValueError, KeyError, TypeError, IndexError, AttributeError):
            claims_bad = True
        counts["wrong_claims"] += int(claims_bad)
        sets = [(target_h, target_v)] + ([(start_h, start_v)] if req.circuit == "skip" else [])
        try:
            vals_bad = _validators_wrong(proof, req.circuit, sets)
        except (ValueError, KeyError, TypeError, IndexError, AttributeError):
            vals_bad = True
        counts["wrong_validators"] += int(vals_bad)
        try:
            counts["wrong_signatures"] += _signatures_wrong(proof, target_c, target_v, chain_id)
        except (ValueError, KeyError, TypeError, IndexError, AttributeError):
            counts["wrong_signatures"] += 1
    return counts, readable


def correct(counts: dict, attempted: int) -> bool:
    return attempted > 0 and all(counts[k] <= LIMITS[k] for k in LIMITS)
