"""Tendermint / CometBFT hashing, written from the CometBFT specification
(``spec/core/data_structures.md``, ``spec/core/encoding.md``) and nothing
of the port: protobuf encodings, the RFC 6962 Merkle tree, the header
hash, the validator-set hash and the canonical precommit sign-bytes.

It reads the recorded-RPC JSON a node serves (``/commit``,
``/validators``): hex hashes, base64 keys and signatures, RFC 3339 times.
"""

from __future__ import annotations

import base64
import calendar
import hashlib

PRECOMMIT = 2  # SignedMsgType
BLOCK_ID_FLAG_COMMIT = 2


# -- protobuf wire format ----------------------------------------------------


def varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # int64 in two's complement, ten bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(num: int, v: int) -> bytes:
    """A varint field; proto3 leaves a zero out."""
    return varint(num << 3) + varint(v) if v else b""


def field_bytes(num: int, v: bytes) -> bytes:
    """A length-delimited field; proto3 leaves an empty one out."""
    return varint(num << 3 | 2) + varint(len(v)) + v if v else b""


def field_message(num: int, v: bytes) -> bytes:
    """An embedded message that gogoproto marks non-nullable: written even
    when empty."""
    return varint(num << 3 | 2) + varint(len(v)) + v


def field_sfixed64(num: int, v: int) -> bytes:
    return varint(num << 3 | 1) + (v % (1 << 64)).to_bytes(8, "little") if v else b""


# -- RFC 6962 Merkle tree (crypto/merkle) -------------------------------------


def merkle_root(items: list[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return hashlib.sha256(b"\x00" + items[0]).digest()
    k = 1 << ((n - 1).bit_length() - 1)  # the largest power of two below n
    return hashlib.sha256(b"\x01" + merkle_root(items[:k]) + merkle_root(items[k:])).digest()


def merkle_aunts(items: list[bytes], index: int) -> list[bytes]:
    """The siblings on the path from leaf `index` to the root, the leaf's
    own first."""
    n = len(items)
    if n <= 1:
        return []
    k = 1 << ((n - 1).bit_length() - 1)
    if index < k:
        return merkle_aunts(items[:k], index) + [merkle_root(items[k:])]
    return merkle_aunts(items[k:], index - k) + [merkle_root(items[:k])]


# -- values as the RPC serves them ---------------------------------------------


def hexbytes(s: str | None) -> bytes:
    return bytes.fromhex(s or "")


def timestamp(rfc3339: str) -> bytes:
    """google.protobuf.Timestamp of an RFC 3339 UTC time with up to nine
    fractional digits."""
    if not rfc3339.endswith("Z"):
        raise ValueError(f"not a UTC time: {rfc3339!r}")
    body = rfc3339[:-1]
    date, _, frac = body.partition(".")
    day, clock = date.split("T")
    y, mo, d = (int(x) for x in day.split("-"))
    hh, mm, ss = (int(x) for x in clock.split(":"))
    seconds = calendar.timegm((y, mo, d, hh, mm, ss, 0, 0, 0))
    nanos = int((frac + "000000000")[:9]) if frac else 0
    return field_varint(1, seconds) + field_varint(2, nanos)


def block_id(bid: dict) -> bytes:
    parts = bid.get("parts") or bid.get("part_set_header") or {}
    psh = field_varint(1, int(parts.get("total", 0))) + field_bytes(2, hexbytes(parts.get("hash")))
    return field_bytes(1, hexbytes(bid.get("hash"))) + field_message(2, psh)


# -- what a light client hashes ---------------------------------------------------


# the header's fields in the order Header.Hash() takes them
HEADER_FIELDS = (
    "version", "chain_id", "height", "time", "last_block_id", "last_commit_hash", "data_hash",
    "validators_hash", "next_validators_hash", "consensus_hash", "app_hash", "last_results_hash",
    "evidence_hash", "proposer_address",
)


def header_fields(h: dict) -> list[bytes]:
    """The 14 fields of a header, each encoded alone."""
    version = field_varint(1, int(h["version"]["block"])) + field_varint(2, int(h["version"].get("app", 0)))
    return [
        version,
        field_bytes(1, h["chain_id"].encode()),
        field_varint(1, int(h["height"])),
        timestamp(h["time"]),
        block_id(h["last_block_id"]),
    ] + [field_bytes(1, hexbytes(h[k])) for k in HEADER_FIELDS[5:]]


def header_hash(h: dict) -> bytes:
    """Header.Hash(): the Merkle root of its fields."""
    return merkle_root(header_fields(h))


def simple_validator(v: dict) -> bytes:
    """SimpleValidator{pub_key: PublicKey{ed25519}, voting_power}, the leaf
    of the validator-set hash."""
    if v["pub_key"]["type"] != "tendermint/PubKeyEd25519":
        raise ValueError(f"not an Ed25519 key: {v['pub_key']['type']}")
    pubkey = base64.b64decode(v["pub_key"]["value"])
    return field_message(1, field_bytes(1, pubkey)) + field_varint(2, int(v["voting_power"]))


def validators_hash(vals: list[dict]) -> bytes:
    return merkle_root([simple_validator(v) for v in vals])


def precommit_sign_bytes(commit: dict, sig: dict, chain_id: str) -> bytes:
    """The length-prefixed CanonicalVote that validator `sig` signed for
    `commit`'s block."""
    vote = (
        field_varint(1, PRECOMMIT)
        + field_sfixed64(2, int(commit["height"]))
        + field_sfixed64(3, int(commit["round"]))
        + field_message(4, block_id(commit["block_id"]))
        + field_message(5, timestamp(sig["timestamp"]))
        + field_bytes(6, chain_id.encode())
    )
    return varint(len(vote)) + vote
