"""Native CometBFT/Tendermint domain layer: protobuf encodings, RFC-6962
Merkle trees, header & validator-set hashing, canonical vote sign-bytes.

TPU-framework equivalent of the reference's `circuits/input/tendermint_utils.rs`
(leaf/inner hashing :358-372, get_split_point :338-349, proof builders
:276-336, header field encoding :374-393, vote extraction :404-441,
is_valid_skip :444-482) and the tendermint-rs/tendermint-proto crates it
consumes (SURVEY.md N15). Everything here is host-side Python — it feeds
witness generation; the same byte semantics are re-verified in-circuit.

All encodings verified bit-exactly against recorded mocha-4 RPC fixtures.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from datetime import datetime, timezone

# ---------------------------------------------------------------------------
# Protobuf primitives (proto3 wire format)
# ---------------------------------------------------------------------------


def encode_varint(value: int) -> bytes:
    """Unsigned LEB128 varint."""
    assert value >= 0
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint(field_number << 3 | wire_type)


def _len_delim(field_number: int, payload: bytes) -> bytes:
    return _tag(field_number, 2) + encode_varint(len(payload)) + payload


def _uvarint_field(field_number: int, value: int) -> bytes:
    if value == 0:
        return b""
    return _tag(field_number, 0) + encode_varint(value)


def _sfixed64_field(field_number: int, value: int) -> bytes:
    return _tag(field_number, 1) + (value & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")


# ---------------------------------------------------------------------------
# Timestamps
# ---------------------------------------------------------------------------


def parse_rfc3339(ts: str) -> tuple[int, int]:
    """RFC3339 timestamp -> (unix seconds, nanoseconds)."""
    assert ts.endswith("Z")
    body = ts[:-1]
    if "." in body:
        main, frac = body.split(".")
        nanos = int(frac.ljust(9, "0")[:9])
    else:
        main, nanos = body, 0
    dt = datetime.strptime(main, "%Y-%m-%dT%H:%M:%S").replace(tzinfo=timezone.utc)
    return int(dt.timestamp()), nanos


def encode_timestamp(seconds: int, nanos: int) -> bytes:
    return _uvarint_field(1, seconds) + _uvarint_field(2, nanos)


# ---------------------------------------------------------------------------
# RFC-6962-style Merkle tree (as used by CometBFT)
# ---------------------------------------------------------------------------

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"
HASH_SIZE = 32


def leaf_hash(data: bytes) -> bytes:
    return hashlib.sha256(LEAF_PREFIX + data).digest()


def inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(INNER_PREFIX + left + right).digest()


def get_split_point(n: int) -> int:
    """Largest power of two strictly less than n."""
    assert n > 1
    return 1 << (n - 1).bit_length() - 1


def merkle_root(leaves: list[bytes]) -> bytes:
    """Root over raw byte slices (hashed as leaves)."""
    n = len(leaves)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return leaf_hash(leaves[0])
    k = get_split_point(n)
    return inner_hash(merkle_root(leaves[:k]), merkle_root(leaves[k:]))


@dataclass
class MerkleProof:
    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes]


def proofs_from_byte_slices(items: list[bytes]) -> tuple[bytes, list[MerkleProof]]:
    """Root plus one inclusion proof per item (CometBFT ordering)."""
    root, trails = _trails_from_byte_slices(items)
    proofs = [
        MerkleProof(
            total=len(items), index=i, leaf_hash=t.hash, aunts=t.flatten_aunts()
        )
        for i, t in enumerate(trails)
    ]
    return root, proofs


class _ProofNode:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent = None
        self.left = None  # sibling on the left
        self.right = None  # sibling on the right

    def flatten_aunts(self) -> list[bytes]:
        aunts = []
        node = self
        while node is not None:
            if node.left is not None:
                aunts.append(node.left.hash)
            if node.right is not None:
                aunts.append(node.right.hash)
            node = node.parent
        return aunts


def _trails_from_byte_slices(items: list[bytes]):
    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest(), []
    if n == 1:
        node = _ProofNode(leaf_hash(items[0]))
        return node.hash, [node]
    k = get_split_point(n)
    left_root, left_trails = _trails_from_byte_slices(items[:k])
    right_root, right_trails = _trails_from_byte_slices(items[k:])
    root = inner_hash(left_root, right_root)
    root_node = _ProofNode(root)
    # left subtree nodes get the right sibling as their aunt, and vice versa
    left_top = left_trails[0]
    while left_top.parent is not None:
        left_top = left_top.parent
    right_top = right_trails[0]
    while right_top.parent is not None:
        right_top = right_top.parent
    left_top.parent = root_node
    left_top.right = _ProofNode(right_root)
    right_top.parent = root_node
    right_top.left = _ProofNode(left_root)
    return root, left_trails + right_trails


def verify_merkle_proof(root: bytes, proof: MerkleProof, leaf_data: bytes) -> bool:
    if leaf_hash(leaf_data) != proof.leaf_hash:
        return False
    return _compute_from_aunts(proof.index, proof.total, proof.leaf_hash, proof.aunts) == root


def _compute_from_aunts(index: int, total: int, leaf: bytes, aunts: list[bytes]):
    if total == 1:
        return leaf if not aunts else None
    if not aunts:
        return None
    k = get_split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, leaf, aunts[:-1])
        if left is None:
            return None
        return inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, leaf, aunts[:-1])
    if right is None:
        return None
    return inner_hash(aunts[-1], right)


def get_path_indices(index: int, total: int) -> list[bool]:
    """Left/right path bits bottom-up for (index, total), matching the
    reference's circuits/input/utils.rs:12-23 semantics."""
    path = []
    idx, tot = index, total
    while tot > 1:
        k = get_split_point(tot)
        if idx < k:
            path.append(False)
            tot = k
        else:
            path.append(True)
            idx -= k
            tot -= k
    # bits were collected top-down; the circuit wants bottom-up
    return list(reversed(path))


# ---------------------------------------------------------------------------
# Domain types
# ---------------------------------------------------------------------------


@dataclass
class PartSetHeader:
    total: int
    hash: bytes

    def encode(self) -> bytes:
        return _uvarint_field(1, self.total) + (
            _len_delim(2, self.hash) if self.hash else b""
        )


@dataclass
class BlockID:
    hash: bytes
    parts: PartSetHeader

    def encode(self) -> bytes:
        out = b""
        if self.hash:
            out += _len_delim(1, self.hash)
        parts = self.parts.encode()
        if parts:
            out += _len_delim(2, parts)
        return out


@dataclass
class Header:
    version_block: int
    version_app: int
    chain_id: str
    height: int
    time_seconds: int
    time_nanos: int
    last_block_id: BlockID | None
    last_commit_hash: bytes
    data_hash: bytes
    validators_hash: bytes
    next_validators_hash: bytes
    consensus_hash: bytes
    app_hash: bytes
    last_results_hash: bytes
    evidence_hash: bytes
    proposer_address: bytes

    def field_bytes(self) -> list[bytes]:
        """The 14 protobuf-encoded leaves, in canonical header order
        (reference: tendermint_utils.rs:374-393)."""
        version = _uvarint_field(1, self.version_block) + _uvarint_field(
            2, self.version_app
        )
        lbi = self.last_block_id.encode() if self.last_block_id else b""
        return [
            version,
            _len_delim(1, self.chain_id.encode()),
            _uvarint_field(1, self.height),
            encode_timestamp(self.time_seconds, self.time_nanos),
            lbi,
            _len_delim(1, self.last_commit_hash),
            _len_delim(1, self.data_hash),
            _len_delim(1, self.validators_hash),
            _len_delim(1, self.next_validators_hash),
            _len_delim(1, self.consensus_hash),
            _len_delim(1, self.app_hash),
            _len_delim(1, self.last_results_hash),
            _len_delim(1, self.evidence_hash),
            _len_delim(1, self.proposer_address),
        ]

    def hash(self) -> bytes:
        return merkle_root(self.field_bytes())

    @classmethod
    def from_rpc(cls, h: dict) -> "Header":
        sec, nanos = parse_rfc3339(h["time"])
        lbi = h.get("last_block_id")
        block_id = None
        if lbi and lbi.get("hash"):
            block_id = BlockID(
                hash=bytes.fromhex(lbi["hash"]),
                parts=PartSetHeader(
                    total=int(lbi["parts"]["total"]),
                    hash=bytes.fromhex(lbi["parts"]["hash"]),
                ),
            )
        return cls(
            version_block=int(h["version"]["block"]),
            version_app=int(h["version"].get("app", 0)),
            chain_id=h["chain_id"],
            height=int(h["height"]),
            time_seconds=sec,
            time_nanos=nanos,
            last_block_id=block_id,
            last_commit_hash=bytes.fromhex(h["last_commit_hash"]),
            data_hash=bytes.fromhex(h["data_hash"]),
            validators_hash=bytes.fromhex(h["validators_hash"]),
            next_validators_hash=bytes.fromhex(h["next_validators_hash"]),
            consensus_hash=bytes.fromhex(h["consensus_hash"]),
            app_hash=bytes.fromhex(h["app_hash"]),
            last_results_hash=bytes.fromhex(h["last_results_hash"]),
            evidence_hash=bytes.fromhex(h["evidence_hash"]),
            proposer_address=bytes.fromhex(h["proposer_address"]),
        )


@dataclass
class Validator:
    address: bytes
    pubkey: bytes  # 32-byte ed25519
    voting_power: int

    def simple_encode(self) -> bytes:
        """SimpleValidator protobuf: 0a 22 0a 20 <pk32> 10 <varint vp>
        (reference: circuits/builder/validator.rs:185-207)."""
        pk = _len_delim(1, _len_delim(1, self.pubkey))
        return pk + _uvarint_field(2, self.voting_power)

    @classmethod
    def from_rpc(cls, v: dict) -> "Validator":
        import base64

        return cls(
            address=bytes.fromhex(v["address"]),
            pubkey=base64.b64decode(v["pub_key"]["value"]),
            voting_power=int(v["voting_power"]),
        )


def validators_hash(validators: list[Validator]) -> bytes:
    return merkle_root([v.simple_encode() for v in validators])


@dataclass
class CommitSig:
    block_id_flag: int  # 1 absent, 2 commit, 3 nil
    validator_address: bytes
    timestamp: tuple[int, int]  # (seconds, nanos)
    signature: bytes | None

    @classmethod
    def from_rpc(cls, s: dict) -> "CommitSig":
        import base64

        ts = (0, 0)
        if s.get("timestamp") and not s["timestamp"].startswith("0001-01-01"):
            ts = parse_rfc3339(s["timestamp"])
        return cls(
            block_id_flag=int(s["block_id_flag"]),
            validator_address=bytes.fromhex(s["validator_address"])
            if s.get("validator_address")
            else b"",
            timestamp=ts,
            signature=base64.b64decode(s["signature"]) if s.get("signature") else None,
        )


@dataclass
class Commit:
    height: int
    round: int
    block_id: BlockID
    signatures: list[CommitSig]

    @classmethod
    def from_rpc(cls, c: dict) -> "Commit":
        return cls(
            height=int(c["height"]),
            round=int(c["round"]),
            block_id=BlockID(
                hash=bytes.fromhex(c["block_id"]["hash"]),
                parts=PartSetHeader(
                    total=int(c["block_id"]["parts"]["total"]),
                    hash=bytes.fromhex(c["block_id"]["parts"]["hash"]),
                ),
            ),
            signatures=[CommitSig.from_rpc(s) for s in c["signatures"]],
        )


# ---------------------------------------------------------------------------
# Canonical vote sign-bytes (what validators actually sign)
# ---------------------------------------------------------------------------

PRECOMMIT_TYPE = 2


def canonical_vote_sign_bytes(
    commit: Commit, sig: CommitSig, chain_id: str
) -> bytes:
    """Length-prefixed CanonicalVote protobuf for a precommit
    (reference: circuits/input/conversion.rs:22-56 via tendermint-rs
    SignedVote::sign_bytes). Nil votes (flag 3) sign an empty block id."""
    body = b""
    body += _uvarint_field(1, PRECOMMIT_TYPE)
    body += _sfixed64_field(2, commit.height)
    if commit.round != 0:
        body += _sfixed64_field(3, commit.round)
    if sig.block_id_flag == 2:
        bid = b""
        bid += _len_delim(1, commit.block_id.hash)
        parts = (
            _uvarint_field(1, commit.block_id.parts.total)
            + _len_delim(2, commit.block_id.parts.hash)
        )
        bid += _len_delim(2, parts)
        body += _len_delim(4, bid)
    ts = encode_timestamp(*sig.timestamp)
    body += _len_delim(5, ts)
    body += _len_delim(6, chain_id.encode())
    return encode_varint(len(body)) + body


# ---------------------------------------------------------------------------
# Voting power / skip validity (native predicates)
# ---------------------------------------------------------------------------


def total_voting_power(validators: list[Validator]) -> int:
    return sum(v.voting_power for v in validators)


def signed_voting_power(commit: Commit, validators: list[Validator]) -> int:
    total = 0
    for v, s in zip(validators, commit.signatures):
        if s.block_id_flag == 2:
            total += v.voting_power
    return total


def is_valid_skip(
    trusted_validators: list[Validator],
    target_validators: list[Validator],
    target_commit: Commit,
) -> bool:
    """Native 1/3-intersection + 2/3-commit predicate
    (reference: tendermint_utils.rs:444-482): the voting power of *trusted*
    validators that signed the target commit must exceed 1/3 of the trusted
    total, and the target commit must carry >2/3 of the target total."""
    trusted_by_pubkey = {v.pubkey: v for v in trusted_validators}
    shared_power = 0
    for v, s in zip(target_validators, target_commit.signatures):
        if s.block_id_flag == 2 and v.pubkey in trusted_by_pubkey:
            shared_power += trusted_by_pubkey[v.pubkey].voting_power
    trusted_total = total_voting_power(trusted_validators)
    if 3 * shared_power <= trusted_total:
        return False
    target_total = total_voting_power(target_validators)
    if 3 * signed_voting_power(target_commit, target_validators) <= 2 * target_total:
        return False
    return True
