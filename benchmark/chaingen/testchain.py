# Frozen copy of tendermintx_tpu_torch/inputs/testchain.py at commit a7cc570: the benchmark's
# fixture chain generator (inputs only; the comparison that decides `correct` does not
# use it). Later changes to the port do not reach it.
"""Synthetic Tendermint chain generator for hermetic tests.

The reference tests hermetically by replaying recorded RPC JSON fixtures
(input/mod.rs:100-107 fixture mode). We support that too, but recorded
fixtures can't exercise every path (the reference flags "no test for commits
with round != 0", verify.rs:612). This module generates a fully valid
synthetic chain — real ed25519 keys, bit-exact header hashing, canonical vote
sign-bytes — with configurable validator counts, voting powers, rounds, and
absent/nil votes, and can serve it in the recorded-RPC JSON shape so the
fixture fetcher consumes it unchanged.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from dataclasses import dataclass

from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from .tendermint import (
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
    Validator,
    canonical_vote_sign_bytes,
    validators_hash,
)


def _rfc3339(seconds: int, nanos: int) -> str:
    from datetime import datetime, timezone

    dt = datetime.fromtimestamp(seconds, tz=timezone.utc)
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    return f"{base}.{nanos:09d}Z" if nanos else base + "Z"


@dataclass
class TestValidator:
    key: Ed25519PrivateKey
    voting_power: int

    @property
    def pubkey(self) -> bytes:
        return self.key.public_key().public_bytes_raw()

    @property
    def address(self) -> bytes:
        return hashlib.sha256(self.pubkey).digest()[:20]

    def as_validator(self) -> Validator:
        return Validator(
            address=self.address, pubkey=self.pubkey, voting_power=self.voting_power
        )


class TestChain:
    """Deterministic synthetic chain for a fixed validator set."""

    __test__ = False  # not a pytest class

    def __init__(
        self,
        n_validators: int = 4,
        chain_id: str = "test-chain",
        powers: list[int] | None = None,
        seed: bytes = b"tendermintx-tpu testchain",
    ):
        self.chain_id = chain_id
        self.validators = []
        for i in range(n_validators):
            key_seed = hashlib.sha256(seed + i.to_bytes(4, "big")).digest()
            power = powers[i] if powers else 10 + i
            self.validators.append(
                TestValidator(
                    key=Ed25519PrivateKey.from_private_bytes(key_seed),
                    voting_power=power,
                )
            )
        self.val_set = [v.as_validator() for v in self.validators]
        self.vhash = validators_hash(self.val_set)
        self.headers: dict[int, Header] = {}
        self.commits: dict[int, Commit] = {}
        self._build_genesis()

    def _build_genesis(self):
        self._make_block(1, prev_hash=None, round=0, signers=None)

    def _zero_hash(self) -> bytes:
        return hashlib.sha256(b"").digest()

    def _make_block(
        self,
        height: int,
        prev_hash: bytes | None,
        round: int,
        signers: list[int] | None,
    ):
        last_block_id = None
        if prev_hash is not None:
            last_block_id = BlockID(
                hash=prev_hash,
                parts=PartSetHeader(total=1, hash=hashlib.sha256(prev_hash).digest()),
            )
        header = Header(
            version_block=11,
            version_app=1,
            chain_id=self.chain_id,
            height=height,
            time_seconds=1_700_000_000 + height * 12,
            time_nanos=123456789,
            last_block_id=last_block_id,
            last_commit_hash=self._zero_hash(),
            data_hash=self._zero_hash(),
            validators_hash=self.vhash,
            next_validators_hash=self.vhash,
            consensus_hash=self._zero_hash(),
            app_hash=hashlib.sha256(b"app" + height.to_bytes(8, "big")).digest(),
            last_results_hash=self._zero_hash(),
            evidence_hash=self._zero_hash(),
            proposer_address=self.validators[0].address,
        )
        self.headers[height] = header
        block_hash = header.hash()
        block_id = BlockID(
            hash=block_hash,
            parts=PartSetHeader(total=1, hash=hashlib.sha256(block_hash).digest()),
        )
        if signers is None:
            signers = list(range(len(self.validators)))
        sigs = []
        commit = Commit(height=height, round=round, block_id=block_id, signatures=[])
        for i, v in enumerate(self.validators):
            if i in signers:
                sig = CommitSig(
                    block_id_flag=2,
                    validator_address=v.address,
                    timestamp=(header.time_seconds + 1, 500000000 + i),
                    signature=None,
                )
                msg = canonical_vote_sign_bytes(
                    Commit(
                        height=height,
                        round=round,
                        block_id=block_id,
                        signatures=[],
                    ),
                    sig,
                    self.chain_id,
                )
                sig.signature = v.key.sign(msg)
                sigs.append(sig)
            else:
                sigs.append(
                    CommitSig(
                        block_id_flag=1,
                        validator_address=b"",
                        timestamp=(0, 0),
                        signature=None,
                    )
                )
        commit.signatures = sigs
        self.commits[height] = commit

    def extend(self, round: int = 0, signers: list[int] | None = None) -> int:
        """Append one block; returns its height."""
        h = max(self.headers) + 1
        self._make_block(h, self.headers[h - 1].hash(), round, signers)
        return h

    # -- RPC-fixture-shaped output -------------------------------------------

    def header_rpc(self, height: int) -> dict:
        h = self.headers[height]
        return {
            "version": {"block": str(h.version_block), "app": str(h.version_app)},
            "chain_id": h.chain_id,
            "height": str(h.height),
            "time": _rfc3339(h.time_seconds, h.time_nanos),
            "last_block_id": {
                "hash": h.last_block_id.hash.hex().upper() if h.last_block_id else "",
                "parts": {
                    "total": h.last_block_id.parts.total if h.last_block_id else 0,
                    "hash": h.last_block_id.parts.hash.hex().upper()
                    if h.last_block_id
                    else "",
                },
            },
            "last_commit_hash": h.last_commit_hash.hex().upper(),
            "data_hash": h.data_hash.hex().upper(),
            "validators_hash": h.validators_hash.hex().upper(),
            "next_validators_hash": h.next_validators_hash.hex().upper(),
            "consensus_hash": h.consensus_hash.hex().upper(),
            "app_hash": h.app_hash.hex().upper(),
            "last_results_hash": h.last_results_hash.hex().upper(),
            "evidence_hash": h.evidence_hash.hex().upper(),
            "proposer_address": h.proposer_address.hex().upper(),
        }

    def commit_rpc(self, height: int) -> dict:
        c = self.commits[height]
        return {
            "jsonrpc": "2.0",
            "id": -1,
            "result": {
                "signed_header": {
                    "header": self.header_rpc(height),
                    "commit": {
                        "height": str(c.height),
                        "round": c.round,
                        "block_id": {
                            "hash": c.block_id.hash.hex().upper(),
                            "parts": {
                                "total": c.block_id.parts.total,
                                "hash": c.block_id.parts.hash.hex().upper(),
                            },
                        },
                        "signatures": [
                            {
                                "block_id_flag": s.block_id_flag,
                                "validator_address": s.validator_address.hex().upper(),
                                "timestamp": _rfc3339(*s.timestamp)
                                if s.block_id_flag == 2
                                else "0001-01-01T00:00:00Z",
                                "signature": base64.b64encode(s.signature).decode()
                                if s.signature
                                else None,
                            }
                            for s in c.signatures
                        ],
                    },
                },
                "canonical": True,
            },
        }

    def validators_rpc(self, height: int) -> dict:
        return {
            "jsonrpc": "2.0",
            "id": -1,
            "result": {
                "block_height": str(height),
                "validators": [
                    {
                        "address": v.address.hex().upper(),
                        "pub_key": {
                            "type": "tendermint/PubKeyEd25519",
                            "value": base64.b64encode(v.pubkey).decode(),
                        },
                        "voting_power": str(v.voting_power),
                        "proposer_priority": "0",
                    }
                    for v in self.val_set
                ],
                "count": str(len(self.val_set)),
                "total": str(len(self.val_set)),
            },
        }

    def write_fixtures(self, path: str):
        """Materialize recorded-RPC-shaped fixtures for the fetcher."""
        for h in self.headers:
            d = os.path.join(path, str(h))
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "commit.json"), "w") as f:
                json.dump(self.commit_rpc(h), f)
            with open(os.path.join(d, "validators_1.json"), "w") as f:
                json.dump(self.validators_rpc(h), f)
