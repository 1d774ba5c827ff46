"""Input fetcher: assembles step/skip witness inputs from RPC or fixtures.

Equivalent of the reference's circuits/input/mod.rs: `InputDataMode` (:31-35),
`InputDataFetcher` (:37-43), RPC retry/failover (:122-143),
`find_block_to_request` bisection (:160-186), fixture read/record
(:188-282), proof caching (:284-301), `get_step_inputs` (:316-423) and
`get_skip_inputs` (:425-523).

Fixture layout matches recorded CometBFT RPC JSON:
    <fixture_path>/<height>/commit.json        (/commit?height=H response)
    <fixture_path>/<height>/validators_1.json  (/validators?height=H&page=N)
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.request
from dataclasses import dataclass, field
from enum import Enum

from ..circuits.consts import (
    BLOCK_HEIGHT_INDEX,
    CHAIN_ID_INDEX,
    LAST_BLOCK_ID_INDEX,
    NEXT_VALIDATORS_HASH_INDEX,
    VALIDATORS_HASH_INDEX,
)
from .conversion import (
    ValidatorData,
    ValidatorHashField,
    get_validator_data_from_block,
    validator_hash_field_from_block,
)
from .tendermint import (
    Commit,
    Header,
    MerkleProof,
    Validator,
    is_valid_skip,
    proofs_from_byte_slices,
)

log = logging.getLogger(__name__)


class InputDataMode(Enum):
    RPC = "rpc"
    FIXTURE = "fixture"


@dataclass
class SignedHeader:
    header: Header
    header_rpc: dict  # raw RPC header dict (for re-encoding)
    commit: Commit


@dataclass
class StepInputs:
    """Everything the step circuit's witness needs
    (reference input/mod.rs:45-58)."""

    next_header: bytes
    round: int
    next_block_validators: list[ValidatorData]
    nb_validators: int
    next_header_chain_id_proof: MerkleProof
    next_header_chain_id_leaf: bytes
    next_header_height_proof: MerkleProof
    next_header_height_leaf: bytes
    next_header_validators_hash_proof: MerkleProof
    next_header_validators_hash_leaf: bytes
    next_header_last_block_id_proof: MerkleProof
    next_header_last_block_id_leaf: bytes
    prev_header_next_validators_hash_proof: MerkleProof
    prev_header_next_validators_hash_leaf: bytes


@dataclass
class SkipInputs:
    """Everything the skip circuit's witness needs
    (reference input/mod.rs:60-74)."""

    target_header: bytes
    target_round: int
    target_block_validators: list[ValidatorData]
    nb_target_validators: int
    target_header_chain_id_proof: MerkleProof
    target_header_chain_id_leaf: bytes
    target_header_height_proof: MerkleProof
    target_header_height_leaf: bytes
    target_header_validators_hash_proof: MerkleProof
    target_header_validators_hash_leaf: bytes
    trusted_header_validators_hash_fields: list[ValidatorHashField]
    nb_trusted_validators: int
    trusted_header_validators_hash_proof: MerkleProof
    trusted_header_validators_hash_leaf: bytes


class InputDataFetcher:
    def __init__(
        self,
        urls: list[str] | None = None,
        fixture_path: str | None = None,
        mode: InputDataMode | None = None,
        max_retries: int = 2,
    ):
        env_urls = os.environ.get("TENDERMINT_RPC_URL", "")
        self.urls = urls or [u for u in env_urls.split(",") if u]
        self.fixture_path = fixture_path or os.environ.get(
            "TENDERMINTX_FIXTURE_PATH", ""
        )
        if mode is None:
            mode = InputDataMode.RPC if self.urls else InputDataMode.FIXTURE
        self.mode = mode
        self.max_retries = max_retries
        self.save = False  # record RPC responses as fixtures
        self._proof_cache: dict[bytes, tuple[bytes, list]] = {}

    # -- transport -----------------------------------------------------------

    def _request(self, route: str, fixture_name: str, height: int) -> dict:
        if self.mode == InputDataMode.FIXTURE:
            path = os.path.join(self.fixture_path, str(height), fixture_name)
            with open(path) as f:
                return json.load(f)
        last_err = None
        for attempt in range(self.max_retries):
            for url in self.urls:
                try:
                    with urllib.request.urlopen(url + route, timeout=20) as r:
                        data = json.loads(r.read())
                    if self.save:
                        d = os.path.join(self.fixture_path, str(height))
                        os.makedirs(d, exist_ok=True)
                        with open(os.path.join(d, fixture_name), "w") as f:
                            json.dump(data, f)
                    return data
                except Exception as e:  # noqa: BLE001 - retry any transport error
                    last_err = e
                    log.warning("RPC %s failed on %s: %s", route, url, e)
            time.sleep((attempt + 1) ** 2)  # quadratic backoff
        raise RuntimeError(f"all RPC endpoints failed for {route}: {last_err}")

    # -- basic queries -------------------------------------------------------

    def get_signed_header_from_number(self, height: int) -> SignedHeader:
        data = self._request(f"/commit?height={height}", "commit.json", height)
        sh = data["result"]["signed_header"]
        return SignedHeader(
            header=Header.from_rpc(sh["header"]),
            header_rpc=sh["header"],
            commit=Commit.from_rpc(sh["commit"]),
        )

    def get_latest_signed_header(self) -> SignedHeader:
        assert self.mode == InputDataMode.RPC, "latest header requires RPC"
        data = self._request("/commit", "commit_latest.json", 0)
        sh = data["result"]["signed_header"]
        return SignedHeader(
            header=Header.from_rpc(sh["header"]),
            header_rpc=sh["header"],
            commit=Commit.from_rpc(sh["commit"]),
        )

    def get_validator_set_from_number(self, height: int) -> list[Validator]:
        vals: list[Validator] = []
        page = 1
        while True:
            data = self._request(
                f"/validators?height={height}&per_page=100&page={page}",
                f"validators_{page}.json",
                height,
            )
            res = data["result"]
            vals.extend(Validator.from_rpc(v) for v in res["validators"])
            if len(vals) >= int(res["total"]):
                break
            page += 1
        return vals

    # -- proofs --------------------------------------------------------------

    def get_header_proof(self, signed: SignedHeader, index: int):
        """(leaf_bytes, MerkleProof) for a header field, cached per header."""
        key = signed.header.hash()
        if key not in self._proof_cache:
            leaves = signed.header.field_bytes()
            root, proofs = proofs_from_byte_slices(leaves)
            assert root == key
            self._proof_cache[key] = (leaves, proofs)
        leaves, proofs = self._proof_cache[key]
        return leaves[index], proofs[index]

    # -- skip search ---------------------------------------------------------

    def find_block_to_request(self, start_block: int, max_end_block: int) -> int:
        """Farthest block whose skip from start_block is valid (bisection;
        reference input/mod.rs:160-186)."""
        trusted_vals = self.get_validator_set_from_number(start_block)
        curr_end = max_end_block
        while curr_end > start_block + 1:
            target_vals = self.get_validator_set_from_number(curr_end)
            target_commit = self.get_signed_header_from_number(curr_end).commit
            if is_valid_skip(trusted_vals, target_vals, target_commit):
                return curr_end
            mid = (start_block + curr_end) // 2
            curr_end = mid if mid > start_block + 1 else start_block + 1
        return start_block + 1

    # -- input assembly ------------------------------------------------------

    def get_step_inputs(
        self,
        prev_block_number: int,
        prev_header_hash: bytes,
        max_validators: int,
    ) -> StepInputs:
        prev = self.get_signed_header_from_number(prev_block_number)
        assert prev.header.hash() == prev_header_hash, (
            f"fetched prev header hashes to {prev.header.hash().hex()} "
            f"but expected {prev_header_hash.hex()}"
        )
        nxt = self.get_signed_header_from_number(prev_block_number + 1)
        validators = self.get_validator_set_from_number(prev_block_number + 1)
        lanes = get_validator_data_from_block(
            validators, nxt.commit, nxt.header.chain_id, max_validators
        )
        cid_leaf, cid_proof = self.get_header_proof(nxt, CHAIN_ID_INDEX)
        h_leaf, h_proof = self.get_header_proof(nxt, BLOCK_HEIGHT_INDEX)
        vh_leaf, vh_proof = self.get_header_proof(nxt, VALIDATORS_HASH_INDEX)
        lbi_leaf, lbi_proof = self.get_header_proof(nxt, LAST_BLOCK_ID_INDEX)
        pnvh_leaf, pnvh_proof = self.get_header_proof(prev, NEXT_VALIDATORS_HASH_INDEX)
        return StepInputs(
            next_header=nxt.header.hash(),
            round=nxt.commit.round,
            next_block_validators=lanes,
            nb_validators=len(validators),
            next_header_chain_id_proof=cid_proof,
            next_header_chain_id_leaf=cid_leaf,
            next_header_height_proof=h_proof,
            next_header_height_leaf=h_leaf,
            next_header_validators_hash_proof=vh_proof,
            next_header_validators_hash_leaf=vh_leaf,
            next_header_last_block_id_proof=lbi_proof,
            next_header_last_block_id_leaf=lbi_leaf,
            prev_header_next_validators_hash_proof=pnvh_proof,
            prev_header_next_validators_hash_leaf=pnvh_leaf,
        )

    def get_skip_inputs(
        self,
        trusted_block_number: int,
        trusted_header_hash: bytes,
        target_block_number: int,
        max_validators: int,
    ) -> SkipInputs:
        trusted = self.get_signed_header_from_number(trusted_block_number)
        assert trusted.header.hash() == trusted_header_hash, (
            f"fetched trusted header hashes to {trusted.header.hash().hex()} "
            f"but expected {trusted_header_hash.hex()}"
        )
        target = self.get_signed_header_from_number(target_block_number)
        target_vals = self.get_validator_set_from_number(target_block_number)
        trusted_vals = self.get_validator_set_from_number(trusted_block_number)
        lanes = get_validator_data_from_block(
            target_vals, target.commit, target.header.chain_id, max_validators
        )
        trusted_fields = validator_hash_field_from_block(trusted_vals, max_validators)
        cid_leaf, cid_proof = self.get_header_proof(target, CHAIN_ID_INDEX)
        h_leaf, h_proof = self.get_header_proof(target, BLOCK_HEIGHT_INDEX)
        vh_leaf, vh_proof = self.get_header_proof(target, VALIDATORS_HASH_INDEX)
        # the 1/3-intersection check runs against the trusted header's OWN
        # validator set (reference verify.rs:361-437 uses VALIDATORS_HASH_INDEX
        # of the trusted header, input/mod.rs:432)
        tvh_leaf, tvh_proof = self.get_header_proof(trusted, VALIDATORS_HASH_INDEX)
        return SkipInputs(
            target_header=target.header.hash(),
            target_round=target.commit.round,
            target_block_validators=lanes,
            nb_target_validators=len(target_vals),
            target_header_chain_id_proof=cid_proof,
            target_header_chain_id_leaf=cid_leaf,
            target_header_height_proof=h_proof,
            target_header_height_leaf=h_leaf,
            target_header_validators_hash_proof=vh_proof,
            target_header_validators_hash_leaf=vh_leaf,
            trusted_header_validators_hash_fields=trusted_fields,
            nb_trusted_validators=len(trusted_vals),
            trusted_header_validators_hash_proof=tvh_proof,
            trusted_header_validators_hash_leaf=tvh_leaf,
        )
