"""The validator-leaf STARK: a proof of a step/skip run's leaf hashing.

Counterpart of ``tendermintx_tpu/circuits/proving.py``: the SHA-256 of
every validator leaf of one circuit run is proven as one Sha256Air
single-statement STARK whose public inputs bind (leaf bytes -> digest) per
lane. ``verify_leaf_bundle`` checks the proof and that its bound messages
are exactly the run's marshaled validator leaves. The wire form is the
reference's v3 dict, so either package verifies the other's bundle.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..inputs.conversion import ValidatorData
from ..inputs.tendermint import Validator
from ..stark.prover import StarkConfig, StarkProof, prove
from ..stark.serialize import stark_proof_from_dict, stark_proof_to_dict
from ..stark.sha256_air import (
    PUB_PER_SEGMENT as PPS,
    Sha256Air,
    digest_words_to_bytes,
    pad_single_block,
    sha256_batch_trace,
)
from ..stark.verifier import verify


def _default_config() -> StarkConfig:
    return StarkConfig(rate_bits=2, n_queries=28, final_poly_len=8)


def _leaf_bytes(lane: ValidatorData) -> bytes:
    enc = Validator(address=b"", pubkey=lane.pubkey, voting_power=lane.voting_power).simple_encode()
    return b"\x00" + enc


@dataclass
class LeafProofBundle:
    """SHA-256 STARK over all validator-leaf hashes of one circuit run."""

    proof: StarkProof
    n_lanes: int

    def to_dict(self) -> dict:
        return {
            "kind": "validator-leaf-sha256",
            "n_lanes": self.n_lanes,
            "proof": stark_proof_to_dict(self.proof),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LeafProofBundle":
        if d["kind"] != "validator-leaf-sha256":
            raise ValueError(f"not a validator-leaf bundle: {d['kind']!r}")
        return cls(proof=stark_proof_from_dict(d["proof"]), n_lanes=d["n_lanes"])

    def digests(self) -> list[bytes]:
        """The proven leaf digests, one per lane (from the public inputs)."""
        pub = self.proof.public_inputs
        return [
            digest_words_to_bytes([int(v) for v in pub[PPS * s + 16 : PPS * s + 24]])
            for s in range(self.n_lanes)
        ]


def prove_validator_leaves(
    lanes: list[ValidatorData],
    config: StarkConfig | None = None,
    *,
    device,
) -> LeafProofBundle:
    """Prove SHA-256(0x00 ‖ SimpleValidator(lane)) for every lane (enabled
    and padding alike) on `device`."""
    config = config or _default_config()
    blocks = [pad_single_block(_leaf_bytes(l)) for l in lanes]
    trace, publics = sha256_batch_trace(blocks, device=device)
    proof = prove(Sha256Air(len(lanes)), trace, publics, config)
    return LeafProofBundle(proof=proof, n_lanes=len(lanes))


def verify_leaf_bundle(
    bundle: LeafProofBundle,
    lanes: list[ValidatorData],
    config: StarkConfig | None = None,
) -> bool:
    """STARK-verify the bundle (on the host) and check that its bound
    messages are exactly the run's validator leaves."""
    config = config or _default_config()
    if bundle.n_lanes != len(lanes):
        return False
    air = Sha256Air(bundle.n_lanes)
    if len(bundle.proof.public_inputs) != air.n_public:
        return False
    if not verify(air, bundle.proof, config):
        return False
    # the proof's message words are the lanes' leaf bytes, and every
    # segment starts fresh (single-block leaves never chain)
    pub = bundle.proof.public_inputs
    for s, lane in enumerate(lanes):
        block = pad_single_block(_leaf_bytes(lane))
        words = [int.from_bytes(block[4 * i : 4 * i + 4], "big") for i in range(16)]
        if [int(v) for v in pub[PPS * s : PPS * s + 16]] != words:
            return False
        if int(pub[PPS * s + 24]) != 0:
            return False
    return True
