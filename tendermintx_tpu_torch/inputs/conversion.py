"""Witness-value conversion: RPC/fixture data -> circuit input values.

Equivalent of the reference's circuits/input/conversion.rs: sign-bytes
reconstruction + native pre-verification (:22-56), the three validator
classes — signed / in-set-but-absent / padding — (:59-137), and the trusted
validator hash fields (:139-178).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)

from ..circuits.consts import (
    VALIDATOR_BYTE_LENGTH_MAX,
    VALIDATOR_MESSAGE_BYTES_LENGTH_MAX,
)
from .tendermint import Commit, CommitSig, Validator, canonical_vote_sign_bytes

# Deterministic dummy keypair/signature for disabled signature lanes: every
# lane of the batched Ed25519 verification processes *some* valid signature;
# lanes with signed=false use this dummy triple (reference semantics:
# conversion.rs:3-5,99-133 with plonky2x's DUMMY_PUBLIC_KEY/DUMMY_SIGNATURE).
_DUMMY_SEED = hashlib.sha256(b"tendermintx-tpu dummy signer v1").digest()
_DUMMY_PRIVATE = Ed25519PrivateKey.from_private_bytes(_DUMMY_SEED)
DUMMY_PUBLIC_KEY = _DUMMY_PRIVATE.public_key().public_bytes_raw()
DUMMY_MESSAGE = bytes(VALIDATOR_MESSAGE_BYTES_LENGTH_MAX)
DUMMY_SIGNATURE = _DUMMY_PRIVATE.sign(DUMMY_MESSAGE)


@dataclass
class ValidatorData:
    """One lane of the batched verification (reference variables.rs:69-79)."""

    pubkey: bytes  # 32 bytes (real, or DUMMY for padding lanes)
    signature: bytes  # 64 bytes
    message: bytes  # padded to VALIDATOR_MESSAGE_BYTES_LENGTH_MAX
    message_byte_length: int
    voting_power: int
    validator_byte_length: int  # length of the SimpleValidator encoding
    signed: bool
    enabled: bool  # part of the real validator set (not padding)


@dataclass
class ValidatorHashField:
    """Trusted-set lane: enough to recompute the validators hash
    (reference variables.rs:82-88)."""

    pubkey: bytes
    voting_power: int
    validator_byte_length: int
    enabled: bool


def _pad_message(msg: bytes) -> bytes:
    assert len(msg) <= VALIDATOR_MESSAGE_BYTES_LENGTH_MAX, len(msg)
    return msg + bytes(VALIDATOR_MESSAGE_BYTES_LENGTH_MAX - len(msg))


def get_validator_data_from_block(
    validators: list[Validator],
    commit: Commit,
    chain_id: str,
    max_validators: int,
) -> list[ValidatorData]:
    """Build the full padded lane array for a block's commit."""
    assert len(validators) <= max_validators, (
        f"validator set size {len(validators)} exceeds circuit capacity "
        f"{max_validators}; rebuild with a larger VALIDATOR_SET_SIZE_MAX"
    )
    assert len(validators) == len(commit.signatures), (
        f"{len(validators)} validators but {len(commit.signatures)} commit sigs"
    )
    out = []
    for v, sig in zip(validators, commit.signatures):
        enc_len = len(v.simple_encode())
        assert enc_len <= VALIDATOR_BYTE_LENGTH_MAX
        if sig.block_id_flag == 2 and sig.signature is not None:
            msg = canonical_vote_sign_bytes(commit, sig, chain_id)
            # native pre-verification: bad RPC data must fail here, not in
            # the prover (reference conversion.rs:33-49)
            Ed25519PublicKey.from_public_bytes(v.pubkey).verify(sig.signature, msg)
            out.append(
                ValidatorData(
                    pubkey=v.pubkey,
                    signature=sig.signature,
                    message=_pad_message(msg),
                    message_byte_length=len(msg),
                    voting_power=v.voting_power,
                    validator_byte_length=enc_len,
                    signed=True,
                    enabled=True,
                )
            )
        else:
            # in the set but did not sign (absent or nil vote)
            out.append(
                ValidatorData(
                    pubkey=v.pubkey,
                    signature=DUMMY_SIGNATURE,
                    message=DUMMY_MESSAGE,
                    message_byte_length=VALIDATOR_MESSAGE_BYTES_LENGTH_MAX,
                    voting_power=v.voting_power,
                    validator_byte_length=enc_len,
                    signed=False,
                    enabled=True,
                )
            )
    # padding lanes beyond the real set: dummy pubkey, zero power, excluded
    # from the validators-hash computation
    for _ in range(max_validators - len(validators)):
        out.append(
            ValidatorData(
                pubkey=DUMMY_PUBLIC_KEY,
                signature=DUMMY_SIGNATURE,
                message=DUMMY_MESSAGE,
                message_byte_length=VALIDATOR_MESSAGE_BYTES_LENGTH_MAX,
                voting_power=0,
                validator_byte_length=36,  # encoding length of a zero-power dummy
                signed=False,
                enabled=False,
            )
        )
    return out


def signature_lanes(lanes: list[ValidatorData]):
    """(pubkeys, messages, signatures) for the batched conditional Ed25519
    verify: lanes with signed=False substitute the dummy triple so every lane
    verifies (the reference's `curta_eddsa_verify_sigs_conditional`
    semantics — verify.rs:248-259). The real pubkey stays in the lane for
    validator-set hashing."""
    pks, msgs, sigs = [], [], []
    for l in lanes:
        if l.signed:
            pks.append(l.pubkey)
            msgs.append(l.message[: l.message_byte_length])
            sigs.append(l.signature)
        else:
            pks.append(DUMMY_PUBLIC_KEY)
            msgs.append(DUMMY_MESSAGE)
            sigs.append(DUMMY_SIGNATURE)
    return pks, msgs, sigs


def validator_hash_field_from_block(
    validators: list[Validator], max_validators: int
) -> list[ValidatorHashField]:
    assert len(validators) <= max_validators, (
        f"validator set size {len(validators)} exceeds circuit capacity "
        f"{max_validators}"
    )
    out = [
        ValidatorHashField(
            pubkey=v.pubkey,
            voting_power=v.voting_power,
            validator_byte_length=len(v.simple_encode()),
            enabled=True,
        )
        for v in validators
    ]
    for _ in range(max_validators - len(validators)):
        out.append(
            ValidatorHashField(
                pubkey=DUMMY_PUBLIC_KEY,
                voting_power=0,
                validator_byte_length=36,
                enabled=False,
            )
        )
    return out
