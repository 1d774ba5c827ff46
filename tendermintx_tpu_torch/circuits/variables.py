"""Typed witness schema: dataclasses of tensors.

Counterpart of ``tendermintx_tpu/circuits/variables.py``: one dataclass per
witness struct of the upstream circuits, with ``pack_*`` constructors that
build it on the host from the fetched inputs. Byte arrays are uint8,
32-bit words (lengths, voting-power halves, path bits) int64, flags bool,
and the Ed25519 ladder inputs int64 limbs. ``.to(device)`` moves a whole
witness (nested dataclasses included) to the device its program runs on.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..inputs.conversion import ValidatorData, ValidatorHashField, signature_lanes
from ..inputs.fetcher import SkipInputs, StepInputs
from ..inputs.tendermint import MerkleProof, Validator, get_path_indices
from ..ops import ed25519
from .consts import (
    HEADER_PROOF_DEPTH,
    VALIDATOR_BYTE_LENGTH_MAX,
    VALIDATOR_MESSAGE_BYTES_LENGTH_MAX,
)


class _Tensors:
    """`.to(device)` for a dataclass whose fields are tensors or such
    dataclasses."""

    def to(self, device):
        return replace(self, **{f.name: getattr(self, f.name).to(device) for f in fields(self)})


def _u8(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.uint8).copy())


def _u32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.int64).copy())


def _split64(vals: list[int]):
    return _u32([v & 0xFFFFFFFF for v in vals]), _u32([v >> 32 for v in vals])


def _leaf_encoding(pubkey: bytes, voting_power: int) -> bytes:
    return Validator(address=b"", pubkey=pubkey, voting_power=voting_power).simple_encode()


@dataclass
class ValidatorLanes(_Tensors):
    """Batched validators with the precomputed Ed25519 ladder inputs."""

    pubkeys: torch.Tensor  # (B, 32) u8
    messages: torch.Tensor  # (B, 124) u8
    msg_len: torch.Tensor  # (B,)
    vp_lo: torch.Tensor  # (B,)
    vp_hi: torch.Tensor  # (B,)
    leaf_bytes: torch.Tensor  # (B, 47) u8: 0x00 ‖ SimpleValidator encoding
    leaf_len: torch.Tensor  # (B,)
    signed: torch.Tensor  # (B,) bool
    enabled: torch.Tensor  # (B,) bool
    # Ed25519 Straus inputs (conditional lanes already substituted); the
    # verification program re-derives or checks all of them from the raw
    # bytes below (ops/ed25519.bind_witness)
    table_x: torch.Tensor
    table_y: torch.Tensor
    table_t: torch.Tensor
    bits2: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor
    # the key each lane's signature verifies under: the validator's own
    # key for signed lanes (enforced on the device), the dummy key otherwise
    sig_r: torch.Tensor  # (B, 32) u8
    sig_s: torch.Tensor  # (B, 32) u8
    sig_pubkeys: torch.Tensor  # (B, 32) u8
    k_q: torch.Tensor  # (B, 20) mod-L quotient witness


def pack_validator_lanes(lanes: list[ValidatorData]) -> ValidatorLanes:
    B = len(lanes)
    pks, msgs, sigs = signature_lanes(lanes)
    table_x, table_y, table_t, bits2, rx, ry = ed25519.prepare_batch(pks, msgs, sigs)
    sig_r, sig_s, sig_pk, k_q = ed25519.prepare_binding(pks, msgs, sigs)
    leaf = np.zeros((B, 1 + VALIDATOR_BYTE_LENGTH_MAX), dtype=np.uint8)
    leaf_len = np.zeros((B,), dtype=np.int64)
    msg_arr = np.zeros((B, VALIDATOR_MESSAGE_BYTES_LENGTH_MAX), dtype=np.uint8)
    for i, l in enumerate(lanes):
        enc = _leaf_encoding(l.pubkey, l.voting_power)
        if len(enc) != l.validator_byte_length:
            raise ValueError(f"lane {i}: encoding length {len(enc)} != {l.validator_byte_length}")
        leaf[i, 1 : 1 + len(enc)] = np.frombuffer(enc, dtype=np.uint8)
        leaf_len[i] = 1 + len(enc)
        msg_arr[i] = np.frombuffer(l.message, dtype=np.uint8)
    vp_lo, vp_hi = _split64([l.voting_power for l in lanes])
    return ValidatorLanes(
        pubkeys=_u8(np.stack([np.frombuffer(l.pubkey, dtype=np.uint8) for l in lanes])),
        messages=_u8(msg_arr),
        msg_len=_u32([l.message_byte_length for l in lanes]),
        vp_lo=vp_lo,
        vp_hi=vp_hi,
        leaf_bytes=_u8(leaf),
        leaf_len=_u32(leaf_len),
        signed=torch.tensor([bool(l.signed) for l in lanes]),
        enabled=torch.tensor([bool(l.enabled) for l in lanes]),
        table_x=table_x,
        table_y=table_y,
        table_t=table_t,
        bits2=bits2,
        rx=rx,
        ry=ry,
        sig_r=sig_r,
        sig_s=sig_s,
        sig_pubkeys=sig_pk,
        k_q=k_q,
    )


@dataclass
class HashFieldLanes(_Tensors):
    """Batched validator hash fields (the trusted set of a skip)."""

    pubkeys: torch.Tensor  # (B, 32)
    vp_lo: torch.Tensor
    vp_hi: torch.Tensor
    leaf_bytes: torch.Tensor
    leaf_len: torch.Tensor
    enabled: torch.Tensor


def pack_hash_field_lanes(fields_: list[ValidatorHashField]) -> HashFieldLanes:
    B = len(fields_)
    leaf = np.zeros((B, 1 + VALIDATOR_BYTE_LENGTH_MAX), dtype=np.uint8)
    leaf_len = np.zeros((B,), dtype=np.int64)
    for i, l in enumerate(fields_):
        enc = _leaf_encoding(l.pubkey, l.voting_power)
        leaf[i, 1 : 1 + len(enc)] = np.frombuffer(enc, dtype=np.uint8)
        leaf_len[i] = 1 + len(enc)
    vp_lo, vp_hi = _split64([l.voting_power for l in fields_])
    return HashFieldLanes(
        pubkeys=_u8(np.stack([np.frombuffer(l.pubkey, dtype=np.uint8) for l in fields_])),
        vp_lo=vp_lo,
        vp_hi=vp_hi,
        leaf_bytes=_u8(leaf),
        leaf_len=_u32(leaf_len),
        enabled=torch.tensor([bool(l.enabled) for l in fields_]),
    )


@dataclass
class HeaderProof(_Tensors):
    """One header-field inclusion proof."""

    leaf_bytes: torch.Tensor  # (1, 73) u8 zero-padded
    leaf_len: torch.Tensor  # (1,)
    aunts: torch.Tensor  # (1, 4, 32) u8
    path_bits: torch.Tensor  # (1, 4)


HEADER_LEAF_WIDTH = 73  # 0x00 prefix + the largest header leaf (block id, 72 bytes)


def pack_header_proof(leaf: bytes, proof: MerkleProof) -> HeaderProof:
    if len(proof.aunts) != HEADER_PROOF_DEPTH:
        raise ValueError(f"header proof has {len(proof.aunts)} aunts, expected {HEADER_PROOF_DEPTH}")
    data = np.zeros((1, HEADER_LEAF_WIDTH), dtype=np.uint8)
    full = b"\x00" + leaf
    data[0, : len(full)] = np.frombuffer(full, dtype=np.uint8)
    bits = get_path_indices(proof.index, proof.total)
    return HeaderProof(
        leaf_bytes=_u8(data),
        leaf_len=_u32([len(full)]),
        aunts=_u8(np.stack([np.frombuffer(a, dtype=np.uint8) for a in proof.aunts])[None]),
        path_bits=_u32([[1 if b else 0 for b in bits]]),
    )


@dataclass
class StepWitness(_Tensors):
    """Everything the step program checks."""

    lanes: ValidatorLanes
    nb_validators: torch.Tensor  # ()
    round: torch.Tensor  # ()
    next_header: torch.Tensor  # (32,) u8
    chain_id_proof: HeaderProof
    height_proof: HeaderProof
    validators_hash_proof: HeaderProof
    last_block_id_proof: HeaderProof
    prev_nvh_proof: HeaderProof  # against the previous header


def pack_step_witness(inputs: StepInputs) -> StepWitness:
    return StepWitness(
        lanes=pack_validator_lanes(inputs.next_block_validators),
        nb_validators=_u32(inputs.nb_validators),
        round=_u32(inputs.round),
        next_header=_u8(np.frombuffer(inputs.next_header, dtype=np.uint8)),
        chain_id_proof=pack_header_proof(
            inputs.next_header_chain_id_leaf, inputs.next_header_chain_id_proof
        ),
        height_proof=pack_header_proof(
            inputs.next_header_height_leaf, inputs.next_header_height_proof
        ),
        validators_hash_proof=pack_header_proof(
            inputs.next_header_validators_hash_leaf,
            inputs.next_header_validators_hash_proof,
        ),
        last_block_id_proof=pack_header_proof(
            inputs.next_header_last_block_id_leaf,
            inputs.next_header_last_block_id_proof,
        ),
        prev_nvh_proof=pack_header_proof(
            inputs.prev_header_next_validators_hash_leaf,
            inputs.prev_header_next_validators_hash_proof,
        ),
    )


@dataclass
class SkipWitness(_Tensors):
    """Everything the skip program checks."""

    lanes: ValidatorLanes
    nb_target_validators: torch.Tensor
    target_round: torch.Tensor
    target_header: torch.Tensor
    chain_id_proof: HeaderProof
    height_proof: HeaderProof
    validators_hash_proof: HeaderProof
    trusted_lanes: HashFieldLanes
    nb_trusted_validators: torch.Tensor
    trusted_vh_proof: HeaderProof


def pack_skip_witness(inputs: SkipInputs) -> SkipWitness:
    return SkipWitness(
        lanes=pack_validator_lanes(inputs.target_block_validators),
        nb_target_validators=_u32(inputs.nb_target_validators),
        target_round=_u32(inputs.target_round),
        target_header=_u8(np.frombuffer(inputs.target_header, dtype=np.uint8)),
        chain_id_proof=pack_header_proof(
            inputs.target_header_chain_id_leaf, inputs.target_header_chain_id_proof
        ),
        height_proof=pack_header_proof(
            inputs.target_header_height_leaf, inputs.target_header_height_proof
        ),
        validators_hash_proof=pack_header_proof(
            inputs.target_header_validators_hash_leaf,
            inputs.target_header_validators_hash_proof,
        ),
        trusted_lanes=pack_hash_field_lanes(inputs.trusted_header_validators_hash_fields),
        nb_trusted_validators=_u32(inputs.nb_trusted_validators),
        trusted_vh_proof=pack_header_proof(
            inputs.trusted_header_validators_hash_leaf,
            inputs.trusted_header_validators_hash_proof,
        ),
    )
