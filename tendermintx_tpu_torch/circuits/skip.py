"""Skip circuit: prove a distant header given a trusted header.

Counterpart of ``tendermintx_tpu/circuits/skip.py``. The public input is
abi.encodePacked(uint64 trusted_block, bytes32 trusted_header_hash,
uint64 target_block); the output is the bytes32 target header hash.
``SkipCircuit.run`` fetches the inputs and runs the witness program
(circuits/verify.py) on its device.
"""

from __future__ import annotations

import torch

from ..inputs.fetcher import InputDataFetcher
from .config import TendermintConfig
from .variables import pack_skip_witness
from .verify import chain_id_leaf_const, skip_verify


def encode_skip_input(
    trusted_block: int, trusted_header_hash: bytes, target_block: int
) -> bytes:
    if len(trusted_header_hash) != 32:
        raise ValueError("trusted header hash must be 32 bytes")
    return (
        trusted_block.to_bytes(8, "big")
        + trusted_header_hash
        + target_block.to_bytes(8, "big")
    )


def decode_skip_input(data: bytes) -> tuple[int, bytes, int]:
    if len(data) != 48:
        raise ValueError(f"skip input must be 48 bytes, got {len(data)}")
    return (
        int.from_bytes(data[:8], "big"),
        data[8:40],
        int.from_bytes(data[40:48], "big"),
    )


class SkipCircuit:
    """One skip proof: (trusted_block, trusted_header, target_block) ->
    target_header, run on `device`."""

    def __init__(
        self,
        max_validators: int,
        config: TendermintConfig,
        fetcher: InputDataFetcher | None = None,
        *,
        device,
    ):
        self.max_validators = max_validators
        self.config = config
        self.fetcher = fetcher or InputDataFetcher()
        self.device = torch.device(device)
        self._cid_leaf, self._cid_len = chain_id_leaf_const(config.chain_id)

    def _inputs(self, input_bytes: bytes):
        trusted_block, trusted_hash, target_block = decode_skip_input(input_bytes)
        return self.fetcher.get_skip_inputs(
            trusted_block, trusted_hash, target_block, self.max_validators
        )

    def run(self, input_bytes: bytes) -> bytes:
        """Witness-mode execution on the device; raises ValueError on an
        invalid witness."""
        return self._run(input_bytes, self._inputs(input_bytes))

    def _run(self, input_bytes: bytes, inputs) -> bytes:
        trusted_block, trusted_hash, target_block = decode_skip_input(input_bytes)
        valid, target_header = skip_verify(
            pack_skip_witness(inputs).to(self.device),
            torch.frombuffer(bytearray(trusted_hash), dtype=torch.uint8),
            trusted_block & 0xFFFFFFFF,
            trusted_block >> 32,
            target_block & 0xFFFFFFFF,
            target_block >> 32,
            self._cid_leaf,
            self._cid_len,
            skip_max=self.config.skip_max,
        )
        if not bool(valid):
            raise ValueError(f"skip verification failed for {trusted_block} -> {target_block}")
        return bytes(target_header.cpu().numpy())

    def run_with_proof(self, input_bytes: bytes, stark_config=None):
        """run() plus a STARK proof of the target validator-leaf hashing on
        the same device. Returns (output_bytes, LeafProofBundle)."""
        from .proving import prove_validator_leaves

        inputs = self._inputs(input_bytes)
        out = self._run(input_bytes, inputs)
        bundle = prove_validator_leaves(inputs.target_block_validators, stark_config, device=self.device)
        return out, bundle
