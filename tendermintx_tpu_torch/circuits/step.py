"""Step circuit: prove the next header given a trusted header.

Counterpart of ``tendermintx_tpu/circuits/step.py``. The public input is
abi.encodePacked(uint64 prev_block, bytes32 prev_header_hash); the output
is the bytes32 next header hash. ``StepCircuit.run`` fetches the inputs
and runs the witness program (circuits/verify.py) on its device.
"""

from __future__ import annotations

import torch

from ..inputs.fetcher import InputDataFetcher
from .config import TendermintConfig
from .variables import pack_step_witness
from .verify import chain_id_leaf_const, step_verify


def encode_step_input(prev_block: int, prev_header_hash: bytes) -> bytes:
    if len(prev_header_hash) != 32:
        raise ValueError("prev header hash must be 32 bytes")
    return prev_block.to_bytes(8, "big") + prev_header_hash


def decode_step_input(data: bytes) -> tuple[int, bytes]:
    if len(data) != 40:
        raise ValueError(f"step input must be 40 bytes, got {len(data)}")
    return int.from_bytes(data[:8], "big"), data[8:40]


class StepCircuit:
    """One step proof: (prev_block, prev_header_hash) -> next_header, run
    on `device`."""

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
        prev_block, prev_hash = decode_step_input(input_bytes)
        return self.fetcher.get_step_inputs(prev_block, prev_hash, self.max_validators)

    def run(self, input_bytes: bytes) -> bytes:
        """Witness-mode execution: fetch the inputs, run the verification
        program on the device, return the public output. Raises ValueError
        on an invalid witness."""
        return self._run(input_bytes, self._inputs(input_bytes))

    def _run(self, input_bytes: bytes, inputs) -> bytes:
        prev_block, prev_hash = decode_step_input(input_bytes)
        valid, next_header = step_verify(
            pack_step_witness(inputs).to(self.device),
            torch.frombuffer(bytearray(prev_hash), dtype=torch.uint8),
            prev_block & 0xFFFFFFFF,
            prev_block >> 32,
            self._cid_leaf,
            self._cid_len,
        )
        if not bool(valid):
            raise ValueError(f"step verification failed for block {prev_block + 1}")
        return bytes(next_header.cpu().numpy())

    def run_with_proof(self, input_bytes: bytes, stark_config=None):
        """run() plus a STARK proof of the validator-leaf hashing on the
        same device. Returns (output_bytes, LeafProofBundle)."""
        from .proving import prove_validator_leaves

        inputs = self._inputs(input_bytes)
        out = self._run(input_bytes, inputs)
        bundle = prove_validator_leaves(inputs.next_block_validators, stark_config, device=self.device)
        return out, bundle
