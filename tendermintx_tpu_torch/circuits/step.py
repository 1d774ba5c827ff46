"""Step statement IO encoding.

The public input is abi.encodePacked(uint64 prev_block, bytes32
prev_header_hash), as in ``tendermintx_tpu/circuits/step.py``; the output
is the bytes32 next header hash.
"""

from __future__ import annotations


def encode_step_input(prev_block: int, prev_header_hash: bytes) -> bytes:
    if len(prev_header_hash) != 32:
        raise ValueError("prev header hash must be 32 bytes")
    return prev_block.to_bytes(8, "big") + prev_header_hash


def decode_step_input(data: bytes) -> tuple[int, bytes]:
    if len(data) != 40:
        raise ValueError(f"step input must be 40 bytes, got {len(data)}")
    return int.from_bytes(data[:8], "big"), data[8:40]
