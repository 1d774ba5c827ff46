"""Skip statement IO encoding.

The public input is abi.encodePacked(uint64 trusted_block, bytes32
trusted_header_hash, uint64 target_block), as in
``tendermintx_tpu/circuits/skip.py``; the output is the bytes32 target
header hash.
"""

from __future__ import annotations


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
