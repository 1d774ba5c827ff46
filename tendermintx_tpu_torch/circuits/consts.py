"""Size bounds and Merkle indices for Tendermint header circuits.

Mirrors the reference's circuits/consts.rs (values at :4-:37) — these are
protocol constants, not tunables.
"""

HASH_SIZE = 32

# Maximum number of validators a deployment supports (Celestia uses 100; we
# default to 128 = a power of two that tiles TPU lanes).
VALIDATOR_SET_SIZE_MAX = 128

# Protobuf-encoded sizes (reference consts.rs:9-29).
PROTOBUF_CHAIN_ID_SIZE_BYTES = 52
PROTOBUF_HASH_SIZE_BYTES = 34
PROTOBUF_BLOCK_ID_SIZE_BYTES = 72
HEADER_PROOF_DEPTH = 4
VALIDATOR_BYTE_LENGTH_MAX = 46
VARINT_BYTES_LENGTH_MAX = 9
VALIDATOR_MESSAGE_BYTES_LENGTH_MAX = 124

# Header leaf indices in the 14-field CometBFT header Merkle tree
# (reference consts.rs:32-37).
CHAIN_ID_INDEX = 1
BLOCK_HEIGHT_INDEX = 2
LAST_BLOCK_ID_INDEX = 4
DATA_HASH_INDEX = 6
VALIDATORS_HASH_INDEX = 7
NEXT_VALIDATORS_HASH_INDEX = 8
