"""trace_build_s: seconds an update spends building its statements' traces
(the circuits layer): the SHA-256 hash plan (``circuits/hashing.py``'s
``skip_hash_statement`` / ``step_hash_statement``), the Ed25519 statement
and the SHA-512 challenge table (``circuits/composite.py``'s
``_ed_statement``, ``_sha512_statement``). The spans sit where
``circuits/composite.py`` calls them, in its own namespace, and close after
the card has finished their work."""

SPANS = {
    "trace_build": [
        "tendermintx_tpu_torch.circuits.composite:skip_hash_statement",
        "tendermintx_tpu_torch.circuits.composite:step_hash_statement",
        "tendermintx_tpu_torch.circuits.composite:_ed_statement",
        "tendermintx_tpu_torch.circuits.composite:_sha512_statement",
    ],
}


def read(run):
    return run.per_update("trace_build")
