"""A composite proof as its wire form carries it (JSON, version 5), read
without the port's code: the byte blobs of the hash statement and the
signer lanes, and the shape of each batch's FRI.

Layout, as the port writes it:

- ``hash_data``, ``hash_aunts``, ``signers``: base64 of blobs, each a
  2-byte little-endian length and its bytes; a signer blob is the lane's
  validator index (2 bytes, little-endian), its signature (64) and the
  message it signs;
- a batch: ``statements`` and ``fri``; felt lists are base64 of 8-byte
  big-endian words, extension values two words each, a cap or a path
  4-word digests; a statement has ``n_rows``, ``trace_cap``,
  ``quotient_cap``, ``aux_cap`` (or null), ``ood_trace``, ``ood_quotient``
  and ``openings`` ([index, trace row, path, aux row, path, quotient row,
  path], one an opened index); ``fri`` has ``layer_caps``, ``final_poly``,
  ``pow_nonce`` and ``query_rounds`` (one a query, one entry a layer);
- a wrapped batch (``"wrapped": true``) keeps the statements without
  openings and the FRI without query rounds, and carries ``wrapper``, the
  batch of the recursion proof that stands in for them.
"""

from __future__ import annotations

import base64

DIGEST = 4


def blobs(s: str) -> list[bytes]:
    raw = base64.b64decode(s, validate=True)
    out, i = [], 0
    while i < len(raw):
        n = int.from_bytes(raw[i:i + 2], "little")
        if i + 2 + n > len(raw):
            raise ValueError("truncated blob")
        out.append(raw[i + 2:i + 2 + n])
        i += 2 + n
    return out


def signers(proof: dict) -> list[tuple[int, bytes, bytes]]:
    """(validator index, signature, message) of every signer lane."""
    out = []
    for b in blobs(proof["signers"]):
        if len(b) < 67:
            raise ValueError("truncated signer lane")
        out.append((int.from_bytes(b[:2], "little"), b[2:66], b[66:]))
    return out


def words(s: str | None) -> int:
    """The number of 8-byte words in a packed felt list."""
    if s is None:
        return 0
    n = len(base64.b64decode(s, validate=True))
    if n % 8:
        raise ValueError("packed felts not whole words")
    return n // 8


def is_wrapped(proof: dict) -> bool:
    return bool(proof["batch"].get("wrapped"))


def statement_widths(st: dict) -> tuple[int, int, int]:
    """(trace, auxiliary, quotient) columns of a statement's committed
    matrices: from an opening's rows where the statement carries openings;
    otherwise the trace and auxiliary columns as their sum (0 for the
    auxiliary), from the values at the out-of-domain point, and the
    quotient's 2 columns an extension value."""
    quotient = words(st["ood_quotient"])  # 2 words an extension value: 2 columns each
    if st["openings"]:
        o = st["openings"][0]
        return words(o[1]), words(o[3]), words(o[5])
    return words(st["ood_trace"][0]) // 2, 0, quotient


def fri_layers(sizes: list[int], cfg: dict) -> list[int]:
    """The codeword sizes a batch FRI over codewords of `sizes` commits, by
    the configuration: it folds by two until the codeword is no longer
    than the final polynomial's at the rate and no longer than the
    smallest codeword."""
    stop = cfg["final_poly_len"] << cfg["rate_bits"]
    out, n = [], max(sizes)
    while not (n <= stop and n <= min(sizes)):
        out.append(n)
        n //= 2
    return out


def _caps_wrong(caps: list, cfg: dict) -> bool:
    return any(words(c) != (DIGEST << cfg["cap_bits"]) for c in caps)


def _batch_wrong(statements: list[dict], fri: dict, cfg: dict, queried: bool) -> bool:
    """Whether a batch's FRI has another shape than `cfg` states; `queried`:
    whether it carries its queries (not where a wrap stands in for them)."""
    sizes = [int(st["n_rows"]) << cfg["rate_bits"] for st in statements]
    layers = len(fri_layers(sizes, cfg))
    caps = [st["trace_cap"] for st in statements] + [st["quotient_cap"] for st in statements]
    caps += [st["aux_cap"] for st in statements if st.get("aux_cap") is not None]
    if (_caps_wrong(caps + list(fri["layer_caps"]), cfg) or len(fri["layer_caps"]) != layers
            or words(fri["final_poly"]) != 2 * cfg["final_poly_len"]):
        return True
    if not queried:
        return any(st["openings"] for st in statements) or bool(fri.get("query_rounds"))
    if len(fri["query_rounds"]) != cfg["n_queries"] or any(len(q) != layers for q in fri["query_rounds"]):
        return True
    for st, size in zip(statements, sizes):
        idx = [int(o[0]) for o in st["openings"]]
        if not 1 <= len(idx) <= cfg["n_queries"] or not all(0 <= i < size for i in idx):
            return True
    return False


def fri_shape_wrong(proof: dict, base: dict, wrap: dict) -> bool:
    """Whether the proof's FRI, composite and wrap batch, opens another
    number of queries, folds another number of layers, ends in another
    final polynomial or commits to caps of another size than the
    configuration's `base` and `wrap` STARK configs state."""
    b = proof["batch"]
    if not is_wrapped(proof):
        return _batch_wrong(b["statements"], b["fri"], base, queried=True)
    inner = {"layer_caps": b["layer_caps"], "final_poly": b["final_poly"]}
    w = b["wrapper"]
    return (_batch_wrong(b["statements"], inner, base, queried=False)
            or _batch_wrong(w["statements"], w["fri"], wrap, queried=True))
