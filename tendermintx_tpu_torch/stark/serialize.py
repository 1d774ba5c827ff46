"""Proof (de)serialization in the reference's wire formats.

Counterpart of ``tendermintx_tpu/stark/serialize.py``. Single-statement
proofs (v3) are JSON-compatible dicts with field elements as decimal
strings and digests as 4-element lists. Batch and wrapped proofs use the
packed encoding: every felt list is base64 of 8-byte big-endian words,
paths are the concatenation of their 4-felt digests, ext values
interleave (c0, c1). A dict written by either package reads back in the
other.
"""

from __future__ import annotations

import base64
import json

from ..ops.goldilocks import P
from .fri import FriProof
from .prover import StarkProof


def _felt(v) -> int:
    """Range-validated field element: malformed proofs fail here."""
    x = int(v)
    if not 0 <= x < P:
        raise ValueError(f"field element out of range: {x}")
    return x


def _ints(xs):
    return [str(int(v)) for v in xs]


def _unints(xs):
    return [_felt(v) for v in xs]


def _ext(v):
    return [str(int(v[0])), str(int(v[1]))]


def _unext(v):
    return (_felt(v[0]), _felt(v[1]))


def _cap(cap):
    return [_ints(d) for d in cap]


def _uncap(cap):
    out = [_unints(d) for d in cap]
    for d in out:
        if len(d) != 4:
            raise ValueError("bad digest length in cap")
    return out


def fri_proof_to_dict(p: FriProof) -> dict:
    return {
        "pow_nonce": str(int(p.pow_nonce)),
        "layer_caps": [_cap(c) for c in p.layer_caps],
        "final_poly": [_ext(c) for c in p.final_poly],
        "query_rounds": [
            [
                {
                    "val_i": _ext(vi),
                    "val_j": _ext(vj),
                    "path_i": [_ints(s) for s in pi],
                    "path_j": [_ints(s) for s in pj],
                }
                for (vi, vj, pi, pj) in per_layer
            ]
            for per_layer in p.query_rounds
        ],
    }


def fri_proof_from_dict(d: dict) -> FriProof:
    return FriProof(
        pow_nonce=_felt(d.get("pow_nonce", 0)),
        layer_caps=[_uncap(c) for c in d["layer_caps"]],
        final_poly=[_unext(c) for c in d["final_poly"]],
        query_rounds=[
            [
                (
                    _unext(q["val_i"]),
                    _unext(q["val_j"]),
                    [_unints(s) for s in q["path_i"]],
                    [_unints(s) for s in q["path_j"]],
                )
                for q in per_layer
            ]
            for per_layer in d["query_rounds"]
        ],
    )


def stark_proof_to_dict(p: StarkProof) -> dict:
    return {
        "version": 3,
        "n_rows": p.n_rows,
        "public_inputs": _ints(p.public_inputs),
        "trace_cap": _cap(p.trace_cap),
        "aux_cap": _cap(p.aux_cap) if p.aux_cap is not None else None,
        "quotient_cap": _cap(p.quotient_cap),
        "ood_trace": [[_ext(v) for v in per] for per in p.ood_trace],
        "ood_quotient": [_ext(v) for v in p.ood_quotient],
        "fri": fri_proof_to_dict(p.fri_proof),
        "openings": {
            str(idx): {
                "trace_row": _ints(trow),
                "trace_path": [_ints(s) for s in tpath],
                "aux_row": _ints(arow),
                "aux_path": [_ints(s) for s in apath],
                "quot_row": _ints(qrow),
                "quot_path": [_ints(s) for s in qpath],
            }
            for idx, (trow, tpath, arow, apath, qrow, qpath) in p.openings.items()
        },
    }


def stark_proof_from_dict(d: dict) -> StarkProof:
    aux_cap = d.get("aux_cap")
    return StarkProof(
        n_rows=int(d["n_rows"]),
        public_inputs=_unints(d["public_inputs"]),
        trace_cap=_uncap(d["trace_cap"]),
        quotient_cap=_uncap(d["quotient_cap"]),
        ood_trace=[[_unext(v) for v in per] for per in d["ood_trace"]],
        ood_quotient=[_unext(v) for v in d["ood_quotient"]],
        fri_proof=fri_proof_from_dict(d["fri"]),
        openings={
            int(k): (
                _unints(v["trace_row"]),
                [_unints(s) for s in v["trace_path"]],
                _unints(v.get("aux_row", [])),
                [_unints(s) for s in v.get("aux_path", [])],
                _unints(v["quot_row"]),
                [_unints(s) for s in v["quot_path"]],
            )
            for k, v in d["openings"].items()
        },
        aux_cap=_uncap(aux_cap) if aux_cap is not None else None,
    )


def proof_to_json(p: StarkProof) -> str:
    return json.dumps(stark_proof_to_dict(p))


def proof_from_json(s: str) -> StarkProof:
    return stark_proof_from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Compact packed encoding: batch and wrapped proofs
# ---------------------------------------------------------------------------


def _pack(xs) -> str:
    return base64.b64encode(b"".join(int(v).to_bytes(8, "big") for v in xs)).decode()


def _unpack(s: str, expect: int | None = None) -> list[int]:
    raw = base64.b64decode(str(s), validate=True)
    if len(raw) % 8:
        raise ValueError("packed felt blob not a multiple of 8 bytes")
    out = [int.from_bytes(raw[i : i + 8], "big") for i in range(0, len(raw), 8)]
    for x in out:
        if x >= P:
            raise ValueError(f"field element out of range: {x}")
    if expect is not None and len(out) != expect:
        raise ValueError(f"expected {expect} felts, got {len(out)}")
    return out


def _pack_path(path) -> str:
    return _pack([v for digest in path for v in digest])


def _unpack_path(s: str) -> list[list[int]]:
    flat = _unpack(s)
    if len(flat) % 4:
        raise ValueError("packed path not a multiple of 4 felts")
    return [flat[i : i + 4] for i in range(0, len(flat), 4)]


def _pack_exts(vals) -> str:
    return _pack([c for v in vals for c in (v[0], v[1])])


def _unpack_exts(s: str) -> list[tuple[int, int]]:
    flat = _unpack(s)
    if len(flat) % 2:
        raise ValueError("packed ext blob not a multiple of 2 felts")
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def _pack_cap(cap) -> str:
    return _pack([v for digest in cap for v in digest])


def _unpack_cap(s: str) -> list[list[int]]:
    flat = _unpack(s)
    if not flat or len(flat) % 4:
        raise ValueError("packed cap not a multiple of 4 felts")
    return [flat[i : i + 4] for i in range(0, len(flat), 4)]


def fri_proof_to_dict_packed(p: FriProof) -> dict:
    return {
        "pow_nonce": str(int(p.pow_nonce)),
        "layer_caps": [_pack_cap(c) for c in p.layer_caps],
        "final_poly": _pack_exts(p.final_poly),
        # per query: [val_i | val_j packed, path_i, path_j] per layer
        "query_rounds": [
            [
                [_pack_exts([vi, vj]), _pack_path(pi), _pack_path(pj)]
                for (vi, vj, pi, pj) in per_layer
            ]
            for per_layer in p.query_rounds
        ],
    }


def fri_proof_from_dict_packed(d: dict) -> FriProof:
    query_rounds = []
    for per_layer in d["query_rounds"]:
        out = []
        for vals, pi, pj in per_layer:
            v = _unpack_exts(vals)
            if len(v) != 2:
                raise ValueError("expected exactly val_i, val_j")
            out.append((v[0], v[1], _unpack_path(pi), _unpack_path(pj)))
        query_rounds.append(out)
    return FriProof(
        pow_nonce=_felt(d.get("pow_nonce", 0)),
        layer_caps=[_unpack_cap(c) for c in d["layer_caps"]],
        final_poly=_unpack_exts(d["final_poly"]),
        query_rounds=query_rounds,
    )


def statement_to_dict(p, include_publics: bool = True) -> dict:
    """batch.StatementProof -> dict; include_publics=False drops the public
    inputs (the composite reconstructs them)."""
    d = {
        "n_rows": p.n_rows,
        "trace_cap": _pack_cap(p.trace_cap),
        "quotient_cap": _pack_cap(p.quotient_cap),
        "aux_cap": _pack_cap(p.aux_cap) if p.aux_cap is not None else None,
        "ood_trace": [_pack_exts(per) for per in p.ood_trace],
        "ood_quotient": _pack_exts(p.ood_quotient),
        "openings": [
            [int(idx), _pack(trow), _pack_path(tpath), _pack(arow),
             _pack_path(apath), _pack(qrow), _pack_path(qpath)]
            for idx, (trow, tpath, arow, apath, qrow, qpath) in sorted(p.openings.items())
        ],
    }
    if include_publics:
        d["public_inputs"] = _pack(p.public_inputs)
    return d


def statement_from_dict(d: dict, publics: list[int] | None = None):
    """dict -> batch.StatementProof; `publics` supplies reconstructed
    public inputs when the dict omits them."""
    from .batch import StatementProof

    if publics is None:
        publics = _unpack(d["public_inputs"])
    aux_cap = d.get("aux_cap")
    openings = {}
    for entry in d["openings"]:
        if len(entry) != 7:
            raise ValueError("malformed opening entry")
        idx, trow, tpath, arow, apath, qrow, qpath = entry
        openings[int(idx)] = (
            _unpack(trow),
            _unpack_path(tpath),
            _unpack(arow),
            _unpack_path(apath),
            _unpack(qrow),
            _unpack_path(qpath),
        )
    return StatementProof(
        n_rows=int(d["n_rows"]),
        public_inputs=[_felt(v) for v in publics],
        trace_cap=_unpack_cap(d["trace_cap"]),
        quotient_cap=_unpack_cap(d["quotient_cap"]),
        aux_cap=_unpack_cap(aux_cap) if aux_cap is not None else None,
        ood_trace=[_unpack_exts(per) for per in d["ood_trace"]],
        ood_quotient=_unpack_exts(d["ood_quotient"]),
        openings=openings,
    )


def batch_proof_to_dict(p, publics_flags: list[bool] | None = None) -> dict:
    """batch.BatchStarkProof -> dict; publics_flags[i]=False omits
    statement i's publics."""
    flags = publics_flags or [True] * len(p.statements)
    return {
        "statements": [
            statement_to_dict(s, include_publics=f) for s, f in zip(p.statements, flags)
        ],
        "fri": fri_proof_to_dict_packed(p.fri_proof),
    }


def batch_proof_from_dict(d: dict, publics_list: list | None = None):
    """dict -> batch.BatchStarkProof; publics_list[i] (or None) supplies
    reconstructed publics for statements serialized without them."""
    from .batch import BatchStarkProof

    stmts_d = d["statements"]
    if publics_list is None:
        publics_list = [None] * len(stmts_d)
    if len(publics_list) != len(stmts_d):
        raise ValueError("publics_list length mismatch")
    return BatchStarkProof(
        statements=[
            statement_from_dict(sd, publics=pub) for sd, pub in zip(stmts_d, publics_list)
        ],
        fri_proof=fri_proof_from_dict_packed(d["fri"]),
    )


# ---------------------------------------------------------------------------
# Recursive wrapper wire format (stark/recursion.py)
# ---------------------------------------------------------------------------


def wrapped_batch_to_dict(w, publics_flags: list[bool] | None = None) -> dict:
    """recursion.WrappedBatchProof -> dict. The statements carry NO
    openings and the FRI data NO query rounds: the wrap batch (WrapAir
    query-phase proof + EvalAir OOD-evaluation proof) stands in for both."""
    flags = publics_flags or [True] * len(w.statements)
    return {
        "wrapped": True,
        "statements": [
            statement_to_dict(s, include_publics=f) for s, f in zip(w.statements, flags)
        ],
        "layer_caps": [_pack_cap(c) for c in w.layer_caps],
        "final_poly": _pack_exts(w.final_poly),
        "pow_nonce": str(int(w.pow_nonce)),
        # both wrap-batch statements' public-input vectors are rebuilt by
        # the verifier from the wire header and the transcript, so they
        # never ship
        "wrapper": batch_proof_to_dict(
            w.wrapper, publics_flags=[False] * len(w.wrapper.statements)
        ),
    }


def wrapped_batch_from_dict(d: dict, publics_list: list | None = None):
    """dict -> recursion.WrappedBatchProof. A wrapped statement that
    carries openings, or a wrap batch without exactly 2 statements,
    raises ValueError."""
    from .recursion import WrappedBatchProof

    stmts_d = d["statements"]
    if publics_list is None:
        publics_list = [None] * len(stmts_d)
    if len(publics_list) != len(stmts_d):
        raise ValueError("publics_list length mismatch")
    statements = [statement_from_dict(sd, publics=pub) for sd, pub in zip(stmts_d, publics_list)]
    for st in statements:
        if st.openings:
            raise ValueError("wrapped statement must not carry openings")
    wrapper_d = d["wrapper"]
    if len(wrapper_d.get("statements", ())) != 2:
        raise ValueError("wrap batch must have exactly 2 statements")
    return WrappedBatchProof(
        statements=statements,
        layer_caps=[_unpack_cap(c) for c in d["layer_caps"]],
        final_poly=_unpack_exts(d["final_poly"]),
        pow_nonce=_felt(d.get("pow_nonce", 0)),
        # publics are omitted on the wire ([] placeholder: the verifier
        # substitutes its own derived vectors); a dict that SMUGGLES
        # publics is parsed as-is so the verifier's equality check can
        # reject a mismatch
        wrapper=batch_proof_from_dict(
            wrapper_d,
            publics_list=[None if "public_inputs" in sd else [] for sd in wrapper_d["statements"]],
        ),
    )
