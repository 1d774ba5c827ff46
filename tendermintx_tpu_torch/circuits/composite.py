"""One proof object for a whole skip or step statement.

Counterpart of ``tendermintx_tpu/circuits/composite.py``:
``prove_skip_composite`` / ``prove_step_composite`` (..., device=...) run
the three statements' device work on one torch device, or with
``mesh=`` (a parallel/sharding.LaneMesh) sharded over the mesh's devices,
with the same proof bytes; ``wrap_composite(..., device= or mesh=)``
recursion-wraps a proof into its near-constant-size deliverable
(stark/recursion.py), and the ``verify_*_composite`` functions are host
logic for both forms. The wire format (``to_dict``/``to_bytes``) is the
reference's v5, wrapped or not, so either package reads the other's
proofs. ``runtime_configs`` gives the runtime layer (CLI, service,
operator) its settings from the environment, and refuses a security
floor below ``MIN_SECURITY_BITS``.

The upstream TendermintX deliverable is a single SNARK whose public inputs
are the abi.encodePacked circuit IO, consumed by the TendermintX contract
through `ISuccinctGateway.verifiedCall`. Here it is a CompositeProof — ONE
batch STARK (stark/batch.py: shared Fiat-Shamir transcript, one batch FRI
across all three statements) — whose public IO is exactly

    abi_inputs  = abi.encodePacked(trusted_block, trusted_header, target)
    abi_output  = target header hash (bytes32)

and whose verifier needs ONLY this object (plus the chain config):

  1. The hash statement (Sha256Air over circuits/hashing.py's plan) proves
     validator leaves → dynamic CometBFT Merkle tree → validators_hash →
     header-field Merkle proofs → the trusted/target header hashes,
     exposing the validator SimpleValidator encodings as proven preimages.
  2. The Ed25519 statement (stark/ed25519_air.py) proves Q = [s]B + [k](−A)
     per signer; its publics bind each lane to (s, k, slot tables, final
     state) and the verifier pins them to each signature: A is the pubkey
     parsed from the proven leaf encoding, k = SHA-512(R‖A‖M), and the
     final state must equal R projectively.
  3. The SHA-512 statement proves the k-derivation table over every
     signer's challenge preimage R ‖ A ‖ M.
  4. The verifier finishes with native wiring checks, all O(N) integer
     comparisons over proven data: precommit message contents, 2/3 voting
     power, the 1/3 trusted intersection and the skip distance.

All three statements share one transcript (seeded with the ABI IO) and one
FRI layer family / query set. Wire v5: no statement publics ship; the
verifier reconstructs every public-input vector from the minimal witness
bytes (validator leaf encodings + header-proof aunts, signer (index,
signature, message) triples plus packed 13-bit final-state limbs) and the
STARK transcript binds the reconstruction.

Default security: rate_bits=3, 28 queries, 16 pow bits = 100 conjectured
bits. Verifiers reject configs below MIN_SECURITY_BITS.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..inputs.conversion import (
    DUMMY_MESSAGE,
    DUMMY_PUBLIC_KEY,
    DUMMY_SIGNATURE,
)
from ..parallel.sharding import mesh_device
from ..stark.batch import BatchStarkProof, prove_batch, verify_batch
from ..stark.ed25519_air import (
    PUB_PER_SIG,
    SEGMENT as ED_SEGMENT_ROWS,
    Ed25519Air,
    check_lane_publics,
    derive_lane_final,
    derive_lane_publics,
    ed25519_air_trace,
)
from ..stark.sha512_air import (
    PUB_PER_SEGMENT as PUB_PER_SHA512_SEGMENT,
    SEGMENT as SHA512_SEGMENT_ROWS,
    Sha512Air,
    pad_message_512,
    schedule_messages_512,
    sha512_batch_trace,
    sha512_publics,
)
from ..stark.prover import StarkConfig
from ..stark.recursion import WrappedBatchProof, default_wrap_config, verify_wrapped_batch, wrap_batch
from ..stark.serialize import (
    batch_proof_from_dict,
    batch_proof_to_dict,
    wrapped_batch_from_dict,
    wrapped_batch_to_dict,
)
from ..stark.sha256_air import PUB_PER_SEGMENT as PUB_PER_HASH_SEGMENT, Sha256Air
from .hashing import (
    SEGMENT_ROWS as HASH_SEGMENT_ROWS,
    build_skip_plan,
    build_step_plan,
    check_plan,
    check_skip_hash_publics,
    check_step_hash_publics,
    plan_publics,
    skip_hash_statement,
    step_hash_statement,
)
from .skip import decode_skip_input, encode_skip_input
from .step import decode_step_input, encode_step_input

# 100 conjectured bits: rate_bits * n_queries + pow = 3*28 + 16.
DEFAULT_COMPOSITE_CONFIG = StarkConfig(
    rate_bits=3, n_queries=28, final_poly_len=64, proof_of_work_bits=16
)
MIN_SECURITY_BITS = 100


def _env_stark_config(var: str, default: StarkConfig) -> StarkConfig:
    """A config from the environment: 'rate_bits,n_queries,final_poly_len,
    pow_bits'. Read by the runtime surfaces only (service, CLI, operator);
    library callers pass configs explicitly."""
    s = os.environ.get(var)
    if not s:
        return default
    r, q, f, p = (int(x) for x in s.split(","))
    return StarkConfig(rate_bits=r, n_queries=q, final_poly_len=f, proof_of_work_bits=p)


def runtime_configs() -> tuple[StarkConfig, StarkConfig, int]:
    """(base config, wrap config, min security bits) for the runtime
    layer, from TMX_FRI_CONFIG / TMX_WRAP_FRI_CONFIG /
    TMX_MIN_SECURITY_BITS. A floor below MIN_SECURITY_BITS raises
    ValueError: the runtime never verifies at less than 100 bits (library
    callers may still pass a lower min_security_bits to the verifiers)."""
    base = _env_stark_config("TMX_FRI_CONFIG", DEFAULT_COMPOSITE_CONFIG)
    wrap = _env_stark_config("TMX_WRAP_FRI_CONFIG", default_wrap_config())
    min_bits = int(os.environ.get("TMX_MIN_SECURITY_BITS", MIN_SECURITY_BITS))
    if min_bits < MIN_SECURITY_BITS:
        raise ValueError(
            f"TMX_MIN_SECURITY_BITS={min_bits} is below the {MIN_SECURITY_BITS}-bit floor"
        )
    return base, wrap, min_bits


# Parse-time work bound: reconstruction costs per-lane native work (point
# decompression, table forms, one SHA-512) BEFORE any cryptographic check
# can reject the blob, so the lane count is capped at the deployment
# maximum — 4x the upstream production maximum of N=100 validators —
# rather than the 2^20 the structural format admits.
MAX_ED_LANES = 512


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _seed_felts(*parts: bytes, roots: list[list[int]] = ()) -> list[int]:
    data = b"".join(parts)
    data += bytes((-len(data)) % 4)
    out = [int.from_bytes(data[i : i + 4], "big") for i in range(0, len(data), 4)]
    for r in roots:
        out.extend(int(v) for v in r)
    return out


def _pack_blobs(blobs: list[bytes]) -> str:
    """Length-prefixed byte blobs -> base64 (wire v4). Each blob is
    u16-le length ‖ bytes; the whole sequence is one base64 string, so
    raw witness bytes cost ~1.33x their size instead of ~10x as felts."""
    import base64

    out = bytearray()
    for b in blobs:
        if len(b) > 0xFFFF:
            raise ValueError("blob too long to pack")
        out += len(b).to_bytes(2, "little")
        out += b
    return base64.b64encode(bytes(out)).decode()


def _unpack_blobs(s: str, max_total: int = 1 << 22) -> list[bytes]:
    """Inverse of _pack_blobs; size-capped, raises ValueError on any
    malformed framing (the from_dict failure contract)."""
    import base64

    raw = base64.b64decode(str(s), validate=True)
    if len(raw) > max_total:
        raise ValueError("packed blob sequence exceeds the size cap")
    out = []
    i = 0
    while i < len(raw):
        if i + 2 > len(raw):
            raise ValueError("truncated blob length prefix")
        n = int.from_bytes(raw[i : i + 2], "little")
        i += 2
        if i + n > len(raw):
            raise ValueError("truncated blob payload")
        out.append(bytes(raw[i : i + n]))
        i += n
    return out


_DUMMY_FINAL_CACHE: list[int] | None = None


def _dummy_final() -> list[int]:
    """Final-state limbs of the shared dummy lane (computed once)."""
    global _DUMMY_FINAL_CACHE
    if _DUMMY_FINAL_CACHE is None:
        fin = derive_lane_final(DUMMY_PUBLIC_KEY, DUMMY_MESSAGE, DUMMY_SIGNATURE)
        assert fin is not None
        _DUMMY_FINAL_CACHE = fin
    return _DUMMY_FINAL_CACHE


def _free_hash_data(
    kind: str, nb: int, nb_trusted: int, n_hash_segments: int,
    hash_publics: list[int],
) -> tuple[list[bytes], list[bytes]]:
    """(data-job preimages, free-side aunts), both in plan-job order —
    the minimal witness bytes the wire carries instead of the full hash
    publics vector (~10x smaller; the verifier rebuilds the publics with
    plan_publics and native SHA-256)."""
    plan = (
        build_skip_plan(nb, nb_trusted)[0]
        if kind == "skip"
        else build_step_plan(nb)[0]
    )
    res = check_plan(plan, hash_publics, n_hash_segments)
    if res is None:
        raise ValueError("hash publics do not match the plan")
    data = [res.data[j] for j, job in enumerate(plan.jobs) if job[0] == "data"]
    aunts = [res.aunts[j] for j in sorted(res.aunts)]
    return data, aunts


def _rebuild_hash_publics(
    kind: str, nb: int, nb_trusted: int, n_hash_segments: int,
    data: list[bytes], aunts: list[bytes],
) -> list[int]:
    """Wire v4 inverse of _free_hash_data: native plan walk over the
    shipped free bytes. Any framing/shape mismatch raises ValueError."""
    plan = (
        build_skip_plan(nb, nb_trusted)[0]
        if kind == "skip"
        else build_step_plan(nb)[0]
    )
    data_jobs = [j for j, job in enumerate(plan.jobs) if job[0] == "data"]
    free_jobs = [
        j
        for j, job in enumerate(plan.jobs)
        if job[0] == "inner" and ("free",) in (job[1], job[2])
    ]
    if len(data) != len(data_jobs):
        raise ValueError("wrong data-job count for the plan")
    if len(aunts) != len(free_jobs):
        raise ValueError("wrong aunt count for the plan")
    for a in aunts:
        if len(a) != 32:
            raise ValueError("aunt must be 32 bytes")
    publics = plan_publics(
        plan,
        dict(zip(data_jobs, data)),
        dict(zip(free_jobs, aunts)),
        min_segments=n_hash_segments,
    )
    if len(publics) != PUB_PER_HASH_SEGMENT * n_hash_segments:
        raise ValueError("hash segment count does not match the plan")
    return publics


def parse_simple_validator(enc: bytes) -> tuple[bytes, int] | None:
    """Strict SimpleValidator decode: 0a 22 0a 20 <pk32> 10 <varint power>
    (the exact bytes the reference marshals, validator.rs:185-207)."""
    if len(enc) < 37 or enc[:4] != b"\x0a\x22\x0a\x20":
        return None
    pk = enc[4:36]
    if enc[36] != 0x10:
        return None
    v = 0
    shift = 0
    i = 37
    while True:
        if i >= len(enc) or shift > 63:
            return None
        b = enc[i]
        v |= (b & 0x7F) << shift
        i += 1
        if not (b & 0x80):
            break
        shift += 7
    if i != len(enc):
        return None
    if i > 38 and enc[i - 1] == 0:  # non-canonical varint
        return None
    if v >= 1 << 63:
        return None
    return pk, v


def _check_message(msg: bytes, height: int, round_: int, header_hash: bytes) -> bool:
    """Verifier-side mirror of gadgets.message_checks (reference
    validator.rs:81-183): Precommit marker, full sfixed64 height and round,
    header-hash window inside the signed bytes."""
    if not (1 <= len(msg) <= 124):
        return False
    if msg[1:3] != b"\x08\x02":
        return False
    if len(msg) < 12 or int.from_bytes(msg[4:12], "little") != height:
        return False
    off = 16 if round_ == 0 else 25
    if round_ != 0:
        if len(msg) < 21 or msg[12] != 0x19:
            return False
        if int.from_bytes(msg[13:21], "little") != round_:
            return False
    if len(msg) < off + 32:
        return False
    return msg[off : off + 32] == header_hash


def _next_pow2(n: int) -> int:
    # smallest power of two >= n, with _next_pow2(0) == 1 (the naive
    # (n-1).bit_length() gives (-1).bit_length() == 1 for n == 0)
    return 1 << max(n - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# Proof object
# ---------------------------------------------------------------------------


@dataclass
class LaneSig:
    """One signer's exposure: which validator signed, what bytes, and the
    signature the Ed25519 STARK lane covers."""

    index: int
    message: bytes
    signature: bytes


@dataclass
class CompositeProof:
    kind: str  # "skip" | "step"
    abi_inputs: bytes
    abi_output: bytes  # bytes32 target/next header
    round: int
    nb: int  # target/new validator count
    nb_trusted: int  # skip only (0 for step)
    n_hash_segments: int
    n_ed_segments: int  # B: Ed25519 lanes (power of two)
    n_sha512_blocks: int
    signers: list[LaneSig]
    # per Ed25519 lane, the 60 final-state limbs (X,Y,Z in 13-bit limbs) —
    # the only lane publics that aren't a deterministic function of
    # (pubkey, message, signature); everything else is reconstructed
    ed_finals: list[list[int]]
    batch: BatchStarkProof

    def to_dict(self) -> dict:
        # Wire v5: NO statement publics ship at all. The hash statement's
        # publics (the wire's former N-scaling bulk, ~25 felts per SHA-256
        # segment) are replaced by the plan's FREE bytes — leaf preimages
        # + header-proof aunts, ~46 raw bytes per validator — and the
        # verifier rebuilds the full vector natively (plan_publics).
        # Signer-lane FINAL states ship as packed 13-bit limbs (120 raw
        # bytes per signer), so the verifier never replays an EC ladder.
        # With finals on the wire the STARK is load-bearing:
        # it alone proves final = [s]B + [k](-A), and the verifier's only
        # native EC work is the final-vs-R projective binding
        # (ed25519_air.check_lane_publics) plus table derivation.
        hash_data, hash_aunts = _free_hash_data(
            self.kind, self.nb, self.nb_trusted, self.n_hash_segments,
            [int(v) for v in self.batch.statements[0].public_inputs],
        )
        signer_blobs = []
        for s in self.signers:
            if len(s.signature) != 64 or not 0 <= s.index < 1 << 16:
                raise ValueError("unserializable signer")
            signer_blobs.append(
                s.index.to_bytes(2, "little") + s.signature + s.message
            )
        final_blobs = []
        for fin in self.ed_finals[: len(self.signers)]:
            if len(fin) != 60 or any(not 0 <= int(v) < 1 << 13 for v in fin):
                raise ValueError("unserializable lane final state")
            final_blobs.append(
                b"".join(int(v).to_bytes(2, "little") for v in fin)
            )
        return {
            "kind": f"{self.kind}-composite",
            "version": 5,
            "abi_inputs": self.abi_inputs.hex(),
            "abi_output": self.abi_output.hex(),
            "round": self.round,
            "nb": self.nb,
            "nb_trusted": self.nb_trusted,
            "n_hash_segments": self.n_hash_segments,
            "n_ed_segments": self.n_ed_segments,
            "n_sha512_blocks": self.n_sha512_blocks,
            "hash_data": _pack_blobs(hash_data),
            "hash_aunts": _pack_blobs(hash_aunts),
            "signers": _pack_blobs(signer_blobs),
            "ed_finals": _pack_blobs(final_blobs),
            "batch": (wrapped_batch_to_dict if self.is_wrapped else batch_proof_to_dict)(
                self.batch, publics_flags=[False, False, False]
            ),
        }

    @property
    def is_wrapped(self) -> bool:
        """True when the batch is recursion-wrapped: openings and FRI query
        rounds replaced by one wrap batch (stark/recursion.py)."""
        return isinstance(self.batch, WrappedBatchProof)

    def to_bytes(self) -> bytes:
        """Compact transport encoding: gzip of the canonical JSON (the
        packed-base64 felts cost 33% over raw bytes; gzip recovers that
        and the JSON framing). This is the on-the-wire form; to_dict stays
        the canonical structural form. The gzip header's timestamp is
        fixed at 0, so equal proofs give equal bytes."""
        import gzip
        import json as _json

        return gzip.compress(
            _json.dumps(self.to_dict(), separators=(",", ":")).encode(), 6, mtime=0
        )

    @classmethod
    def from_bytes(cls, data: bytes, max_size: int = 1 << 28) -> "CompositeProof":
        """Inverse of to_bytes. Decompression is size-capped so a tiny
        malicious blob cannot balloon memory (same boundary contract as
        from_dict: raises ValueError on malformed input)."""
        import gzip
        import json as _json

        with gzip.GzipFile(fileobj=__import__("io").BytesIO(data)) as f:
            raw = f.read(max_size + 1)
        if len(raw) > max_size:
            raise ValueError("composite proof exceeds the size cap")
        return cls.from_dict(_json.loads(raw))

    @classmethod
    def from_dict(cls, d: dict) -> "CompositeProof":
        """Raises ValueError/KeyError/TypeError on malformed input —
        callers treat any deserialization error as a verification failure
        (malformed proofs fail cleanly at the boundary, never via bare
        asserts that vanish under ``python -O``)."""
        kind = str(d["kind"])
        if not kind.endswith("-composite"):
            raise ValueError(f"not a composite proof kind: {kind!r}")
        kind = kind[: -len("-composite")]
        if kind not in ("skip", "step"):
            raise ValueError(f"unknown composite kind: {kind!r}")
        if int(d.get("version", 0)) != 5:
            raise ValueError("unsupported composite proof version")
        signers = []
        for blob in _unpack_blobs(d["signers"], max_total=1 << 20):
            if len(blob) < 2 + 64 + 1:
                raise ValueError("truncated signer record")
            signers.append(
                LaneSig(
                    index=int.from_bytes(blob[:2], "little"),
                    message=blob[66:],
                    signature=blob[2:66],
                )
            )
        nb = int(d["nb"])
        nb_trusted = int(d["nb_trusted"])
        n_hash_segments = int(d["n_hash_segments"])
        B = int(d["n_ed_segments"])
        n_sha512_blocks = int(d["n_sha512_blocks"])
        # Range-validate every count BEFORE reconstruction walks plans or
        # allocates (a mutated nb/segment count must fail cleanly here,
        # not via bare asserts in the plan functions — and must not be a
        # memory-amplification vector either).
        if not (1 <= nb <= 4096):
            raise ValueError("bad validator count")
        if not (0 <= nb_trusted <= 4096):
            raise ValueError("bad trusted validator count")
        if kind == "skip" and nb_trusted < 1:
            raise ValueError("skip proof needs a trusted set")
        # 1<<17 segments covers the nb<=4096 cap with headroom; anything
        # larger is a memory-amplification attempt (publics reconstruction
        # materializes 25 felts per claimed segment).
        if not (1 <= n_hash_segments <= 1 << 17) or n_hash_segments & (
            n_hash_segments - 1
        ):
            raise ValueError("bad hash segment count")
        if not (1 <= B <= MAX_ED_LANES) or B & (B - 1):
            raise ValueError("bad ed segment count")
        if B > _next_pow2(nb):
            raise ValueError("more ed lanes than validators")
        if len(signers) > B:
            raise ValueError("more signers than ed lanes")
        # strictly increasing signer indices (re-checked semantically in
        # _common_lane_checks) — at parse time this bounds the ladder
        # replays to DISTINCT validators and rejects many-signer spam
        # before any expensive reconstruction
        prev_index = -1
        for ls in signers:
            if not (prev_index < ls.index < nb):
                raise ValueError("signer indices not strictly increasing")
            prev_index = ls.index
        # each signer's challenge preimage R‖A‖M spans <= 3 SHA-512 blocks
        # (96 + <=124 message bytes + padding), so the schedule can never
        # legitimately exceed 4*MAX_ED_LANES blocks
        if not (1 <= n_sha512_blocks <= 4 * MAX_ED_LANES):
            raise ValueError("bad sha512 block count")

        batch_d = d["batch"]
        stmts = batch_d["statements"]
        if len(stmts) != 3:
            raise ValueError("composite batch must have 3 statements")
        # signer-lane final states from the wire (wire v5): 60 13-bit limbs
        # per signer. The verifier never replays an EC ladder — the
        # Ed25519 STARK proves the ladder; check_lane_publics binds the
        # proven final state to R projectively.
        ed_finals = []
        for blob in _unpack_blobs(d["ed_finals"], max_total=1 << 20):
            if len(blob) != 120:
                raise ValueError("bad lane final-state blob")
            fin = [
                int.from_bytes(blob[2 * i : 2 * i + 2], "little")
                for i in range(60)
            ]
            if any(v >= 1 << 13 for v in fin):
                raise ValueError("lane final limb out of range")
            ed_finals.append(fin)
        if len(ed_finals) != len(signers):
            raise ValueError("final-state count does not match signers")
        hash_publics = _rebuild_hash_publics(
            kind, nb, nb_trusted, n_hash_segments,
            _unpack_blobs(d["hash_data"]), _unpack_blobs(d["hash_aunts"]),
        )
        ed_finals.extend([_dummy_final()] * (B - len(signers)))
        ed_publics, sha_publics = _reconstruct_publics(
            kind, nb, nb_trusted, n_hash_segments, hash_publics, signers,
            ed_finals, B,
        )
        publics_list = [hash_publics, ed_publics, sha_publics]
        from_dict = wrapped_batch_from_dict if batch_d.get("wrapped") else batch_proof_from_dict
        batch = from_dict(batch_d, publics_list=publics_list)
        return cls(
            kind=kind,
            abi_inputs=bytes.fromhex(d["abi_inputs"]),
            abi_output=bytes.fromhex(d["abi_output"]),
            round=int(d["round"]),
            nb=nb,
            nb_trusted=nb_trusted,
            n_hash_segments=n_hash_segments,
            n_ed_segments=B,
            n_sha512_blocks=n_sha512_blocks,
            signers=signers,
            ed_finals=ed_finals,
            batch=batch,
        )


def _signer_pubkeys(
    kind: str,
    nb: int,
    nb_trusted: int,
    n_hash_segments: int,
    hash_publics: list[int],
    signers: list[LaneSig],
) -> list[bytes]:
    """Parse each signer's pubkey out of the (to-be-verified) hash
    statement's proven leaf encodings. Raises ValueError on any
    structural mismatch (from_dict's failure contract)."""
    if kind == "skip":
        plan, h = build_skip_plan(nb, nb_trusted)
        leaf_jobs = h.target_leaves
    else:
        plan, h = build_step_plan(nb)
        leaf_jobs = h.leaves
    res = check_plan(plan, hash_publics, n_hash_segments)
    if res is None:
        raise ValueError("hash publics do not match the plan")
    pks = []
    for ls in signers:
        if not 0 <= ls.index < len(leaf_jobs):
            raise ValueError("signer index out of range")
        enc = res.data[leaf_jobs[ls.index]]
        if not enc or enc[0] != 0x00:
            raise ValueError("malformed leaf encoding")
        parsed = parse_simple_validator(enc[1:])
        if parsed is None:
            raise ValueError("unparseable validator encoding")
        pks.append(parsed[0])
    return pks


_RECON_CACHE: dict = {}


def _reconstruct_publics(
    kind: str,
    nb: int,
    nb_trusted: int,
    n_hash_segments: int,
    hash_publics: list[int],
    signers: list[LaneSig],
    ed_finals: list[list[int]],
    B: int,
) -> tuple[list[int], list[int]]:
    """Rebuild the Ed25519 and SHA-512 statements' public inputs from the
    serialized signers + proven encodings + per-lane finals.

    Memoized on the FULL input content: one verification runs this twice
    (from_dict and the verifier's in-process re-derivation) — the key
    covers every input, so a mutated proof object can
    never hit a stale entry."""
    key = (
        kind, nb, nb_trusted, n_hash_segments,
        tuple(int(v) for v in hash_publics),
        tuple((s.index, s.message, s.signature) for s in signers),
        tuple(tuple(int(v) for v in f) for f in ed_finals),
        B,
    )
    if key in _RECON_CACHE:
        return _RECON_CACHE[key]
    out = _reconstruct_publics_impl(
        kind, nb, nb_trusted, n_hash_segments, hash_publics, signers,
        ed_finals, B,
    )
    if len(_RECON_CACHE) >= 4:
        _RECON_CACHE.clear()
    _RECON_CACHE[key] = out
    return out


def _reconstruct_publics_impl(
    kind: str,
    nb: int,
    nb_trusted: int,
    n_hash_segments: int,
    hash_publics: list[int],
    signers: list[LaneSig],
    ed_finals: list[list[int]],
    B: int,
) -> tuple[list[int], list[int]]:
    if len(signers) > B:
        raise ValueError("more signers than ed lanes")
    signer_pks = _signer_pubkeys(
        kind, nb, nb_trusted, n_hash_segments, hash_publics, signers
    )
    ed_publics: list[int] = []
    for lane in range(B):
        if lane < len(signers):
            ls = signers[lane]
            if len(ls.signature) != 64:
                raise ValueError("bad signature length")
            head = derive_lane_publics(
                signer_pks[lane], ls.message, ls.signature
            )
        else:
            head = derive_lane_publics(
                DUMMY_PUBLIC_KEY, DUMMY_MESSAGE, DUMMY_SIGNATURE
            )
        if head is None:
            raise ValueError("signature fails to decompress")
        fin = ed_finals[lane]
        if len(fin) != 60:
            raise ValueError("bad final-state limb count")
        ed_publics.extend(head)
        ed_publics.extend(int(v) for v in fin)

    blocks, chain, _spans = _challenge_blocks(signers, signer_pks)
    sha_publics = sha512_publics(blocks, chain)
    return ed_publics, sha_publics


# ---------------------------------------------------------------------------
# Proving
# ---------------------------------------------------------------------------


def _ed_statement(lanes, nb: int, device=None):
    """(air, trace, publics, B, signers, signer_pks) for the target set's
    signatures, dummy-padded to a power-of-two lane count."""
    signers = []
    pks, msgs, sigs = [], [], []
    for i, l in enumerate(lanes[:nb]):
        if l.signed:
            m = l.message[: l.message_byte_length]
            signers.append(LaneSig(index=i, message=m, signature=l.signature))
            pks.append(l.pubkey)
            msgs.append(m)
            sigs.append(l.signature)
    signer_pks = list(pks)
    B = max(_next_pow2(len(signers)), 1)
    while len(pks) < B:
        pks.append(DUMMY_PUBLIC_KEY)
        msgs.append(DUMMY_MESSAGE)
        sigs.append(DUMMY_SIGNATURE)
    trace, publics = ed25519_air_trace(pks, msgs, sigs, device)
    return Ed25519Air(B), trace, publics, B, signers, signer_pks


def _challenge_blocks(signers: list[LaneSig], signer_pks: list[bytes]):
    """Deterministic SHA-512 block schedule for the signers' challenge
    preimages R ‖ A ‖ M, padded to a power-of-two block count with
    standalone empty-message blocks."""
    msgs = [
        ls.signature[:32] + pk + ls.message
        for ls, pk in zip(signers, signer_pks)
    ]
    blocks, chain, spans = schedule_messages_512(msgs)
    target = max(_next_pow2(len(blocks)), 1)
    while len(blocks) < target:
        blocks.append(pad_message_512(b"")[0])
        chain.append(0)
    return blocks, chain, spans


def _sha512_statement(signers: list[LaneSig], signer_pks: list[bytes], device=None):
    """(air, trace, publics, n_blocks) for the challenge-hash table."""
    if not signers:
        raise ValueError("a valid commit has at least one signer")
    blocks, chain, _ = _challenge_blocks(signers, signer_pks)
    trace, publics = sha512_batch_trace(blocks, chain, device)
    return Sha512Air(len(blocks)), trace, publics, len(blocks)


def _ed_finals_from_publics(publics: list[int], B: int) -> list[list[int]]:
    return [
        [int(v) for v in publics[PUB_PER_SIG * l + 160 : PUB_PER_SIG * (l + 1)]]
        for l in range(B)
    ]


def prove_skip_composite(
    trusted_block: int,
    trusted_header: bytes,
    target_block: int,
    inputs,
    config: StarkConfig = DEFAULT_COMPOSITE_CONFIG,
    *,
    device=None,
    mesh=None,
) -> CompositeProof:
    """inputs: ``inputs.fetcher.SkipInputs`` for (trusted_block, target_block).
    device: the torch device every statement's LDE/commit/quotient/DEEP
    and the shared FRI run on; required without a mesh, so that no caller
    proves on the CPU without saying so. mesh: optional LaneMesh: every
    statement's LDE, leaf hashing, quotient and DEEP and the batch FRI's
    large folds are sharded over it, the rest runs on its first device
    (`device`, if given, must be that device); the proof bytes are those
    of the single-device path."""
    device = mesh_device(device, mesh)
    abi_in = encode_skip_input(trusted_block, trusted_header, target_block)
    abi_out = inputs.target_header
    air_h, trace_h, pub_h, nb, nbt = skip_hash_statement(inputs, device=device)
    air_e, trace_e, pub_e, B, signers, signer_pks = _ed_statement(
        inputs.target_block_validators, inputs.nb_target_validators, device
    )
    air_c, trace_c, pub_c, n_blocks = _sha512_statement(signers, signer_pks, device)
    seed = _seed_felts(abi_in, abi_out)
    batch = prove_batch(
        [air_h, air_e, air_c],
        [trace_h, trace_e, trace_c],
        [pub_h, pub_e, pub_c],
        config,
        transcript_seed=seed,
        mesh=mesh,
    )
    return CompositeProof(
        kind="skip",
        abi_inputs=abi_in,
        abi_output=abi_out,
        round=inputs.target_round,
        nb=nb,
        nb_trusted=nbt,
        n_hash_segments=len(pub_h) // PUB_PER_HASH_SEGMENT,
        n_ed_segments=B,
        n_sha512_blocks=n_blocks,
        signers=signers,
        ed_finals=_ed_finals_from_publics(pub_e, B),
        batch=batch,
    )


def prove_step_composite(
    prev_block: int,
    prev_header: bytes,
    inputs,
    config: StarkConfig = DEFAULT_COMPOSITE_CONFIG,
    *,
    device=None,
    mesh=None,
) -> CompositeProof:
    """inputs: ``inputs.fetcher.StepInputs`` for prev_block -> prev_block + 1.
    device / mesh: where the statements' work runs, as for
    prove_skip_composite."""
    device = mesh_device(device, mesh)
    abi_in = encode_step_input(prev_block, prev_header)
    abi_out = inputs.next_header
    air_h, trace_h, pub_h, nb = step_hash_statement(inputs, device=device)
    air_e, trace_e, pub_e, B, signers, signer_pks = _ed_statement(
        inputs.next_block_validators, inputs.nb_validators, device
    )
    air_c, trace_c, pub_c, n_blocks = _sha512_statement(signers, signer_pks, device)
    seed = _seed_felts(abi_in, abi_out)
    batch = prove_batch(
        [air_h, air_e, air_c],
        [trace_h, trace_e, trace_c],
        [pub_h, pub_e, pub_c],
        config,
        transcript_seed=seed,
        mesh=mesh,
    )
    return CompositeProof(
        kind="step",
        abi_inputs=abi_in,
        abi_output=abi_out,
        round=inputs.round,
        nb=nb,
        nb_trusted=0,
        n_hash_segments=len(pub_h) // PUB_PER_HASH_SEGMENT,
        n_ed_segments=B,
        n_sha512_blocks=n_blocks,
        signers=signers,
        ed_finals=_ed_finals_from_publics(pub_e, B),
        batch=batch,
    )


def _composite_airs(proof: CompositeProof) -> list:
    return [
        Sha256Air(proof.n_hash_segments),
        Ed25519Air(proof.n_ed_segments),
        Sha512Air(proof.n_sha512_blocks),
    ]


def wrap_composite(
    proof: CompositeProof,
    config: StarkConfig = DEFAULT_COMPOSITE_CONFIG,
    wrap_config: StarkConfig | None = None,
    *,
    device=None,
    mesh=None,
) -> CompositeProof:
    """Recursion-wrap a composite on `device`: replace the batch's openings
    and FRI query rounds with ONE wrap batch (stark/recursion.py), making
    the serialized proof's size independent of the validator count. The
    result verifies through the same verify_skip/step_composite entry
    points (the wrapped branch). With `mesh` the wrap batch is proven
    sharded over the mesh, as prove_skip_composite does, to the same
    bytes.

    Raises ValueError when `proof` does not verify: wrapping re-checks
    every opening against the caps while building the wrapper witness."""
    if proof.is_wrapped:
        raise ValueError("composite is already wrapped")
    wrapped = wrap_batch(
        _composite_airs(proof), proof.batch, config,
        transcript_seed=_seed_felts(proof.abi_inputs, proof.abi_output),
        wrap_config=wrap_config, device=device, mesh=mesh,
    )
    return CompositeProof(
        kind=proof.kind,
        abi_inputs=proof.abi_inputs,
        abi_output=proof.abi_output,
        round=proof.round,
        nb=proof.nb,
        nb_trusted=proof.nb_trusted,
        n_hash_segments=proof.n_hash_segments,
        n_ed_segments=proof.n_ed_segments,
        n_sha512_blocks=proof.n_sha512_blocks,
        signers=list(proof.signers),
        ed_finals=[list(f) for f in proof.ed_finals],
        batch=wrapped,
    )


# ---------------------------------------------------------------------------
# Verification — needs ONLY the proof object + chain config
# ---------------------------------------------------------------------------


def _verify_batch_and_common(
    proof: CompositeProof, config: StarkConfig, min_security_bits: int,
    wrap_config: StarkConfig | None = None,
):
    """Shape checks, ONE batch verification, then the shared wiring
    checks: parse the proven validator encodings, pin each signer lane,
    run the message checks, and the 2/3 voting threshold. Returns
    (facts_publics, vals, signer_pk_set) or None.

    The Ed25519/SHA-512 publics the batch verifies against were
    reconstructed (at from_dict, or directly by the prover) from the
    signers + the hash statement's proven encodings + the per-lane final
    states, so every per-lane equality against shipped publics holds by
    construction; what remains real is
    the STARK verification itself, the final-state-vs-R binding, the
    message checks, and the voting arithmetic."""
    if config.fri.security_bits < min_security_bits:
        return None
    if not (0 <= proof.round < (1 << 31)):
        return None
    B = proof.n_ed_segments
    if B < 1 or B & (B - 1):
        return None
    if not (0 < len(proof.signers) <= B):
        return None
    if len(proof.ed_finals) != B:
        return None
    if len(proof.batch.statements) != 3:
        return None
    st_h, st_e, st_c = proof.batch.statements
    if st_h.n_rows != proof.n_hash_segments * HASH_SEGMENT_ROWS:
        return None
    if st_e.n_rows != B * ED_SEGMENT_ROWS:
        return None
    if st_c.n_rows != proof.n_sha512_blocks * SHA512_SEGMENT_ROWS:
        return None
    airs = _composite_airs(proof)
    seed = _seed_felts(proof.abi_inputs, proof.abi_output)
    if proof.is_wrapped:
        # Recursion-wrapped: native transcript replay + the two-statement
        # wrap batch (WrapAir for every opening/fold, EvalAir for every
        # OOD constraint evaluation). The wrapper config is the VERIFIER'S
        # choice, never the proof's, and meets the same security floor.
        wcfg = wrap_config or default_wrap_config()
        if wcfg.fri.security_bits < min_security_bits:
            return None
        if not verify_wrapped_batch(airs, proof.batch, config, transcript_seed=seed, wrap_config=wcfg):
            return None
    elif not verify_batch(airs, proof.batch, config, transcript_seed=seed):
        return None

    # Reconstructed-publics consistency: a CompositeProof built in-process
    # (not via from_dict) could carry arbitrary ed/sha512 publics; re-derive
    # and compare so both construction paths verify the same statement.
    try:
        ed_pub, sha_pub = _reconstruct_publics(
            proof.kind, proof.nb, proof.nb_trusted, proof.n_hash_segments,
            [int(v) for v in st_h.public_inputs], proof.signers,
            proof.ed_finals, B,
        )
    except (ValueError, KeyError, IndexError, TypeError):
        return None
    if [int(v) for v in st_e.public_inputs] != ed_pub:
        return None
    if [int(v) for v in st_c.public_inputs] != sha_pub:
        return None
    if len(sha_pub) != PUB_PER_SHA512_SEGMENT * proof.n_sha512_blocks:
        return None
    return st_h, st_e


def _common_lane_checks(
    proof: CompositeProof,
    encodings: list[bytes],
    header_hash: bytes,
    height: int,
    ed_publics: list[int],
):
    """Parse encodings, pin lanes, message checks, 2/3 threshold.
    Returns (vals, signer_pk_set) or None."""
    vals = []
    for enc in encodings:
        parsed = parse_simple_validator(enc)
        if parsed is None:
            return None
        vals.append(parsed)

    prev_index = -1
    signer_pks = []
    for lane, ls in enumerate(proof.signers):
        if not (prev_index < ls.index < len(vals)):
            return None  # indices strictly increasing: no double counting
        prev_index = ls.index
        pk = vals[ls.index][0]
        seg = ed_publics[PUB_PER_SIG * lane : PUB_PER_SIG * (lane + 1)]
        if len(ls.signature) != 64:
            return None
        if not check_lane_publics(seg, pk, ls.message, ls.signature):
            return None
        if not _check_message(ls.message, height, proof.round, header_hash):
            return None
        signer_pks.append(pk)

    total = sum(p for _, p in vals)
    signed_power = sum(vals[ls.index][1] for ls in proof.signers)
    if not signed_power * 3 > total * 2:
        return None
    return vals, set(signer_pks)


_VERIFY_EXC = (
    ValueError,
    AssertionError,
    KeyError,
    IndexError,
    TypeError,
    OverflowError,
    AttributeError,
)


def verify_skip_composite(
    proof: CompositeProof,
    chain_id: str,
    skip_max: int,
    config: StarkConfig = DEFAULT_COMPOSITE_CONFIG,
    min_security_bits: int = MIN_SECURITY_BITS,
    wrap_config: StarkConfig | None = None,
) -> tuple[int, bytes, int, bytes] | None:
    """Returns (trusted_block, trusted_header, target_block, target_header)
    on success, None otherwise — NEVER an exception (a structurally broken
    CompositeProof is indistinguishable from a cryptographically invalid
    one; same contract as stark.verifier.verify). Mirrors reference
    verify_skip (verify.rs:528-563) with every hash/signature fact proven."""
    try:
        return _verify_skip_inner(
            proof, chain_id, skip_max, config, min_security_bits, wrap_config
        )
    except _VERIFY_EXC:
        return None


def _verify_skip_inner(
    proof: CompositeProof,
    chain_id: str,
    skip_max: int,
    config: StarkConfig,
    min_security_bits: int,
    wrap_config: StarkConfig | None,
) -> tuple[int, bytes, int, bytes] | None:
    if proof.kind != "skip" or len(proof.abi_inputs) != 48:
        return None
    trusted_block, trusted_header, target_block = decode_skip_input(
        proof.abi_inputs
    )
    target_header = proof.abi_output
    if len(target_header) != 32:
        return None
    # skip distance (verify.rs:508-526)
    if not (trusted_block + 1 < target_block <= trusted_block + skip_max):
        return None

    common = _verify_batch_and_common(proof, config, min_security_bits, wrap_config)
    if common is None:
        return None
    st_h, st_e = common
    facts = check_skip_hash_publics(
        [int(v) for v in st_h.public_inputs],
        proof.n_hash_segments,
        proof.nb,
        proof.nb_trusted,
        chain_id,
        trusted_header,
        target_header,
        target_block,
    )
    if facts is None:
        return None
    lane_out = _common_lane_checks(
        proof, facts.target_encodings, target_header, target_block,
        [int(v) for v in st_e.public_inputs],
    )
    if lane_out is None:
        return None
    _, signer_pks = lane_out

    # 1/3 intersection over the trusted set (verify.rs:391-437)
    trusted_vals = []
    for enc in facts.trusted_encodings:
        parsed = parse_simple_validator(enc)
        if parsed is None:
            return None
        trusted_vals.append(parsed)
    trusted_total = sum(p for _, p in trusted_vals)
    inter = sum(p for pk, p in trusted_vals if pk in signer_pks)
    if not inter * 3 > trusted_total * 1:
        return None

    return trusted_block, trusted_header, target_block, target_header


def verify_step_composite(
    proof: CompositeProof,
    chain_id: str,
    config: StarkConfig = DEFAULT_COMPOSITE_CONFIG,
    min_security_bits: int = MIN_SECURITY_BITS,
    wrap_config: StarkConfig | None = None,
) -> tuple[int, bytes, bytes] | None:
    """Returns (prev_block, prev_header, next_header) on success, None
    otherwise — NEVER an exception (see verify_skip_composite). Mirrors
    reference verify_step (verify.rs:469-506): full header verification of
    prev+1 plus the prev-hash and next-validators-hash links (both enforced
    inside the hash STARK's statement bindings)."""
    try:
        return _verify_step_inner(proof, chain_id, config, min_security_bits, wrap_config)
    except _VERIFY_EXC:
        return None


def _verify_step_inner(
    proof: CompositeProof,
    chain_id: str,
    config: StarkConfig,
    min_security_bits: int,
    wrap_config: StarkConfig | None,
) -> tuple[int, bytes, bytes] | None:
    if proof.kind != "step" or len(proof.abi_inputs) != 40:
        return None
    prev_block, prev_header = decode_step_input(proof.abi_inputs)
    next_header = proof.abi_output
    if len(next_header) != 32:
        return None

    common = _verify_batch_and_common(proof, config, min_security_bits, wrap_config)
    if common is None:
        return None
    st_h, st_e = common
    facts = check_step_hash_publics(
        [int(v) for v in st_h.public_inputs],
        proof.n_hash_segments,
        proof.nb,
        chain_id,
        prev_header,
        next_header,
        prev_block + 1,
    )
    if facts is None:
        return None
    lane_out = _common_lane_checks(
        proof, facts.encodings, next_header, prev_block + 1,
        [int(v) for v in st_e.public_inputs],
    )
    if lane_out is None:
        return None
    return prev_block, prev_header, next_header
