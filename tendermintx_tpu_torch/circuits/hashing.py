"""Proven hashing statements: one SHA-256 STARK for the whole hash layer.

Counterpart of ``tendermintx_tpu/circuits/hashing.py``: plans, the hash
statement fed to the composite prover, the verifier's wiring checks, and
the standalone hash-bundle proof (``prove_{skip,step}_hashes`` on a torch
device, ``verify_{skip,step}_hashes`` on the host). The upstream
TendermintX circuits prove all SHA-256 work (validator leaves, CometBFT
Merkle trees, header-field inclusion proofs) inside one SHA-256 table.
Here every hash invocation of a skip statement becomes a *job* — a run of
chained segments — in a single batched Sha256Air trace, and the tree/proof
structure between jobs is enforced over the proof's PUBLIC inputs by
`check_plan`: the verifier checks that a parent job's (proven) message
bytes are exactly 0x01 ‖ left-digest ‖ right-digest of its (proven)
children, that leaf preimages are well-formed, and that the final roots
equal the statement's header hashes. The verifier never hashes.

Job kinds:
  ("data", n_segments)        prover-supplied preimage (validator leaf,
                              header field leaf)
  ("inner", left, right)      65-byte RFC-6962 inner node; each side is
                              ("job", j) — bound to job j's digest — or
                              ("free",) — an aunt, read out of the publics
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from functools import lru_cache

from ..inputs.tendermint import (
    Validator,
    encode_varint,
    get_path_indices,
    get_split_point,
)
from ..stark.prover import StarkConfig, StarkProof, prove
from ..stark.serialize import stark_proof_from_dict, stark_proof_to_dict
from ..stark.verifier import verify
from .consts import (
    BLOCK_HEIGHT_INDEX,
    CHAIN_ID_INDEX,
    LAST_BLOCK_ID_INDEX,
    NEXT_VALIDATORS_HASH_INDEX,
    VALIDATORS_HASH_INDEX,
)
from ..stark.sha256_air import (
    PUB_PER_SEGMENT,
    Sha256Air,
    digest_words_to_bytes,
    pad_message,
    schedule_messages,
    sha256_batch_trace,
    sha256_publics,
)

HEADER_FIELDS_TOTAL = 14  # CometBFT header Merkle tree leaf count
SEGMENT_ROWS = 64

DEFAULT_HASH_CONFIG = StarkConfig(rate_bits=2, n_queries=28, final_poly_len=64)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclass
class Plan:
    jobs: list = field(default_factory=list)

    def data(self, n_segments: int = 1) -> int:
        self.jobs.append(("data", n_segments))
        return len(self.jobs) - 1

    def inner(self, left, right) -> int:
        for side in (left, right):
            assert side[0] in ("job", "free")
            if side[0] == "job":
                assert 0 <= side[1] < len(self.jobs)
        # At most ONE free side per inner job: aunt_map/PlanResult.aunts key
        # aunts by job id, so a second free side would silently collide.
        # Every real plan shape (header-proof paths) has exactly one free
        # side per inner node.
        if left[0] == "free" and right[0] == "free":
            raise ValueError("inner job cannot have two free sides")
        self.jobs.append(("inner", left, right))
        return len(self.jobs) - 1

    def spans(self) -> list[tuple[int, int]]:
        """(first_segment, n_segments) per job."""
        out = []
        seg = 0
        for job in self.jobs:
            n = job[1] if job[0] == "data" else 2
            out.append((seg, n))
            seg += n
        return out

    @property
    def n_segments(self) -> int:
        spans = self.spans()
        return spans[-1][0] + spans[-1][1] if spans else 0


def add_merkle_tree(plan: Plan, leaf_jobs: list[int]) -> int:
    """CometBFT variable-size tree (recursive largest-power-of-two split,
    inputs/tendermint.py:96-110 semantics) over already-planned leaf jobs.
    Returns the root job id (== the single leaf for size 1)."""
    assert leaf_jobs

    def rec(jobs: list[int]) -> int:
        if len(jobs) == 1:
            return jobs[0]
        k = get_split_point(len(jobs))
        left = rec(jobs[:k])
        right = rec(jobs[k:])
        return plan.inner(("job", left), ("job", right))

    return rec(leaf_jobs)


def add_header_proof(plan: Plan, leaf_job: int, field_index: int) -> int:
    """Four inner-node jobs lifting a header-field leaf to the header root
    along the (deterministic) path for `field_index` in the 14-leaf header
    tree. The aunts are free sides, carried in the publics."""
    bits = get_path_indices(field_index, HEADER_FIELDS_TOTAL)
    cur = leaf_job
    for bit in bits:
        if bit:  # current node is the right child
            cur = plan.inner(("free",), ("job", cur))
        else:
            cur = plan.inner(("job", cur), ("free",))
    return cur


# ---------------------------------------------------------------------------
# Proving
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    # smallest power of two >= n, with _next_pow2(0) == 1 (the naive
    # (n-1).bit_length() gives (-1).bit_length() == 1 for n == 0)
    return 1 << max(n - 1, 0).bit_length()


def plan_statement(
    plan: Plan,
    data_map: dict[int, bytes],
    aunt_map: dict[int, bytes],
    min_segments: int = 32,
    device=None,
):
    """Build the Sha256Air statement for `plan`: (air, trace on `device`,
    publics).
    data_map: bytes per data job; aunt_map: 32-byte aunt per inner job
    with a free side. The trace is padded with throwaway empty-message
    segments to a power-of-two segment count."""
    blocks, chain, total = _plan_blocks(plan, data_map, aunt_map, min_segments)
    trace, publics = sha256_batch_trace(blocks, chain, device)
    return Sha256Air(total), trace, publics


def _plan_blocks(
    plan: Plan,
    data_map: dict[int, bytes],
    aunt_map: dict[int, bytes],
    min_segments: int = 32,
) -> tuple[list[bytes], list[int], int]:
    """The plan's padded 64-byte block schedule (blocks, chain, total
    segments), shared by the prover (plan_statement) and the wire-v4
    publics reconstruction (plan_publics)."""
    digests: list[bytes] = []
    messages: list[bytes] = []
    for j, job in enumerate(plan.jobs):
        if job[0] == "data":
            msg = data_map[j]
            exp = (len(msg) + 9 + 63) // 64
            if exp != job[1]:
                raise ValueError(
                    f"job {j}: {len(msg)}-byte data needs {exp} segments, "
                    f"plan says {job[1]}"
                )
        else:
            _, left, right = job
            lb = digests[left[1]] if left[0] == "job" else aunt_map[j]
            rb = digests[right[1]] if right[0] == "job" else aunt_map[j]
            if len(lb) != 32 or len(rb) != 32:
                raise ValueError("inner-node side must be a 32-byte digest")
            msg = b"\x01" + lb + rb
        messages.append(msg)
        digests.append(hashlib.sha256(msg).digest())

    total = max(_next_pow2(plan.n_segments), min_segments)
    blocks, chain, _spans = schedule_messages(messages)
    assert len(blocks) == plan.n_segments
    while len(blocks) < total:
        blocks.append(pad_message(b"")[0])
        chain.append(0)
    return blocks, chain, total


def plan_publics(
    plan: Plan,
    data_map: dict[int, bytes],
    aunt_map: dict[int, bytes],
    min_segments: int = 32,
) -> list[int]:
    """The hash statement's public inputs, recomputed natively from the
    plan's FREE data (leaf preimages + aunts) — no trace build. Wire v4
    (circuits/composite.py) ships only the free bytes; the verifier
    rebuilds the full publics vector here and binds it into the STARK
    transcript, so a wrong reconstruction can only make verification
    fail, never accept a different statement."""
    blocks, chain, _total = _plan_blocks(plan, data_map, aunt_map, min_segments)
    return sha256_publics(blocks, chain)


def prove_plan(
    plan: Plan,
    data_map: dict[int, bytes],
    aunt_map: dict[int, bytes],
    config: StarkConfig = DEFAULT_HASH_CONFIG,
    min_segments: int = 32,
    transcript_seed: list[int] | None = None,
    *,
    device,
) -> StarkProof:
    """Prove every job in `plan` as a standalone STARK on `device` (the
    composite instead feeds plan_statement into the batch prover)."""
    air, trace, publics = plan_statement(plan, data_map, aunt_map, min_segments, device)
    return prove(air, trace, publics, config, transcript_seed=transcript_seed)


# ---------------------------------------------------------------------------
# Verifying (wiring checks over the public inputs — no hashing)
# ---------------------------------------------------------------------------


def _unpad(padded: bytes, n_segments: int) -> bytes | None:
    """Strict inverse of pad_message for a known segment count."""
    total = 64 * n_segments
    if len(padded) != total:
        return None
    bitlen = int.from_bytes(padded[-8:], "big")
    if bitlen % 8:
        return None
    n = bitlen // 8
    if (n + 9 + 63) // 64 != n_segments:
        return None
    if padded[n] != 0x80:
        return None
    if any(padded[n + 1 : total - 8]):
        return None
    return padded[:n]


@dataclass
class PlanResult:
    data: dict[int, bytes]  # data-job preimages
    digests: dict[int, bytes]  # every job's digest
    aunts: dict[int, bytes]  # free-side values of inner jobs


_CHECK_PLAN_CACHE: dict = {}


def check_plan(plan: Plan, publics: list[int], total_segments: int) -> PlanResult | None:
    """Check the plan's wiring against STARK-verified public inputs.

    Caller must have verified the Sha256Air proof (which validates word
    ranges and chain-flag booleanity) first.

    Memoized on the full (plan, publics, total_segments) content: one
    composite verification walks the same plan against the same publics up
    to three times (deserialization reconstruction, the verifier's
    re-derivation, and the facts extraction), and this walk is half the
    verify latency. Callers must not
    mutate the returned PlanResult."""
    key = (tuple(plan.jobs), tuple(int(v) for v in publics), total_segments)
    if key in _CHECK_PLAN_CACHE:
        return _CHECK_PLAN_CACHE[key]
    out = _check_plan_impl(plan, publics, total_segments)
    if len(_CHECK_PLAN_CACHE) >= 8:
        _CHECK_PLAN_CACHE.clear()
    _CHECK_PLAN_CACHE[key] = out
    return out


def _check_plan_impl(
    plan: Plan, publics: list[int], total_segments: int
) -> PlanResult | None:
    if len(publics) != PUB_PER_SEGMENT * total_segments:
        return None
    if plan.n_segments > total_segments:
        return None

    def seg(s):
        base = PUB_PER_SEGMENT * s
        msg = [int(v) for v in publics[base : base + 16]]
        digest = [int(v) for v in publics[base + 16 : base + 24]]
        return msg, digest, int(publics[base + 24])

    data: dict[int, bytes] = {}
    digests: dict[int, bytes] = {}
    aunts: dict[int, bytes] = {}
    for j, (job, (start, n)) in enumerate(zip(plan.jobs, plan.spans())):
        padded = b""
        for k in range(n):
            msg, digest, chain = seg(start + k)
            if chain != (0 if k == 0 else 1):
                return None
            padded += b"".join(int(w).to_bytes(4, "big") for w in msg)
            if k == n - 1:
                digests[j] = digest_words_to_bytes(digest)
        raw = _unpad(padded, n)
        if raw is None:
            return None
        if job[0] == "data":
            data[j] = raw
        else:
            _, left, right = job
            if len(raw) != 65 or raw[0] != 0x01:
                return None
            lb, rb = raw[1:33], raw[33:65]
            for side, got in ((left, lb), (right, rb)):
                if side[0] == "job":
                    if got != digests[side[1]]:
                        return None
                else:
                    aunts[j] = got
    return PlanResult(data=data, digests=digests, aunts=aunts)


# ---------------------------------------------------------------------------
# Step / skip hash statements
# ---------------------------------------------------------------------------


def _hash_leaf(digest: bytes) -> bytes:
    """Protobuf-encoded hash leaf preimage (0x00 ‖ 0x0a 0x20 ‖ hash) —
    what VALIDATORS_HASH / NEXT_VALIDATORS_HASH leaves look like."""
    return b"\x00\x0a\x20" + digest


def _chain_id_leaf(chain_id: str) -> bytes:
    body = chain_id.encode()
    return b"\x00\x0a" + bytes([len(body)]) + body


def _height_leaf(height: int) -> bytes:
    return b"\x00\x08" + encode_varint(height)


def _leaf_segments(data: bytes) -> int:
    return (len(data) + 9 + 63) // 64


@dataclass
class SkipPlanHandles:
    target_leaves: list[int]
    target_root: int
    trusted_leaves: list[int]
    trusted_root: int
    vh_leaf: int
    vh_root: int
    cid_leaf: int
    cid_root: int
    h_leaf: int
    h_root: int
    tvh_leaf: int
    tvh_root: int


@lru_cache(maxsize=8)
def build_skip_plan(nb_target: int, nb_trusted: int) -> tuple[Plan, SkipPlanHandles]:
    """Deterministic in its arguments; cached (callers never mutate a built
    Plan — jobs are appended only during construction here)."""
    plan = Plan()
    t_leaves = [plan.data(1) for _ in range(nb_target)]
    t_root = add_merkle_tree(plan, t_leaves)
    tr_leaves = [plan.data(1) for _ in range(nb_trusted)]
    tr_root = add_merkle_tree(plan, tr_leaves)
    vh_leaf = plan.data(1)
    vh_root = add_header_proof(plan, vh_leaf, VALIDATORS_HASH_INDEX)
    cid_leaf = plan.data(1)
    cid_root = add_header_proof(plan, cid_leaf, CHAIN_ID_INDEX)
    h_leaf = plan.data(1)
    h_root = add_header_proof(plan, h_leaf, BLOCK_HEIGHT_INDEX)
    tvh_leaf = plan.data(1)
    tvh_root = add_header_proof(plan, tvh_leaf, VALIDATORS_HASH_INDEX)
    return plan, SkipPlanHandles(
        t_leaves, t_root, tr_leaves, tr_root,
        vh_leaf, vh_root, cid_leaf, cid_root, h_leaf, h_root,
        tvh_leaf, tvh_root,
    )


@dataclass
class StepPlanHandles:
    leaves: list[int]
    root: int
    vh_leaf: int
    vh_root: int
    cid_leaf: int
    cid_root: int
    h_leaf: int
    h_root: int
    lbi_leaf: int
    lbi_root: int
    pnvh_leaf: int
    pnvh_root: int


@lru_cache(maxsize=8)
def build_step_plan(nb_validators: int) -> tuple[Plan, StepPlanHandles]:
    """Deterministic in its argument; cached (see build_skip_plan)."""
    plan = Plan()
    leaves = [plan.data(1) for _ in range(nb_validators)]
    root = add_merkle_tree(plan, leaves)
    vh_leaf = plan.data(1)
    vh_root = add_header_proof(plan, vh_leaf, VALIDATORS_HASH_INDEX)
    cid_leaf = plan.data(1)
    cid_root = add_header_proof(plan, cid_leaf, CHAIN_ID_INDEX)
    h_leaf = plan.data(1)
    h_root = add_header_proof(plan, h_leaf, BLOCK_HEIGHT_INDEX)
    lbi_leaf = plan.data(2)  # 73-byte BlockID leaf spans two segments
    lbi_root = add_header_proof(plan, lbi_leaf, LAST_BLOCK_ID_INDEX)
    pnvh_leaf = plan.data(1)
    pnvh_root = add_header_proof(plan, pnvh_leaf, NEXT_VALIDATORS_HASH_INDEX)
    return plan, StepPlanHandles(
        leaves, root, vh_leaf, vh_root, cid_leaf, cid_root,
        h_leaf, h_root, lbi_leaf, lbi_root, pnvh_leaf, pnvh_root,
    )


def _lane_leaf(lane) -> bytes:
    enc = Validator(
        address=b"", pubkey=lane.pubkey, voting_power=lane.voting_power
    ).simple_encode()
    return b"\x00" + enc


@dataclass
class HashBundle:
    """One SHA-256 STARK covering a step or skip statement's hash layer."""

    kind: str  # "skip" | "step"
    proof: StarkProof
    n_segments: int
    nb: int  # target/new validator count
    nb_trusted: int  # skip only (0 for step)

    def to_dict(self) -> dict:
        return {
            "kind": f"{self.kind}-hashes",
            "n_segments": self.n_segments,
            "nb": self.nb,
            "nb_trusted": self.nb_trusted,
            "proof": stark_proof_to_dict(self.proof),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HashBundle":
        """Raises ValueError on a kind that is not a hash bundle's; other
        malformed input raises ValueError, KeyError, TypeError,
        AttributeError or IndexError (CompositeProof.from_dict's contract)."""
        kind = str(d["kind"])
        if not kind.endswith("-hashes"):
            raise ValueError(f"not a hash-bundle kind: {kind!r}")
        return cls(
            kind=kind[: -len("-hashes")],
            proof=stark_proof_from_dict(d["proof"]),
            n_segments=int(d["n_segments"]),
            nb=int(d["nb"]),
            nb_trusted=int(d["nb_trusted"]),
        )


def _aunt_map_for(plan: Plan, root_jobs: list[tuple[int, list[bytes]]]) -> dict[int, bytes]:
    """Map each header-proof inner job to its aunt, walking up from each
    (leaf_job + 1 .. root) chain in plan order."""
    out = {}
    for first_inner, aunts in root_jobs:
        for d, aunt in enumerate(aunts):
            out[first_inner + d] = aunt
    return out


def skip_hash_statement(inputs, min_segments: int = 32, device=None):
    """Sha256Air statement for a skip's whole hash layer:
    (air, trace, publics, nb, nb_trusted), fed to the batch prover by
    circuits/composite.py."""
    nb = inputs.nb_target_validators
    nbt = inputs.nb_trusted_validators
    plan, h = build_skip_plan(nb, nbt)
    data_map: dict[int, bytes] = {}
    for j, lane in zip(h.target_leaves, inputs.target_block_validators[:nb]):
        data_map[j] = _lane_leaf(lane)
    for j, lane in zip(
        h.trusted_leaves, inputs.trusted_header_validators_hash_fields[:nbt]
    ):
        data_map[j] = _lane_leaf(lane)
    data_map[h.vh_leaf] = b"\x00" + inputs.target_header_validators_hash_leaf
    data_map[h.cid_leaf] = b"\x00" + inputs.target_header_chain_id_leaf
    data_map[h.h_leaf] = b"\x00" + inputs.target_header_height_leaf
    data_map[h.tvh_leaf] = b"\x00" + inputs.trusted_header_validators_hash_leaf
    aunt_map = _aunt_map_for(
        plan,
        [
            (h.vh_leaf + 1, inputs.target_header_validators_hash_proof.aunts),
            (h.cid_leaf + 1, inputs.target_header_chain_id_proof.aunts),
            (h.h_leaf + 1, inputs.target_header_height_proof.aunts),
            (h.tvh_leaf + 1, inputs.trusted_header_validators_hash_proof.aunts),
        ],
    )
    air, trace, publics = plan_statement(plan, data_map, aunt_map, min_segments, device)
    return air, trace, publics, nb, nbt


def _bundle(kind: str, air, trace, publics, config, transcript_seed, nb: int, nbt: int) -> HashBundle:
    proof = prove(air, trace, publics, config, transcript_seed=transcript_seed)
    total = len(proof.public_inputs) // PUB_PER_SEGMENT
    return HashBundle(kind=kind, proof=proof, n_segments=total, nb=nb, nb_trusted=nbt)


def prove_skip_hashes(
    inputs,
    config: StarkConfig = DEFAULT_HASH_CONFIG,
    transcript_seed: list[int] | None = None,
    *,
    device,
) -> HashBundle:
    """inputs: fetcher.SkipInputs; the proof's device work runs on
    `device`."""
    air, trace, publics, nb, nbt = skip_hash_statement(inputs, device=device)
    return _bundle("skip", air, trace, publics, config, transcript_seed, nb, nbt)


def step_hash_statement(inputs, min_segments: int = 32, device=None):
    """(air, trace, publics, nb) for a step's hash layer."""
    nb = inputs.nb_validators
    plan, h = build_step_plan(nb)
    data_map: dict[int, bytes] = {}
    for j, lane in zip(h.leaves, inputs.next_block_validators[:nb]):
        data_map[j] = _lane_leaf(lane)
    data_map[h.vh_leaf] = b"\x00" + inputs.next_header_validators_hash_leaf
    data_map[h.cid_leaf] = b"\x00" + inputs.next_header_chain_id_leaf
    data_map[h.h_leaf] = b"\x00" + inputs.next_header_height_leaf
    data_map[h.lbi_leaf] = b"\x00" + inputs.next_header_last_block_id_leaf
    data_map[h.pnvh_leaf] = b"\x00" + inputs.prev_header_next_validators_hash_leaf
    aunt_map = _aunt_map_for(
        plan,
        [
            (h.vh_leaf + 1, inputs.next_header_validators_hash_proof.aunts),
            (h.cid_leaf + 1, inputs.next_header_chain_id_proof.aunts),
            (h.h_leaf + 1, inputs.next_header_height_proof.aunts),
            (h.lbi_leaf + 1, inputs.next_header_last_block_id_proof.aunts),
            (
                h.pnvh_leaf + 1,
                inputs.prev_header_next_validators_hash_proof.aunts,
            ),
        ],
    )
    air, trace, publics = plan_statement(plan, data_map, aunt_map, min_segments, device)
    return air, trace, publics, nb


def prove_step_hashes(
    inputs,
    config: StarkConfig = DEFAULT_HASH_CONFIG,
    transcript_seed: list[int] | None = None,
    *,
    device,
) -> HashBundle:
    """inputs: fetcher.StepInputs; the proof's device work runs on
    `device`."""
    air, trace, publics, nb = step_hash_statement(inputs, device=device)
    return _bundle("step", air, trace, publics, config, transcript_seed, nb, 0)


def _verified(bundle: HashBundle, kind: str, config: StarkConfig, transcript_seed) -> bool:
    """The bundle is of `kind`, its row count matches its segments, and its
    STARK verifies."""
    if bundle.kind != kind or bundle.n_segments < 1:
        return False
    if bundle.n_segments * SEGMENT_ROWS != bundle.proof.n_rows:
        return False
    return verify(Sha256Air(bundle.n_segments), bundle.proof, config, transcript_seed=transcript_seed)


@dataclass
class SkipHashFacts:
    """What a verified skip HashBundle establishes (all extracted from
    PROVEN public inputs, bound transitively into the two header hashes)."""

    target_encodings: list[bytes]  # SimpleValidator encodings, len nb
    trusted_encodings: list[bytes]
    target_validators_hash: bytes
    trusted_validators_hash: bytes


def verify_skip_hashes(
    bundle: HashBundle,
    chain_id: str,
    trusted_header: bytes,
    target_header: bytes,
    target_height: int,
    config: StarkConfig = DEFAULT_HASH_CONFIG,
    transcript_seed: list[int] | None = None,
) -> SkipHashFacts | None:
    """The facts a skip bundle proves, or None when it does not verify or
    binds another statement."""
    if not _verified(bundle, "skip", config, transcript_seed):
        return None
    return check_skip_hash_publics(
        bundle.proof.public_inputs, bundle.n_segments, bundle.nb,
        bundle.nb_trusted, chain_id, trusted_header, target_header,
        target_height,
    )


def check_skip_hash_publics(
    publics: list[int],
    n_segments: int,
    nb: int,
    nb_trusted: int,
    chain_id: str,
    trusted_header: bytes,
    target_header: bytes,
    target_height: int,
) -> SkipHashFacts | None:
    """Statement bindings over the (STARK-verified) hash publics — the
    caller must have verified the Sha256Air proof covering `publics`."""
    if nb < 1 or nb_trusted < 1:
        return None
    plan, h = build_skip_plan(nb, nb_trusted)
    res = check_plan(plan, publics, n_segments)
    if res is None:
        return None
    # statement bindings (pure equality over proven publics)
    if res.data[h.vh_leaf] != _hash_leaf(res.digests[h.target_root]):
        return None
    if res.digests[h.vh_root] != target_header:
        return None
    if res.data[h.cid_leaf] != _chain_id_leaf(chain_id):
        return None
    if res.digests[h.cid_root] != target_header:
        return None
    if res.data[h.h_leaf] != _height_leaf(target_height):
        return None
    if res.digests[h.h_root] != target_header:
        return None
    if res.data[h.tvh_leaf] != _hash_leaf(res.digests[h.trusted_root]):
        return None
    if res.digests[h.tvh_root] != trusted_header:
        return None
    encs = []
    for j in h.target_leaves:
        d = res.data[j]
        if not d or d[0] != 0x00:
            return None
        encs.append(d[1:])
    tencs = []
    for j in h.trusted_leaves:
        d = res.data[j]
        if not d or d[0] != 0x00:
            return None
        tencs.append(d[1:])
    return SkipHashFacts(
        target_encodings=encs,
        trusted_encodings=tencs,
        target_validators_hash=res.digests[h.target_root],
        trusted_validators_hash=res.digests[h.trusted_root],
    )


@dataclass
class StepHashFacts:
    encodings: list[bytes]  # new-set SimpleValidator encodings
    validators_hash: bytes


def verify_step_hashes(
    bundle: HashBundle,
    chain_id: str,
    prev_header: bytes,
    next_header: bytes,
    next_height: int,
    config: StarkConfig = DEFAULT_HASH_CONFIG,
    transcript_seed: list[int] | None = None,
) -> StepHashFacts | None:
    """The facts a step bundle proves, or None when it does not verify or
    binds another statement."""
    if not _verified(bundle, "step", config, transcript_seed):
        return None
    return check_step_hash_publics(
        bundle.proof.public_inputs, bundle.n_segments, bundle.nb, chain_id,
        prev_header, next_header, next_height,
    )


def check_step_hash_publics(
    publics: list[int],
    n_segments: int,
    nb: int,
    chain_id: str,
    prev_header: bytes,
    next_header: bytes,
    next_height: int,
) -> StepHashFacts | None:
    """Statement bindings over the (STARK-verified) hash publics."""
    if nb < 1:
        return None
    plan, h = build_step_plan(nb)
    res = check_plan(plan, publics, n_segments)
    if res is None:
        return None
    if res.data[h.vh_leaf] != _hash_leaf(res.digests[h.root]):
        return None
    if res.digests[h.vh_root] != next_header:
        return None
    if res.data[h.cid_leaf] != _chain_id_leaf(chain_id):
        return None
    if res.digests[h.cid_root] != next_header:
        return None
    if res.data[h.h_leaf] != _height_leaf(next_height):
        return None
    if res.digests[h.h_root] != next_header:
        return None
    # previous-header link: the LAST_BLOCK_ID leaf embeds the prev hash at
    # bytes 3..35 (0x00 prefix + 2-byte protobuf framing; reference
    # verify.rs:137-154)
    lbi = res.data[h.lbi_leaf]
    if len(lbi) != 73 or lbi[3:35] != prev_header:
        return None
    if res.digests[h.lbi_root] != next_header:
        return None
    # validator-set link: prev header's NEXT_VALIDATORS_HASH == new set root
    # (reference verify.rs:156-178)
    if res.data[h.pnvh_leaf] != _hash_leaf(res.digests[h.root]):
        return None
    if res.digests[h.pnvh_root] != prev_header:
        return None
    encs = []
    for j in h.leaves:
        d = res.data[j]
        if not d or d[0] != 0x00:
            return None
        encs.append(d[1:])
    return StepHashFacts(encodings=encs, validators_hash=res.digests[h.root])
