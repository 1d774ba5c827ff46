"""FRI low-degree proof: device folding and commitment, host verification.

Counterpart of ``tendermintx_tpu/stark/fri.py``. Values are in GF(p^2);
each commit-phase layer is Merkle-committed with Poseidon; folding has
arity 2:

    E'(x^2) = (E(x) + E(-x))/2 + beta * (E(x) - E(-x)) / (2x)

with x_{i + N/2} = -x_i on the coset shift*<w_N>, so a fold pairs positions
(i, i + N/2). The transcript runs on the host challenger: caps are fetched
as they are committed (a local card answers in microseconds; the
device-resident transcript, stark/challenger.DeviceChallenger, measured no
end-to-end gain in the commit loops). With ``mesh=`` the folds of the large
layers are row-sharded over a lane mesh (parallel/prover.py).
``fri_prove`` / ``fri_verify`` take one codeword (a single-statement
STARK), ``fri_prove_batch`` / ``fri_verify_batch`` several (the composite
batch).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cache

import numpy as np
import torch

from ..ops import ntt as nttmod
from ..ops import poseidon as ps
from ..ops.ext import GF2, ext_add, ext_mul, ext_sub
from ..ops.goldilocks import GF, MULTIPLICATIVE_GENERATOR, P, tensor_from_u64, to_int_array
from ..ops.merkle import MerkleTree, cap_levels, verify_opening
from .challenger import Challenger


def _caps_well_formed(caps, n: int, cap_bits: int) -> bool:
    """Every layer cap must have exactly 2^min(cap_bits, depth_l) digests
    of 4 elements (layer l's tree has n >> l leaves)."""
    for l, cap in enumerate(caps):
        size = n >> l
        depth = max(size.bit_length() - 1, 0)
        if len(cap) != 1 << min(cap_bits, depth):
            return False
        if any(len(d) != 4 for d in cap):
            return False
    return True


@dataclass
class FriConfig:
    rate_bits: int = 3
    n_queries: int = 32
    final_poly_len: int = 32  # max number of coefficients in the final poly
    proof_of_work_bits: int = 16  # grinding factor
    cap_bits: int = 4  # Merkle cap height (ops/merkle.py)

    @property
    def security_bits(self) -> int:
        return self.rate_bits * self.n_queries + self.proof_of_work_bits


@dataclass
class FriProof:
    layer_caps: list[list[list[int]]]  # Merkle cap (digest list) per layer
    final_poly: list[tuple[int, int]]  # ext coefficients
    # query_rounds[q][layer] = (val_i, val_j, path_i, path_j)
    query_rounds: list[list[tuple]] = field(default_factory=list)
    # prover-side convenience: the sampled layer-0 query indices
    query_indices: list[int] = field(default_factory=list)
    pow_nonce: int = 0


# ---------------------------------------------------------------------------
# Device folding
# ---------------------------------------------------------------------------


@cache
def _inv_x_table(log_n: int, shift: int) -> np.ndarray:
    """(2x_i)^{-1} for i < N/2 on coset shift*<w_N>, as uint64."""
    n = 1 << log_n
    w = nttmod.primitive_root_of_unity(log_n)
    vals = np.empty(n // 2, dtype=np.uint64)
    acc = shift % P
    for i in range(n // 2):
        vals[i] = pow(2 * acc % P, P - 2, P)
        acc = acc * w % P
    return vals


def _fold_layer(evals: GF2, beta: GF2, invx: GF) -> GF2:
    """One arity-2 fold. evals: (N,), beta: (1,) ext scalar, invx =
    (2x_i)^{-1} for i < N/2. Returns (N/2,) evals on the squared domain."""
    half = evals.shape[0] // 2
    e = evals[:half]
    o = evals[half:]
    s = e + o
    d = e - o
    inv2 = pow(2, P - 2, P)
    s_half = GF2(s.c0.cmul(inv2), s.c1.cmul(inv2))
    d_scaled = GF2(d.c0 * invx, d.c1 * invx)
    return s_half + beta * d_scaled


def _sharded_fold(mesh):
    """fold(cur, beta, invx) over the mesh's row shards, the result back
    on the first device, for an even mesh (None otherwise): the
    reference shards only the fold, and only of layers of at least 4D
    values; commitments and small layers stay on one device."""
    if mesh is None or mesh.size < 2 or mesh.size % 2:
        return None
    from ..parallel.prover import sharded_fold_fn

    fold = sharded_fold_fn(mesh)

    def run(cur: GF2, beta: GF2, invx: GF) -> GF2:
        blocks = [GF2(GF(a), GF(b)) for a, b in zip(mesh.split(cur.c0.v), mesh.split(cur.c1.v))]
        out = fold(blocks, invx, beta)
        return GF2(GF(mesh.gather([o.c0.v for o in out])), GF(mesh.gather([o.c1.v for o in out])))

    return run


def _fold(cur: GF2, cur_n: int, beta: GF2, invx: GF, fold_sh, mesh) -> GF2:
    if fold_sh is not None and cur_n >= 4 * mesh.size:
        return fold_sh(cur, beta, invx)
    return _fold_layer(cur, beta, invx)


def _commit_layer(evals: GF2) -> MerkleTree:
    rows = GF.stack([evals.c0, evals.c1], axis=-1)  # (N, 2)
    return MerkleTree.build(rows)


def ext_scalar(v: tuple[int, int], device) -> GF2:
    """A host ext value as a (1,) GF2 on the device."""
    return GF2(GF.full((1,), v[0], device), GF.full((1,), v[1], device))


def _inject(cur: GF2 | None, lam: GF2, F: GF2) -> GF2:
    return lam * F if cur is None else cur + lam * F


# ---------------------------------------------------------------------------
# Batch FRI prover: one layer family over several DEEP codewords
# ---------------------------------------------------------------------------


def batch_entry_order(sizes: list[int]) -> list[int]:
    """Stable descending-size order: the injection order both sides use."""
    return sorted(range(len(sizes)), key=lambda i: -sizes[i])


def _batch_layer_count(sizes: list[int], config: FriConfig) -> int:
    """Committed fold layers: fold until the running size is <= the
    final-poly stop AND every codeword has been injected."""
    stop = config.final_poly_len << config.rate_bits
    smallest = min(sizes)
    cur_n = max(sizes)
    layers = 0
    while cur_n > stop or cur_n > smallest:
        layers += 1
        cur_n //= 2
    return layers


def fri_prove_batch(
    codewords: list[GF2],
    challenger: Challenger,
    config: FriConfig,
    shift: int = MULTIPLICATIVE_GENERATOR,
    *,
    mesh=None,
) -> FriProof:
    """One FRI proof for several DEEP codewords of power-of-two sizes.
    Codeword i of size N_i lives on shift^(N_max/N_i) * <w_{N_i}>, the
    domain the running fold reaches after log2(N_max/N_i) halvings, where
    it is mixed in with a fresh transcript challenge lambda_i. mesh:
    optional LaneMesh (even size) for the row-sharded folds of the large
    layers; the codewords are on its first device."""
    sizes = [int(F.shape[0]) for F in codewords]
    if any(s & (s - 1) for s in sizes):
        raise ValueError("codeword sizes must be powers of two")
    device = codewords[0].device
    fold_sh = _sharded_fold(mesh)
    order = batch_entry_order(sizes)
    n = sizes[order[0]]
    stop = config.final_poly_len << config.rate_bits

    layers: list[GF2] = []
    trees: list[MerkleTree] = []
    caps: list[list[list[int]]] = []
    cur = None
    cur_n = n
    cur_shift = shift % P
    oi = 0
    while True:
        while oi < len(order) and sizes[order[oi]] == cur_n:
            lam = ext_scalar(challenger.sample_ext(), device)
            cur = _inject(cur, lam, codewords[order[oi]])
            oi += 1
        if cur_n <= stop and oi == len(order):
            break
        if cur_n <= 1:
            raise ValueError("codeword sizes inconsistent")
        tree = _commit_layer(cur)
        trees.append(tree)
        layers.append(cur)
        cap = tree.cap(config.cap_bits)
        caps.append(cap)
        challenger.observe_cap(cap)
        beta = ext_scalar(challenger.sample_ext(), device)
        invx = GF(tensor_from_u64(_inv_x_table(cur_n.bit_length() - 1, cur_shift), device))
        cur = _fold(cur, cur_n, beta, invx, fold_sh, mesh)
        cur_shift = cur_shift * cur_shift % P
        cur_n //= 2

    return _finish(
        cur, cur_shift, max(cur_n >> config.rate_bits, 1), layers, trees, caps, n,
        challenger, config,
    )


def _finish(
    cur: GF2, cur_shift: int, keep: int, layers: list[GF2], trees: list[MerkleTree],
    caps: list, n: int, challenger: Challenger, config: FriConfig,
) -> FriProof:
    """After the commit phase: the final polynomial (host iNTT of the
    small last layer, its first `keep` coefficients), grinding, query
    sampling and the query rounds."""
    fin0, fin1 = cur.to_ints()
    final_coeffs = _coset_intt_ext(
        [(int(a), int(b)) for a, b in zip(fin0, fin1)], cur_shift
    )
    if any(c != (0, 0) for c in final_coeffs[keep:]):
        raise RuntimeError("final poly degree too high")
    final_coeffs = final_coeffs[:keep]
    for c in final_coeffs:
        challenger.observe_ext(c)

    pow_seed = challenger.sample()
    pow_nonce = grind(pow_seed, config.proof_of_work_bits, cur.device)
    challenger.observe_element(pow_nonce)

    query_indices = challenger.sample_indices(config.n_queries, n)
    query_rounds = _query_phase(layers, trees, n, query_indices, config.cap_bits)
    return FriProof(
        layer_caps=caps,
        final_poly=final_coeffs,
        query_rounds=query_rounds,
        query_indices=query_indices,
        pow_nonce=pow_nonce,
    )


# ---------------------------------------------------------------------------
# Single-codeword FRI (one statement's DEEP codeword)
# ---------------------------------------------------------------------------


def fri_prove(
    evals: GF2,
    challenger: Challenger,
    config: FriConfig,
    shift: int = MULTIPLICATIVE_GENERATOR,
    *,
    mesh=None,
) -> FriProof:
    """Prove that `evals` (on coset shift*<w_N>, natural order) is the LDE
    of a polynomial of degree < N / 2^rate_bits. Folds on the device of
    `evals`; the transcript is the host challenger. mesh: optional
    LaneMesh (even size) whose row shards fold the layers of at least 4D
    values; `evals` is on its first device. The proof is the same."""
    fold_sh = _sharded_fold(mesh)
    n = int(evals.shape[0])
    if n & (n - 1):
        raise ValueError("codeword size must be a power of two")
    layers: list[GF2] = [evals]
    trees: list[MerkleTree] = []
    caps: list[list[list[int]]] = []
    cur, cur_n, cur_shift = evals, n, shift % P
    # commit phase: fold until the claimed degree fits in final_poly_len
    while cur_n > config.final_poly_len << config.rate_bits:
        tree = _commit_layer(cur)
        trees.append(tree)
        cap = tree.cap(config.cap_bits)
        caps.append(cap)
        challenger.observe_cap(cap)
        beta = ext_scalar(challenger.sample_ext(), cur.device)
        invx = GF(tensor_from_u64(_inv_x_table(cur_n.bit_length() - 1, cur_shift), cur.device))
        cur = _fold(cur, cur_n, beta, invx, fold_sh, mesh)
        cur_shift = cur_shift * cur_shift % P
        cur_n //= 2
        layers.append(cur)
    return _finish(
        cur, cur_shift, cur_n >> config.rate_bits, layers, trees, caps, n, challenger, config
    )


def fri_verify(
    proof: FriProof,
    degree_bound: int,
    n: int,
    challenger: Challenger,
    config: FriConfig,
    shift: int = MULTIPLICATIVE_GENERATOR,
    layer0_check=None,
) -> bool:
    """Verify a FRI proof for evals of size n claiming degree <
    degree_bound. `layer0_check(index, ext_value) -> bool`, when given,
    confirms an opened layer-0 value against an externally recomputed one
    (the DEEP composition in a STARK)."""
    if degree_bound << config.rate_bits != n:
        return False
    n_layers = len(proof.layer_caps)
    cur_n = n
    expected_layers = 0
    while cur_n > config.final_poly_len << config.rate_bits:
        expected_layers += 1
        cur_n //= 2
    if n_layers != expected_layers:
        return False
    if not _caps_well_formed(proof.layer_caps, n, config.cap_bits):
        return False
    if len(proof.final_poly) > (cur_n >> config.rate_bits):
        return False

    betas = []
    for cap in proof.layer_caps:
        challenger.observe_cap(cap)
        betas.append(challenger.sample_ext())
    for c in proof.final_poly:
        challenger.observe_ext(c)
    pow_seed = challenger.sample()
    if not check_grind(pow_seed, proof.pow_nonce, config.proof_of_work_bits):
        return False
    if not 0 <= proof.pow_nonce < P:
        return False
    challenger.observe_element(proof.pow_nonce)
    query_indices = challenger.sample_indices(config.n_queries, n)
    if len(proof.query_rounds) != config.n_queries:
        return False

    if n_layers == 0:
        # no committed layer: the recomputed layer-0 value must equal the
        # final polynomial at the query's domain point
        w = nttmod.primitive_root_of_unity(n.bit_length() - 1)
        for q, per_layer in zip(query_indices, proof.query_rounds):
            if per_layer:
                return False
            pt = shift * pow(w, q, P) % P
            acc = (0, 0)
            for c in reversed(proof.final_poly):
                acc = ext_add(ext_mul(acc, (pt, 0)), tuple(c))
            if layer0_check is not None and not layer0_check(q, acc):
                return False
        return True

    inv2 = pow(2, P - 2, P)
    for q, per_layer in zip(query_indices, proof.query_rounds):
        if len(per_layer) != n_layers:
            return False
        idx = q
        prev_folded = None
        cur_shift = shift % P
        for l, (val_i, val_j, path_i, path_j) in enumerate(per_layer):
            size = n >> l
            half = size // 2
            i = idx % half
            j = i + half
            cap = proof.layer_caps[l]
            lv = cap_levels(size, config.cap_bits)
            val_i = tuple(val_i)
            val_j = tuple(val_j)
            if not verify_opening(cap, i, [val_i[0], val_i[1]], path_i, lv):
                return False
            if not verify_opening(cap, j, [val_j[0], val_j[1]], path_j, lv):
                return False
            value_at_idx = val_i if idx < half else val_j
            if l == 0:
                if layer0_check is not None and not layer0_check(q, value_at_idx):
                    return False
            elif value_at_idx != prev_folded:
                return False
            w = nttmod.primitive_root_of_unity(size.bit_length() - 1)
            x_i = cur_shift * pow(w, i, P) % P
            s = ext_add(val_i, val_j)
            d = ext_sub(val_i, val_j)
            invx = pow(2 * x_i % P, P - 2, P)
            prev_folded = ext_add(
                (s[0] * inv2 % P, s[1] * inv2 % P),
                ext_mul(betas[l], (d[0] * invx % P, d[1] * invx % P)),
            )
            idx = i
            cur_shift = cur_shift * cur_shift % P
        # final layer: the folded value equals final_poly at the domain point
        size = n >> n_layers
        w = nttmod.primitive_root_of_unity(size.bit_length() - 1)
        pt = cur_shift * pow(w, idx, P) % P
        acc = (0, 0)
        for c in reversed(proof.final_poly):
            acc = ext_add(ext_mul(acc, (pt, 0)), tuple(c))
        if acc != prev_folded:
            return False
    return True


def _query_phase(
    layers: list[GF2], trees: list[MerkleTree], n: int, query_indices, cap_bits: int
) -> list[list[tuple]]:
    """Per query per committed layer: the (i, i + N/2) value pair and both
    sibling paths, gathered on the device and fetched together."""
    idx_chain = list(query_indices)
    layer_data = []
    for l, tree in enumerate(trees):
        half = (n >> l) // 2
        i_list = [x % half for x in idx_chain]
        j_list = [i + half for i in i_list]
        both = torch.tensor(i_list + j_list, device=layers[l].device)
        c0 = to_int_array(layers[l].c0.v.index_select(0, both))
        c1 = to_int_array(layers[l].c1.v.index_select(0, both))
        sib, uniq, n_inner = tree.sibling_gather(i_list + j_list, cap_bits)
        paths = MerkleTree.decode_paths(to_int_array(sib.v), uniq, n_inner)
        layer_data.append((i_list, j_list, c0, c1, paths))
        idx_chain = i_list
    query_rounds = []
    for qi in range(len(query_indices)):
        per_layer = []
        for i_list, j_list, c0, c1, paths in layer_data:
            nq = len(i_list)
            per_layer.append(
                (
                    (int(c0[qi]), int(c1[qi])),
                    (int(c0[nq + qi]), int(c1[nq + qi])),
                    paths[i_list[qi]],
                    paths[j_list[qi]],
                )
            )
        query_rounds.append(per_layer)
    return query_rounds


# ---------------------------------------------------------------------------
# Batch FRI verifier (host)
# ---------------------------------------------------------------------------


def fri_replay_batch(proof: FriProof, sizes: list[int], challenger: Challenger, config: FriConfig):
    """Transcript replay plus structural and grinding checks for a batch
    FRI proof (everything except the per-query opening walk). Returns
    (lambdas, entry_layer, betas, query_indices, n_layers) or None."""
    if not sizes:
        return None
    if any(s < 1 or s & (s - 1) for s in sizes):
        return None
    order = batch_entry_order(sizes)
    n = sizes[order[0]]
    n_layers = _batch_layer_count(sizes, config)
    if len(proof.layer_caps) != n_layers:
        return None
    if not _caps_well_formed(proof.layer_caps, n, config.cap_bits):
        return None
    final_n = n >> n_layers
    if len(proof.final_poly) > max(final_n >> config.rate_bits, 1):
        return None

    lambdas: list[tuple[int, int] | None] = [None] * len(sizes)
    entry_layer: dict[int, list[int]] = {}
    betas = []
    oi = 0
    cur_n = n
    for l in range(n_layers + 1):
        while oi < len(order) and sizes[order[oi]] == cur_n:
            si = order[oi]
            lambdas[si] = challenger.sample_ext()
            entry_layer.setdefault(l, []).append(si)
            oi += 1
        if l < n_layers:
            challenger.observe_cap(proof.layer_caps[l])
            betas.append(challenger.sample_ext())
            cur_n //= 2
    if oi != len(order):
        return None
    for c in proof.final_poly:
        challenger.observe_ext(tuple(c))
    pow_seed = challenger.sample()
    if not check_grind(pow_seed, proof.pow_nonce, config.proof_of_work_bits):
        return None
    if not 0 <= proof.pow_nonce < P:
        return None
    challenger.observe_element(proof.pow_nonce)
    query_indices = challenger.sample_indices(config.n_queries, n)
    return lambdas, entry_layer, betas, query_indices, n_layers


def fri_verify_batch(
    proof: FriProof,
    sizes: list[int],
    eval_fns: list,
    challenger: Challenger,
    config: FriConfig,
    shift: int = MULTIPLICATIVE_GENERATOR,
) -> bool:
    """Verify a batch FRI proof. eval_fns[i](idx) -> ext tuple | None
    recomputes codeword i's value at leaf idx of its domain from the
    statement's Merkle-verified openings."""
    if len(sizes) != len(eval_fns):
        return False
    replay = fri_replay_batch(proof, sizes, challenger, config)
    if replay is None:
        return False
    lambdas, entry_layer, betas, query_indices, n_layers = replay
    n = max(sizes)
    if len(proof.query_rounds) != config.n_queries:
        return False

    inv2 = pow(2, P - 2, P)
    for q, per_layer in zip(query_indices, proof.query_rounds):
        if len(per_layer) != n_layers:
            return False
        idx = q
        prev_folded = None
        cur_shift = shift % P
        for l, (val_i, val_j, path_i, path_j) in enumerate(per_layer):
            size = n >> l
            half = size // 2
            i = idx % half
            j = i + half
            cap = proof.layer_caps[l]
            lv = cap_levels(size, config.cap_bits)
            val_i = tuple(val_i)
            val_j = tuple(val_j)
            if not verify_opening(cap, i, [val_i[0], val_i[1]], path_i, lv):
                return False
            if not verify_opening(cap, j, [val_j[0], val_j[1]], path_j, lv):
                return False
            expected = prev_folded if prev_folded is not None else (0, 0)
            for si in entry_layer.get(l, ()):
                v = eval_fns[si](idx)
                if v is None:
                    return False
                expected = ext_add(expected, ext_mul(lambdas[si], tuple(v)))
            value_at_idx = val_i if idx < half else val_j
            if value_at_idx != expected:
                return False
            w = nttmod.primitive_root_of_unity(size.bit_length() - 1)
            x_i = cur_shift * pow(w, i, P) % P
            s = ext_add(val_i, val_j)
            d = ext_sub(val_i, val_j)
            invx = pow(2 * x_i % P, P - 2, P)
            prev_folded = ext_add(
                (s[0] * inv2 % P, s[1] * inv2 % P),
                ext_mul(betas[l], (d[0] * invx % P, d[1] * invx % P)),
            )
            idx = i
            cur_shift = cur_shift * cur_shift % P
        # final layer: folded value (plus final-size injections) must equal
        # the final polynomial at the domain point
        size = n >> n_layers
        expected = prev_folded if prev_folded is not None else (0, 0)
        for si in entry_layer.get(n_layers, ()):
            v = eval_fns[si](idx)
            if v is None:
                return False
            expected = ext_add(expected, ext_mul(lambdas[si], tuple(v)))
        w = nttmod.primitive_root_of_unity(size.bit_length() - 1)
        pt = cur_shift * pow(w, idx, P) % P
        acc = (0, 0)
        for c in reversed(proof.final_poly):
            acc = ext_add(ext_mul(acc, (pt, 0)), tuple(c))
        if acc != expected:
            return False
    return True


# ---------------------------------------------------------------------------
# Grinding
# ---------------------------------------------------------------------------

GRIND_BATCH = 1 << 18  # ~4x the expected 2^16 search of the default config


def grind(seed: int, pow_bits: int, device=None) -> int:
    """The smallest nonce with poseidon([seed, nonce, 0, ...])[0] having
    `pow_bits` low zero bits (the hash_ints([seed, nonce]) the verifier
    checks). On a CUDA device candidates are searched in batches through
    the Poseidon kernel; otherwise on the host, nonce by nonce."""
    if pow_bits == 0:
        return 0
    if not 0 < pow_bits <= 32:
        raise ValueError("pow_bits must be in 1..32")
    mask = (1 << pow_bits) - 1
    if device is None or torch.device(device).type != "cuda":
        nonce = 0
        while True:
            if ps.hash_ints([seed, nonce])[0] & mask == 0:
                return nonce
            nonce += 1
    state = torch.zeros((GRIND_BATCH, ps.WIDTH), dtype=torch.int64, device=device)
    state[:, 0] = GF.full((), seed, device).v
    offsets = torch.arange(GRIND_BATCH, dtype=torch.int64, device=device)
    start = 0
    while start < 1 << 32:
        state[:, 1] = offsets + start
        out = ps.permute_tensor(state)
        hits = torch.nonzero((out[:, 0] & mask) == 0)
        if hits.numel():
            return start + int(hits[0, 0])
        start += GRIND_BATCH
    raise RuntimeError("grinding failed")


def check_grind(seed: int, nonce: int, pow_bits: int) -> bool:
    if pow_bits == 0:
        return True
    return ps.hash_ints([seed, nonce])[0] & ((1 << pow_bits) - 1) == 0


def _coset_intt_ext(evals: list[tuple[int, int]], shift: int) -> list[tuple[int, int]]:
    """Host inverse NTT of ext values on coset shift*<w_n> -> coefficients."""
    n = len(evals)
    c0 = _intt_ints([e[0] for e in evals])
    c1 = _intt_ints([e[1] for e in evals])
    sinv = pow(shift, P - 2, P)
    out = []
    acc = 1
    for k in range(n):
        out.append((c0[k] * acc % P, c1[k] * acc % P))
        acc = acc * sinv % P
    return out


def _intt_ints(evals: list[int]) -> list[int]:
    n = len(evals)
    if n == 1:
        return list(evals)
    w_inv = pow(nttmod.primitive_root_of_unity(n.bit_length() - 1), P - 2, P)
    out = _ntt_with_root([e % P for e in evals], w_inv)
    ninv = pow(n, P - 2, P)
    return [x * ninv % P for x in out]


def _ntt_with_root(coeffs: list[int], w: int) -> list[int]:
    n = len(coeffs)
    if n == 1:
        return list(coeffs)
    w2 = w * w % P
    even = _ntt_with_root(coeffs[0::2], w2)
    odd = _ntt_with_root(coeffs[1::2], w2)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % P
        out[k] = (even[k] + t) % P
        out[k + n // 2] = (even[k] - t) % P
        wk = wk * w % P
    return out
