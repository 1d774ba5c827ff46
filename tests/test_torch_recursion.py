"""The port's recursion wrap (stark/recursion.py) against the JAX package:
the WrapAir layout constants, the partial-round affine table, the
permutation-state expansion, and a toy two-statement batch wrapped by both
packages, which must serialize byte-identically and cross-verify. Exact
equality throughout: every value is a field element."""

import copy
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import recursion as jrec
from tendermintx_tpu.stark.batch import prove_batch as j_prove_batch
from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig
from tendermintx_tpu.stark.serialize import wrapped_batch_from_dict as j_wrapped_from_dict
from tendermintx_tpu.stark.serialize import wrapped_batch_to_dict as j_wrapped_to_dict
from tendermintx_tpu_torch.ops import poseidon as ps
from tendermintx_tpu_torch.ops.goldilocks import GF, P, tensor_from_u64
from tendermintx_tpu_torch.stark import recursion as rec
from tendermintx_tpu_torch.stark.air import Air
from tendermintx_tpu_torch.stark.batch import prove_batch, verify_batch
from tendermintx_tpu_torch.stark.prover import StarkConfig
from tendermintx_tpu_torch.stark.serialize import _pack, wrapped_batch_from_dict, wrapped_batch_to_dict

from test_recursion import MixAir as JMixAir

# the reference's toy configs (tests/test_recursion.py)
CFG = StarkConfig(rate_bits=2, n_queries=4, final_poly_len=8, proof_of_work_bits=4, cap_bits=3)
WRAP_CFG = StarkConfig(rate_bits=3, n_queries=4, final_poly_len=8, proof_of_work_bits=2, cap_bits=2)
JCFG = JStarkConfig(rate_bits=2, n_queries=4, final_poly_len=8, proof_of_work_bits=4, cap_bits=3)
JWRAP_CFG = JStarkConfig(rate_bits=3, n_queries=4, final_poly_len=8, proof_of_work_bits=2, cap_bits=2)
SEED = [11, 22]
EDGES = [0, 1, P - 1, 2**32 - 1, 2**32, 2**32 + 1]


class MixAir(Air):
    """The reference's tiny multiplicative-mix AIR (tests/test_recursion.py)."""

    n_cols = 4
    n_public = 2
    constraint_degree = 3
    frame_offsets = [0, 1]

    def eval_transition(self, frame, alg):
        a, b, c, d = frame.local
        return [
            frame.next[0] - (a * b + c),
            frame.next[1] - b,
            frame.next[2] - (c + d),
            frame.next[3] - d,
        ]

    def eval_first(self, frame, alg):
        return [frame.local[0] - frame.public[0], frame.local[1] - frame.public[1]]


def _mix_cols(n, p0, p1):
    cols = [[p0], [p1], [3], [5]]
    a, b, c, d = p0, p1, 3, 5
    for _ in range(n - 1):
        a, b, c, d = (a * b + c) % P, b, (c + d) % P, d
        for col, v in zip(cols, (a, b, c, d)):
            col.append(v)
    return np.array(cols, dtype=object)


def _toy_inputs():
    return [_mix_cols(64, 2, 3), _mix_cols(128, 4, 9)], [[2, 3], [4, 9]]


def _random_states(n: int) -> np.ndarray:
    rng = np.random.default_rng(20261016)
    st = rng.integers(0, 2**63, size=(n, 12), dtype=np.uint64) * np.uint64(2)
    st += rng.integers(0, 2, size=(n, 12), dtype=np.uint64)
    st[st >= np.uint64(P)] -= np.uint64(P)
    st.reshape(-1)[: len(EDGES)] = np.array(EDGES, dtype=np.uint64)
    return st


@pytest.fixture(scope="module")
def toy():
    """(port base proof, port wrapped proof, JAX wrapped proof)."""
    cols, publics = _toy_inputs()
    airs = [MixAir(), MixAir()]
    base = prove_batch(airs, [GF.from_ints(c) for c in cols], publics, CFG, transcript_seed=SEED)
    assert verify_batch(airs, base, CFG, transcript_seed=SEED)
    wrapped = rec.wrap_batch(airs, base, CFG, transcript_seed=SEED, wrap_config=WRAP_CFG, device="cpu")
    jairs = [JMixAir(), JMixAir()]
    jbase = j_prove_batch(jairs, [JGF.from_ints(c) for c in cols], publics, JCFG, transcript_seed=SEED)
    jwrapped = jrec.wrap_batch(jairs, jbase, JCFG, transcript_seed=SEED, wrap_config=JWRAP_CFG)
    return base, wrapped, jwrapped


def _verify(w, seed=SEED):
    return rec.verify_wrapped_batch([MixAir(), MixAir()], w, CFG, transcript_seed=seed, wrap_config=WRAP_CFG)


def test_layout_and_partial_affine_equal_jax():
    for name in ("COL_IN", "COL_S", "COL_P", "COL_W", "N_PERM_COLS", "A_HH", "A_QQ", "A_FF",
                 "A_SV", "A_SW", "A_FD", "A_ST", "N_FIXED_COLS", "_BASIS", "_KEEP_COLS"):
        assert getattr(rec, name) == getattr(jrec, name), name
    assert rec._pub_names(3) == jrec._pub_names(3)
    assert rec.n_wrap_cols(3) == jrec.n_wrap_cols(3)
    assert rec._partial_affine() == jrec._partial_affine()
    d, jd = rec.default_wrap_config(), jrec.default_wrap_config()
    assert (d.rate_bits, d.n_queries, d.final_poly_len, d.proof_of_work_bits, d.cap_bits) == (
        jd.rate_bits, jd.n_queries, jd.final_poly_len, jd.proof_of_work_bits, jd.cap_bits)
    assert d.fri.security_bits == 100


def test_expand_perm_states_equals_jax_and_permutation():
    states = _random_states(64)
    got = rec.expand_perm_states(GF(tensor_from_u64(states)))
    assert tuple(got.shape) == (106, 64)
    want = jrec.expand_perm_states(JGF.from_ints(states.astype(object))).to_ints()
    assert got.to_ints().tolist() == np.asarray(want).tolist()
    # the last full round applied to w29 gives the permutation's output
    rc, mds_t = ps.plain_params("cpu")
    out = ps.full_round_plain(got.v[94:106].t().contiguous(), rc[29], mds_t)
    host = [ps.permute_ints([int(v) for v in row]) for row in states.tolist()]
    assert out.numpy().view(np.uint64).tolist() == host


def test_wrapped_batch_byte_identical_to_jax(toy):
    _, wrapped, jwrapped = toy
    assert json.dumps(wrapped_batch_to_dict(wrapped)) == json.dumps(j_wrapped_to_dict(jwrapped))


def test_wrapped_batches_cross_verify(toy):
    _, wrapped, jwrapped = toy
    assert _verify(wrapped)
    assert _verify(wrapped_batch_from_dict(j_wrapped_to_dict(jwrapped)))
    back = j_wrapped_from_dict(json.loads(json.dumps(wrapped_batch_to_dict(wrapped))))
    assert jrec.verify_wrapped_batch(
        [JMixAir(), JMixAir()], back, JCFG, transcript_seed=SEED, wrap_config=JWRAP_CFG
    )


def _wrong_seed(w, base):
    return w, [11, 23]


def _tampered_cap(w, base):
    w.statements[0].trace_cap[0][0] ^= 1
    return w, SEED


def _tampered_wrapper_publics(w, base):
    pub = w.wrapper.statements[0].public_inputs
    pub[0] = (pub[0] + 1) % P
    return w, SEED


def _tampered_final_poly(w, base):
    c0, c1 = w.final_poly[0]
    w.final_poly[0] = ((c0 + 1) % P, c1)
    return w, SEED


def _smuggled_openings(w, base):
    w.statements[0].openings = dict(base.statements[0].openings)
    return w, SEED


@pytest.mark.parametrize(
    "tamper",
    [_wrong_seed, _tampered_cap, _tampered_wrapper_publics, _tampered_final_poly, _smuggled_openings],
)
def test_wrap_rejects(toy, tamper):
    base, wrapped, _ = toy
    bad, seed = tamper(copy.deepcopy(wrapped), base)
    assert _verify(bad, seed) is False


def test_wrapped_batch_serialize_roundtrip(toy):
    _, wrapped, _ = toy
    blob = json.dumps(wrapped_batch_to_dict(wrapped))
    d = json.loads(blob)
    assert d["wrapped"] is True
    assert all("public_inputs" not in sd for sd in d["wrapper"]["statements"])
    w2 = wrapped_batch_from_dict(json.loads(blob))
    assert json.dumps(wrapped_batch_to_dict(w2)) == blob
    assert _verify(w2)
    # smuggled openings on the wire are refused at the boundary
    d["statements"][0]["openings"] = [[0, "", "", "", "", "", ""]]
    with pytest.raises(ValueError):
        wrapped_batch_from_dict(d)
    # smuggled wrong wrapper publics parse, then fail the equality check
    d = json.loads(blob)
    d["wrapper"]["statements"][0]["public_inputs"] = _pack([1, 2, 3])
    assert _verify(wrapped_batch_from_dict(d)) is False
