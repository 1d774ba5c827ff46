"""The port's witness-verification programs against the JAX package.

SHA-256/512, the Ed25519 limb field, ladder and witness binding, the
message checks, the packed witnesses and the whole step/skip programs run
on the same seeded inputs in both packages; results must be equal (exact:
integer programs have no tolerance). Field results are compared as
canonical integers: the port keeps limbs bounded rather than normalised
inside the ladder (ops/ed25519.py), so only the canonical values are
defined to agree."""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.circuits import gadgets as jg
from tendermintx_tpu.circuits import proving as jproving
from tendermintx_tpu.circuits import variables as jvars
from tendermintx_tpu.circuits import verify as jverify
from tendermintx_tpu.inputs.conversion import get_validator_data_from_block as j_lanes_of
from tendermintx_tpu.inputs.fetcher import InputDataFetcher as JFetcher
from tendermintx_tpu.inputs.fetcher import InputDataMode as JMode
from tendermintx_tpu.inputs.testchain import TestChain as JTestChain
from tendermintx_tpu.ops import ed25519 as jed
from tendermintx_tpu.ops import sha256 as jsha256
from tendermintx_tpu.ops import sha512 as jsha512
from tendermintx_tpu.stark.prover import StarkConfig as JStarkConfig
from tendermintx_tpu_torch.circuits import gadgets as g
from tendermintx_tpu_torch.circuits import proving
from tendermintx_tpu_torch.circuits import variables as tvars
from tendermintx_tpu_torch.circuits import verify as tverify
from tendermintx_tpu_torch.circuits.config import TendermintConfig
from tendermintx_tpu_torch.circuits.skip import SkipCircuit, encode_skip_input
from tendermintx_tpu_torch.inputs.conversion import get_validator_data_from_block
from tendermintx_tpu_torch.inputs.fetcher import InputDataFetcher, InputDataMode
from tendermintx_tpu_torch.inputs.testchain import TestChain
from tendermintx_tpu_torch.ops import ed25519 as ed
from tendermintx_tpu_torch.ops import sha256, sha512
from tendermintx_tpu_torch.stark.prover import StarkConfig

P = ed.P25519
CHAIN_ID = "test-chain"
SKIP_MAX = 100_800
CFG = StarkConfig(rate_bits=2, n_queries=8, final_poly_len=8)
JCFG = JStarkConfig(rate_bits=2, n_queries=8, final_poly_len=8)


def _t(x) -> torch.Tensor:
    """A JAX array or numpy array as a torch tensor (uint32 -> int64)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# SHA-256 / SHA-512
# ---------------------------------------------------------------------------


def _messages(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in (0, 1, 55, 56, 64, 111, 112, 119, 200, 250)]


def test_sha256_matches_hashlib_and_jax_ragged():
    msgs = _messages(1)
    blocks, n_active = jsha256.pad_messages(msgs, n_blocks=5)  # ragged n_active
    want = jsha256.sha256_blocks_jit(blocks, n_active)
    got = sha256.sha256_blocks(_t(blocks), _t(n_active))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert sha256.digests_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]
    assert sha256.sha256_many(msgs, device="cpu") == [hashlib.sha256(m).digest() for m in msgs]


def test_sha512_matches_hashlib_and_jax_ragged():
    msgs = _messages(2)
    lo, hi, n_active = jsha512.pad_messages(msgs, n_blocks=4)
    j_lo, j_hi = jsha512.sha512_blocks_jit(lo, hi, n_active)
    words = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    got = sha512.sha512_blocks(torch.from_numpy(words.view(np.int64).copy()), _t(n_active))
    want = (np.asarray(j_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(j_lo).astype(np.uint64)
    assert np.array_equal(got.numpy().view(np.uint64), want)
    assert sha512.digests_to_bytes(got) == [hashlib.sha512(m).digest() for m in msgs]
    assert sha512.sha512_many(msgs, device="cpu") == [hashlib.sha512(m).digest() for m in msgs]


def test_sha512_bytes_var_matches_jax():
    msgs = _messages(3)[:8]
    data = np.zeros((len(msgs), 250), dtype=np.uint8)
    for i, m in enumerate(msgs):
        data[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
    lens = np.array([len(m) for m in msgs], dtype=np.uint32)
    j_lo, j_hi = jsha512.sha512_bytes_var(jnp.asarray(data), jnp.asarray(lens), 3)
    want = np.asarray(jsha512.digest_words_to_bytes_dev(j_lo, j_hi))
    got = sha512.digest_words_to_bytes_dev(sha512.sha512_bytes_var(torch.from_numpy(data), _t(lens), 3))
    assert np.array_equal(got.numpy(), want)
    assert [bytes(r) for r in want] == [hashlib.sha512(m).digest() for m in msgs]


# ---------------------------------------------------------------------------
# The Ed25519 limb field
# ---------------------------------------------------------------------------

_EDGE_VALUES = [0, 1, 2, P - 1, P - 2, 2**255 - 1, 2**254, 19, 2**13 - 1]


def _field_operands(seed: int, n: int = 24) -> np.ndarray:
    """(n, 20) carried 13-bit limbs: edge values, all-8191 limbs, random."""
    rng = np.random.default_rng(seed)
    rows = [ed.int_to_limbs(v) for v in _EDGE_VALUES]
    rows.append(np.full(20, 8191, dtype=np.uint32))  # 2^260 - 1: above p, carried
    while len(rows) < n:
        rows.append(rng.integers(0, 8192, 20, dtype=np.uint32))
    return np.stack(rows)


def _canon_ints(limbs) -> list[int]:
    return [ed.limbs_to_int(r) for r in np.asarray(limbs).reshape(-1, 20)]


@pytest.mark.parametrize("op", ["fadd", "fsub", "fmul", "fsquare"])
def test_limb_field_matches_jax(op):
    a = _field_operands(10)
    b = _field_operands(11)[::-1].copy()
    args = (a,) if op == "fsquare" else (a, b)
    jfn = jax.jit(lambda *xs: jed.to_canonical(getattr(jed, op)(*xs)))
    want = _canon_ints(jfn(*(jnp.asarray(x) for x in args)))
    got_raw = getattr(ed, op)(*(_t(x) for x in args))
    got = _canon_ints(ed.to_canonical(got_raw).numpy())
    assert got == want
    ia, ib = _canon_ints(a), _canon_ints(b)
    ref = {
        "fadd": [(x + y) % P for x, y in zip(ia, ib)],
        "fsub": [(x - y) % P for x, y in zip(ia, ib)],
        "fmul": [(x * y) % P for x, y in zip(ia, ib)],
        "fsquare": [(x * x) % P for x in ia],
    }[op]
    assert got == ref
    assert int(got_raw.max()) <= ed.LAZY_LIMB_BOUND


def test_feq_and_to_canonical_match_jax():
    a = _field_operands(12)
    b = a.copy()
    b[::2] = _field_operands(13)[::-1][::2]
    b[0] = ed.int_to_limbs(5)
    # equal values in different limb forms: x and x + p
    b[1] = ed.int_to_limbs(ed.limbs_to_int(a[1]) % P + P)
    want = np.asarray(jax.jit(jed.feq)(jnp.asarray(a), jnp.asarray(b)))
    got = ed.feq(_t(a), _t(b)).numpy()
    assert got.tolist() == want.tolist()
    assert got.tolist() == [(x - y) % P == 0 for x, y in zip(_canon_ints(a), _canon_ints(b))]
    assert got[1] and got[3] and not got[0]
    canon = ed.to_canonical(_t(a)).numpy()
    assert _canon_ints(canon) == _canon_ints(np.asarray(jax.jit(jed.to_canonical)(jnp.asarray(a))))
    assert all(v < P for v in _canon_ints(canon))


def test_lazy_limb_bound_holds():
    """Interval arithmetic over limb upper bounds: from inputs <= 9215 the
    carry passes of a product, a sum and a padded difference bring every
    limb back to <= 9215, so the ladder never overflows or drifts; the
    same holds on the worst-case operands."""
    bound = ed.LAZY_LIMB_BOUND

    def passes(hi, n):
        for _ in range(n):
            c = [h >> 13 for h in hi]
            hi = [8191 + (608 * c[19] if i == 0 else c[i - 1]) for i in range(20)]
        return hi

    acc = [min(k + 1, 39 - k) * bound * bound for k in range(40)]
    acc[39] = 0
    folded = [acc[i] + 608 * acc[20 + i] for i in range(20)]
    assert max(folded) < 2**62
    assert max(passes(folded, ed._PASSES_MUL)) <= bound
    assert max(passes([2 * bound] * 20, ed._PASSES_ADD)) <= bound
    assert min(ed._SUB_PAD) > bound  # a + pad - b stays non-negative
    assert max(passes([bound + v for v in ed._SUB_PAD], ed._PASSES_ADD)) <= bound
    worst = torch.full((3, 20), bound, dtype=torch.int64)
    v = ed.limbs_to_int([bound] * 20)
    for op, ref in ((ed.fmul, v * v), (ed.fadd, 2 * v), (ed.fsub, 0)):
        out = op(worst, worst)
        assert int(out.max()) <= bound and int(out.min()) >= 0
        assert _canon_ints(ed.to_canonical(out).numpy())[0] == ref % P


# ---------------------------------------------------------------------------
# Ladder and witness binding
# ---------------------------------------------------------------------------


def _signature_lanes(n_validators: int = 6, lanes: int = 8):
    chain = JTestChain(n_validators=n_validators)
    h = chain.extend()
    vals = j_lanes_of(chain.val_set, chain.commits[h], chain.chain_id, lanes)
    from tendermintx_tpu.inputs.conversion import signature_lanes

    return signature_lanes(vals)


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1 :]


def _decodable(pt: bytes) -> bytes:
    """A valid point encoding near pt (flip low y bits until it decodes)."""
    for i in range(1, 64):
        cand = _flip(pt, i % 31)
        if ed.decompress(cand) is not None:
            return cand
        pt = cand
    raise AssertionError("no decodable point found")


@pytest.fixture(scope="module")
def ladder_inputs():
    """8 lanes: 4 honest, then tampered R, S, message and pubkey."""
    pks, msgs, sigs = (list(x) for x in _signature_lanes())
    sigs[4] = _decodable(sigs[4][:32]) + sigs[4][32:]
    sigs[5] = sigs[5][:32] + _flip(sigs[5], 40)[32:]
    msgs[6] = _flip(msgs[6], 30)
    pks[7] = _decodable(pks[7])
    args = jed.prepare_batch(pks, msgs, sigs)
    binding = jed.prepare_binding(pks, msgs, sigs)
    m = np.zeros((8, 124), dtype=np.uint8)
    for i, msg in enumerate(msgs):
        m[i, : len(msg)] = np.frombuffer(msg, dtype=np.uint8)
    mlen = np.array([len(x) for x in msgs], dtype=np.uint32)
    return pks, msgs, sigs, [np.asarray(a) for a in args], [np.asarray(a) for a in binding], m, mlen


def test_straus_verify_matches_jax(ladder_inputs):
    pks, msgs, sigs, args, _, _, _ = ladder_inputs
    want = np.asarray(jed.straus_verify_jit(*(jnp.asarray(a) for a in args)))
    got = ed.straus_verify(*(_t(a) for a in args)).numpy()
    assert got.tolist() == want.tolist() == [True] * 4 + [False] * 4
    assert got.tolist() == [ed.verify_ints(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert ed.verify_batch(pks, msgs, sigs, device="cpu").tolist() == got.tolist()


def test_verify_bound_matches_jax_incl_tampered_witness(ladder_inputs):
    _, _, _, args, binding, m, mlen = ladder_inputs
    args = [a.copy() for a in args]
    binding = [b.copy() for b in binding]
    # witness-only tampering on honest lanes: the bytes are right, but a
    # scalar bit (lane 0), the mod-L quotient (lane 1), a table entry
    # (lane 2) and R's parity (lane 3) are not the ones they derive
    args[3][0, 100] ^= 1
    binding[3][1, 0] ^= 1
    args[0][2, 3, 5] ^= 1
    args[4][3] = ed.int_to_limbs((P - ed.limbs_to_int(args[4][3])) % P)
    fn = jax.jit(jed.verify_bound)
    want = np.asarray(fn(*(jnp.asarray(a) for a in args), *(jnp.asarray(b) for b in binding[:3]),
                         jnp.asarray(m), jnp.asarray(mlen), jnp.asarray(binding[3])))
    got = ed.verify_bound(*(_t(a) for a in args), *(_t(b) for b in binding[:3]),
                          torch.from_numpy(m), _t(mlen), _t(binding[3])).numpy()
    assert got.tolist() == want.tolist() == [False] * 8


def test_verify_batch_bound_accepts_and_rejects(ladder_inputs):
    pks, msgs, sigs, _, _, _, _ = ladder_inputs
    got = ed.verify_batch_bound(pks, msgs, sigs, device="cpu")
    assert got.tolist() == [True] * 4 + [False] * 4


# ---------------------------------------------------------------------------
# Gadgets: the message checks (the cases of tests/test_gadgets.py)
# ---------------------------------------------------------------------------


def _msg_case(case: str):
    chain = TestChain(n_validators=2)
    h = chain.extend(round=5)
    lanes = get_validator_data_from_block(chain.val_set, chain.commits[h], chain.chain_id, 2)
    msgs = np.stack([np.frombuffer(l.message, dtype=np.uint8) for l in lanes]).copy()
    mlen = np.array([l.message_byte_length for l in lanes], dtype=np.uint32)
    signed = np.array([l.signed for l in lanes])
    hh = np.frombuffer(chain.headers[h].hash(), dtype=np.uint8)
    if case == "high_round_word":
        msgs[0, 17] = 1  # adds 2^32 to the encoded round
    elif case == "negative_round":
        neg = (1 << 64) - (1 << 32) + 5
        for i in range(8):
            msgs[0, 13 + i] = (neg >> (8 * i)) & 0xFF
    elif case == "unsigned_hash_window":
        mlen[0] = 40  # < 25 + 32: the hash bytes lie outside the signed prefix
    return msgs, mlen, signed, chain.commits[h].round, (h & 0xFFFFFFFF, h >> 32), hh


@pytest.mark.parametrize(
    "case, expected",
    [
        ("valid", [True, True]),
        ("high_round_word", [False, True]),
        ("negative_round", [False, True]),
        ("unsigned_hash_window", [False, True]),
    ],
)
def test_message_checks_match_jax(case, expected):
    msgs, mlen, signed, rnd, (lo, hi), hh = _msg_case(case)
    got = g.message_checks(
        torch.from_numpy(msgs), _t(mlen), torch.from_numpy(signed), rnd, (lo, hi), torch.from_numpy(hh.copy())
    ).tolist()
    want = np.asarray(
        jg.message_checks(
            jnp.asarray(msgs), jnp.asarray(mlen), jnp.asarray(signed), jnp.uint32(rnd),
            (jnp.uint32(lo), jnp.uint32(hi)), jnp.asarray(hh),
        )
    ).tolist()
    assert got == want == expected


# ---------------------------------------------------------------------------
# Packed witnesses and the step/skip programs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Two chains written as fixtures in both packages' format (the
    inputs modules are copies): a healthy one, and one where only half
    of the voting power signs."""
    out = {}
    for name, kwargs, signers in (
        ("good", dict(n_validators=6), None),
        ("weak", dict(n_validators=8, powers=[10] * 8), [0, 1, 2, 4]),
    ):
        tmp = str(tmp_path_factory.mktemp(name))
        chain = TestChain(chain_id=CHAIN_ID, **kwargs)
        for _ in range(5):
            chain.extend(signers=signers) if signers else chain.extend()
        chain.write_fixtures(tmp)
        out[name] = (
            chain,
            InputDataFetcher(fixture_path=tmp, mode=InputDataMode.FIXTURE),
            JFetcher(fixture_path=tmp, mode=JMode.FIXTURE),
        )
    return out


def _assert_same_fields(port, ref, path=""):
    for name in port.__dataclass_fields__:
        a, b = getattr(port, name), getattr(ref, name)
        if hasattr(a, "__dataclass_fields__"):
            _assert_same_fields(a, b, f"{path}{name}.")
            continue
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, f"{path}{name}"
        assert np.array_equal(a.numpy().astype(np.int64), b.astype(np.int64)), f"{path}{name}"


def test_packed_step_witness_equals_jax(fixtures):
    chain, f, jf = fixtures["good"]
    h = chain.headers[2].hash()
    port = tvars.pack_step_witness(f.get_step_inputs(2, h, 8))
    ref = jvars.pack_step_witness(jf.get_step_inputs(2, h, 8))
    _assert_same_fields(port, ref)


def test_packed_skip_witness_equals_jax(fixtures):
    chain, f, jf = fixtures["good"]
    h = chain.headers[1].hash()
    port = tvars.pack_skip_witness(f.get_skip_inputs(1, h, 5, 8))
    ref = jvars.pack_skip_witness(jf.get_skip_inputs(1, h, 5, 8))
    _assert_same_fields(port, ref)


def _u8(b: bytes):
    return np.frombuffer(b, dtype=np.uint8)


def _step_both(f, jf, prev: int, prev_hash: bytes, claimed_hash: bytes, chain_id: str):
    """(valid, header) of the port's and the JAX step program."""
    cl, cn = tverify.chain_id_leaf_const(chain_id)
    jcl, jcn = jverify.chain_id_leaf_const(chain_id)
    valid, out = tverify.step_verify(
        tvars.pack_step_witness(f.get_step_inputs(prev, prev_hash, 8)),
        torch.from_numpy(_u8(claimed_hash).copy()), prev & 0xFFFFFFFF, prev >> 32, cl, cn,
    )
    jvalid, jout = jverify.step_verify_jit(
        jvars.pack_step_witness(jf.get_step_inputs(prev, prev_hash, 8)),
        jnp.asarray(_u8(claimed_hash)), jnp.uint32(prev & 0xFFFFFFFF), jnp.uint32(prev >> 32), jcl, jcn,
    )
    return (bool(valid), bytes(out.numpy())), (bool(jvalid), bytes(np.asarray(jout)))


def _skip_both(f, jf, trusted: int, trusted_hash: bytes, target: int, chain_id: str):
    cl, cn = tverify.chain_id_leaf_const(chain_id)
    jcl, jcn = jverify.chain_id_leaf_const(chain_id)
    valid, out = tverify.skip_verify(
        tvars.pack_skip_witness(f.get_skip_inputs(trusted, trusted_hash, target, 8)),
        torch.from_numpy(_u8(trusted_hash).copy()), trusted, 0, target, 0, cl, cn, SKIP_MAX,
    )
    jvalid, jout = jverify.skip_verify_jit(
        jvars.pack_skip_witness(jf.get_skip_inputs(trusted, trusted_hash, target, 8)),
        jnp.asarray(_u8(trusted_hash)), jnp.uint32(trusted), jnp.uint32(0), jnp.uint32(target),
        jnp.uint32(0), jcl, jcn, skip_max=SKIP_MAX,
    )
    return (bool(valid), bytes(out.numpy())), (bool(jvalid), bytes(np.asarray(jout)))


@pytest.mark.parametrize(
    "case, valid",
    [("valid", True), ("wrong_prev_hash", False), ("wrong_chain_id", False)],
)
def test_step_verify_matches_jax(fixtures, case, valid):
    chain, f, jf = fixtures["good"]
    h = chain.headers[2].hash()
    claimed = bytes(32) if case == "wrong_prev_hash" else h
    chain_id = "celestia" if case == "wrong_chain_id" else CHAIN_ID
    port, ref = _step_both(f, jf, 2, h, claimed, chain_id)
    assert port == ref
    assert port == (valid, chain.headers[3].hash())


@pytest.mark.parametrize(
    "case, valid",
    [("valid", True), ("wrong_chain_id", False), ("too_short", False), ("too_little_power", False)],
)
def test_skip_verify_matches_jax(fixtures, case, valid):
    chain, f, jf = fixtures["weak" if case == "too_little_power" else "good"]
    target = 2 if case == "too_short" else 5
    chain_id = "celestia" if case == "wrong_chain_id" else CHAIN_ID
    port, ref = _skip_both(f, jf, 1, chain.headers[1].hash(), target, chain_id)
    assert port == ref
    assert port == (valid, chain.headers[target].hash())


def test_skip_circuit_run_raises_on_invalid(fixtures):
    chain, f, _ = fixtures["weak"]
    circuit = SkipCircuit(8, TendermintConfig(chain_id=CHAIN_ID), f, device="cpu")
    with pytest.raises(ValueError, match="skip verification failed"):
        circuit.run(encode_skip_input(1, chain.headers[1].hash(), 5))


def test_marshal_varint_matches_jax():
    for h in (0, 1, 127, 128, 300, 2**31, 2**32 + 5, 2**40 + 3, 2**63 - 1):
        lo, hi = h & 0xFFFFFFFF, h >> 32
        out, n = tverify.marshal_int64_varint(torch.tensor(lo), torch.tensor(hi))
        jout, jn = jverify.marshal_int64_varint(jnp.uint32(lo), jnp.uint32(hi))
        assert out.tolist() == np.asarray(jout).tolist() and int(n) == int(jn)


# ---------------------------------------------------------------------------
# The validator-leaf STARK bundle
# ---------------------------------------------------------------------------


def _bundle_lanes(**kwargs):
    chain = TestChain(n_validators=3, **kwargs)
    h = chain.extend()
    return get_validator_data_from_block(chain.val_set, chain.commits[h], chain.chain_id, 4)


@pytest.fixture(scope="module")
def leaf_bundle():
    lanes = _bundle_lanes()
    return lanes, proving.prove_validator_leaves(lanes, CFG, device="cpu")


def test_leaf_bundle_roundtrip_and_digests(leaf_bundle):
    lanes, bundle = leaf_bundle
    restored = proving.LeafProofBundle.from_dict(json.loads(json.dumps(bundle.to_dict())))
    assert proving.verify_leaf_bundle(restored, lanes, CFG)
    for lane, digest in zip(lanes, bundle.digests()):
        assert digest == hashlib.sha256(proving._leaf_bytes(lane)).digest()


def test_leaf_bundle_wrong_lanes_rejected(leaf_bundle):
    lanes, bundle = leaf_bundle
    assert not proving.verify_leaf_bundle(bundle, _bundle_lanes(seed=b"other"), CFG)
    assert not proving.verify_leaf_bundle(bundle, lanes[:3], CFG)


@pytest.mark.slow
def test_leaf_bundle_equals_jax_and_cross_verifies(leaf_bundle):
    """The JAX bundle of the same lanes serializes to the same dict, and
    each package verifies the other's bundle."""
    lanes, bundle = leaf_bundle
    chain = JTestChain(n_validators=3)
    h = chain.extend()
    jlanes = j_lanes_of(chain.val_set, chain.commits[h], chain.chain_id, 4)
    jbundle = jproving.prove_validator_leaves(jlanes, JCFG)
    assert json.dumps(jbundle.to_dict()) == json.dumps(bundle.to_dict())
    assert jproving.verify_leaf_bundle(jproving.LeafProofBundle.from_dict(bundle.to_dict()), jlanes, JCFG)
    assert proving.verify_leaf_bundle(proving.LeafProofBundle.from_dict(jbundle.to_dict()), lanes, CFG)
