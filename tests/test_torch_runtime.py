"""The port's runtime layer: keccak and the signer, artifacts, the CLI, the
prover service, the operator and runtime_configs, on the CPU.

The witness-mode CLI output is held against the JAX package's skip
program on the same input. Composite proving through the CLI, the
service's default prover and the operator's wrap drill are in the `slow`
tier (seconds on the card, minutes on the CPU)."""

import copy
import hashlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu_torch.circuits.composite import MIN_SECURITY_BITS, runtime_configs
from tendermintx_tpu_torch.circuits.skip import encode_skip_input
from tendermintx_tpu_torch.circuits.step import encode_step_input
from tendermintx_tpu_torch.inputs.fetcher import InputDataFetcher, InputDataMode
from tendermintx_tpu_torch.inputs.testchain import TestChain
from tendermintx_tpu_torch.runtime import cli
from tendermintx_tpu_torch.runtime.operator import MockContract, OperatorConfig, TendermintXOperator
from tendermintx_tpu_torch.runtime.service import ProverClient, ProverService
from tendermintx_tpu_torch.runtime.signer import (
    _GX,
    _GY,
    EthSubmitter,
    _pt_mul,
    ecdsa_sign,
    ecdsa_verify,
    private_to_address,
    rlp_encode,
    sign_legacy_tx,
)
from tendermintx_tpu_torch.utils.keccak import keccak256, selector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_ID = "test-chain"
# >= 100 conjectured bits (2 * 42 + 16), cheap at N=4 on the CPU
FRI_100 = "2,42,16,16"


@pytest.fixture(scope="module")
def chain_fixtures(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chainfix")
    chain = TestChain(n_validators=4, chain_id=CHAIN_ID)
    for _ in range(6):
        chain.extend()
    chain.write_fixtures(str(tmp))
    return chain, str(tmp)


def _fetcher(fix: str) -> InputDataFetcher:
    return InputDataFetcher(fixture_path=fix, mode=InputDataMode.FIXTURE)


# ---------------------------------------------------------------------------
# keccak + signer (the cases of tests/test_signer.py)
# ---------------------------------------------------------------------------


def test_keccak_vectors_and_jax_copy():
    from tendermintx_tpu.utils.keccak import keccak256 as j_keccak256

    assert keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert selector("transfer(address,uint256)") == "0xa9059cbb"
    rng = np.random.default_rng(5)
    for n in (1, 135, 136, 137, 300):
        data = rng.bytes(n)
        assert keccak256(data) == j_keccak256(data)


def test_rfc6979_known_vector():
    h = hashlib.sha256(b"Satoshi Nakamoto").digest()
    r, s, _ = ecdsa_sign(1, h)
    assert r == 0x934B1EA10A4B3C1757E2B0C017D0B6143CE3C9A7E6A4A49860D7A6AB210EE3D8
    assert s == 0x2442CE9D2B916064108014783E923EC36B49743E2FFA1C4496F01A512AAFD9E5
    assert ecdsa_verify((_GX, _GY), h, r, s)
    assert not ecdsa_verify((_GX, _GY), h, r, s + 1)


def test_sign_verify_roundtrip_random_keys():
    for priv in (2, 0xDEADBEEF, 2**200 + 12345):
        pub = _pt_mul(priv, (_GX, _GY))
        h = hashlib.sha256(str(priv).encode()).digest()
        r, s, _ = ecdsa_sign(priv, h)
        assert ecdsa_verify(pub, h, r, s)
        assert not ecdsa_verify(pub, hashlib.sha256(b"other").digest(), r, s)


def test_eth_address_derivation():
    priv = 0x4646464646464646464646464646464646464646464646464646464646464646
    assert private_to_address(priv).lower() == "0x9d8a62f656a8d1615c1294fd71e9cfb3e4855a4f"


def test_rlp_encoding():
    assert rlp_encode(b"") == b"\x80"
    assert rlp_encode(0) == b"\x80"
    assert rlp_encode(b"\x01") == b"\x01"
    assert rlp_encode(15) == b"\x0f"
    assert rlp_encode(1024) == b"\x82\x04\x00"
    assert rlp_encode(b"dog") == b"\x83dog"
    assert rlp_encode([b"cat", b"dog"]) == b"\xc8\x83cat\x83dog"
    assert rlp_encode([]) == b"\xc0"
    assert rlp_encode(b"a" * 56) == b"\xb8\x38" + b"a" * 56


def test_eip155_example_transaction():
    priv = 0x4646464646464646464646464646464646464646464646464646464646464646
    unsigned = [9, 20 * 10**9, 21000, bytes([0x35] * 20), 10**18, b"", 1, 0, 0]
    assert keccak256(rlp_encode(unsigned)).hex() == (
        "daf5a779ae972f972197303d7b574746c7ef83eadac0f2791ad23db92e4c8e53"
    )
    raw = sign_legacy_tx(
        priv, nonce=9, gas_price=20 * 10**9, gas=21000,
        to="0x3535353535353535353535353535353535353535", value=10**18, data=b"", chain_id=1,
    )
    assert raw.hex() == (
        "f86c098504a817c800825208943535353535353535353535353535353535353535880"
        "de0b6b3a76400008025a028ef61340bd939bc2195fe537567866003e1a15d3c71ff63"
        "e1590620aa636276a067cbe9d8997f761aecb703304b3800ccf555c9f3dc64214b297"
        "fb1966a3b6d83"
    )


class _MockRpc:
    def __init__(self):
        self.sent = {}

    def call(self, method, params):
        if method == "eth_getTransactionCount":
            return "0x5"
        if method == "eth_gasPrice":
            return "0x3b9aca00"
        if method == "eth_sendRawTransaction":
            self.sent["raw"] = params[0]
            return "0x" + "ab" * 32
        raise AssertionError(method)


def test_submitter_builds_valid_tx():
    rpc = _MockRpc()
    tx = EthSubmitter(rpc, "0x" + "11" * 32, chain_id=5).submit("0x" + "22" * 20, "0xdeadbeef")
    assert tx == "0x" + "ab" * 32
    raw = bytes.fromhex(rpc.sent["raw"].removeprefix("0x"))
    assert raw[0] >= 0xF7 and b"\xde\xad\xbe\xef" in raw


# ---------------------------------------------------------------------------
# Artifacts and the CLI's witness mode
# ---------------------------------------------------------------------------


def test_artifact_roundtrip_and_wrong_circuit(tmp_path, chain_fixtures):
    from tendermintx_tpu_torch.circuits.variables import pack_step_witness
    from tendermintx_tpu_torch.circuits.verify import chain_id_leaf_const
    from tendermintx_tpu_torch.runtime.artifact import CircuitArtifact, build_artifact

    chain, fix = chain_fixtures
    build_artifact("step", CHAIN_ID, max_validators=8).save(str(tmp_path / "step"))
    loaded = CircuitArtifact.load(str(tmp_path / "step"), device="cpu")
    assert (loaded.circuit, loaded.chain, loaded.max_validators) == ("step", CHAIN_ID, 8)
    inputs = _fetcher(fix).get_step_inputs(2, chain.headers[2].hash(), 8)
    cid_leaf, cid_len = chain_id_leaf_const(CHAIN_ID)
    valid, out = loaded.call(
        pack_step_witness(inputs),
        torch.frombuffer(bytearray(chain.headers[2].hash()), dtype=torch.uint8), 2, 0, cid_leaf, cid_len,
    )
    assert bool(valid) and bytes(out.numpy()) == chain.headers[3].hash()
    with pytest.raises(ValueError, match="artifact is for step"):
        CircuitArtifact.load(str(tmp_path / "step"), circuit="skip", device="cpu")


@pytest.mark.parametrize("chain_id", [CHAIN_ID, "celestia"])
def test_cli_witness_prove_matches_jax(tmp_path, chain_fixtures, chain_id):
    """build + witness prove through the CLI: `valid` and `output` equal
    what the JAX skip program gives for the same input (a wrong chain id
    in the artifact gives an invalid, exit-1 run in both)."""
    import jax.numpy as jnp

    from tendermintx_tpu.circuits.variables import pack_skip_witness
    from tendermintx_tpu.circuits.verify import chain_id_leaf_const, skip_verify_jit
    from tendermintx_tpu.inputs.fetcher import InputDataFetcher as JFetcher
    from tendermintx_tpu.inputs.fetcher import InputDataMode as JMode

    chain, fix = chain_fixtures
    trusted = chain.headers[2].hash()
    build_dir = str(tmp_path / "build")
    assert cli.main(["build", "--circuit", "skip", "--chain", chain_id,
                     "--max-validators", "8", "--out", build_dir]) == 0
    input_path = str(tmp_path / "input.json")
    with open(input_path, "w") as f:
        json.dump({"input": "0x" + encode_skip_input(2, trusted, 6).hex()}, f)
    out_path = str(tmp_path / "proof.json")
    rc = cli.main(["prove", "--artifact", build_dir, "--input", input_path, "--out", out_path,
                   "--fixture-path", fix, "--device", "cpu"])
    with open(out_path) as f:
        result = json.load(f)

    inputs = JFetcher(fixture_path=fix, mode=JMode.FIXTURE).get_skip_inputs(2, trusted, 6, 8)
    cl, cn = chain_id_leaf_const(chain_id)
    valid, out = skip_verify_jit(
        pack_skip_witness(inputs), jnp.asarray(np.frombuffer(trusted, dtype=np.uint8)),
        jnp.uint32(2), jnp.uint32(0), jnp.uint32(6), jnp.uint32(0), cl, cn, skip_max=100_800,
    )
    assert result["valid"] is bool(valid)
    assert result["output"] == "0x" + bytes(np.asarray(out)).hex() == "0x" + chain.headers[6].hash().hex()
    assert rc == (0 if chain_id == CHAIN_ID else 1)
    assert set(result) == {"input", "circuit", "chain", "max_validators", "output", "valid"}


# ---------------------------------------------------------------------------
# The prover service (the cases of tests/test_service.py, stub provers)
# ---------------------------------------------------------------------------


def _echo_prover(request):
    return {"proof": {"echo": request["circuit"]}, "output": "0x" + "ab" * 32}


def test_service_plumbing_and_validation():
    svc = ProverService(prover=_echo_prover, device="cpu")
    svc.start()
    try:
        client = ProverClient(svc.url)
        req_id = client.submit("step", CHAIN_ID, "0x" + "00" * 40)
        out = client.wait(req_id, timeout=30, poll=0.05)
        assert out == {"proof": {"echo": "step"}, "output": "0x" + "ab" * 32}
        assert client.status(req_id)["state"] == "done"
        with pytest.raises(KeyError):
            client.status("deadbeef")
        with pytest.raises(RuntimeError, match="submit failed"):
            client.submit("frobnicate", CHAIN_ID, "0x00")
        with pytest.raises(RuntimeError, match="submit failed"):
            client.submit("step", CHAIN_ID, "0xZZ")
    finally:
        svc.stop()


def test_service_failed_job_reports_error():
    def boom(request):
        raise ValueError("no witness")

    svc = ProverService(prover=boom, device="cpu")
    svc.start()
    try:
        client = ProverClient(svc.url)
        req_id = client.submit("skip", CHAIN_ID, "0x" + "00" * 48)
        with pytest.raises(RuntimeError, match="no witness"):
            client.wait(req_id, timeout=30, poll=0.05)
        st = client.status(req_id)
        assert st["state"] == "failed" and "no witness" in st["error"]
        with pytest.raises(RuntimeError, match="not done"):
            client.result(req_id)
    finally:
        svc.stop()


def test_service_queues_sequentially():
    order = []
    gate = threading.Event()

    def slow_prover(request):
        order.append(request["chain_id"])
        if len(order) == 1:
            gate.wait(timeout=10)
        return {"proof": {}, "output": "0x"}

    svc = ProverService(prover=slow_prover, device="cpu")
    svc.start()
    try:
        client = ProverClient(svc.url)
        a = client.submit("step", "first", "0x" + "00" * 40)
        b = client.submit("step", "second", "0x" + "00" * 40)
        assert client.status(b)["state"] == "pending"
        gate.set()
        client.wait(a, timeout=30, poll=0.05)
        client.wait(b, timeout=30, poll=0.05)
        assert order == ["first", "second"]
    finally:
        svc.stop()


def test_service_evicts_old_results():
    svc = ProverService(prover=_echo_prover, keep_done=2, device="cpu")
    svc.start()
    try:
        client = ProverClient(svc.url)
        ids = []
        for i in range(4):
            rid = client.submit("step", f"c{i}", "0x" + "00" * 40)
            client.wait(rid, timeout=30, poll=0.05)
            ids.append(rid)
        with pytest.raises(KeyError):
            client.status(ids[0])
        assert client.status(ids[-1])["state"] == "done"
    finally:
        svc.stop()


def test_service_queue_cap_and_fixture_whitelist(tmp_path):
    gate = threading.Event()
    seen = []

    def blocked(request):
        seen.append(request.get("fixture_path"))
        gate.wait(timeout=10)
        return {"proof": {}, "output": "0x"}

    allowed = tmp_path / "fixtures"
    allowed.mkdir()
    svc = ProverService(prover=blocked, max_pending=1, allowed_fixture_roots=[str(allowed)], device="cpu")
    svc.start()
    try:
        client = ProverClient(svc.url)
        a = client.submit("step", "a", "0x" + "00" * 40, fixture_path=str(allowed))
        for _ in range(1000):  # until the worker has taken `a`
            if client.status(a)["state"] == "proving":
                break
            threading.Event().wait(0.01)
        assert client.status(a)["state"] == "proving"
        b = client.submit("step", "b", "0x" + "00" * 40, fixture_path=str(tmp_path))
        with pytest.raises(RuntimeError, match="queue full"):
            client.submit("step", "c", "0x" + "00" * 40)
        gate.set()
        client.wait(a, timeout=30, poll=0.05)
        client.wait(b, timeout=30, poll=0.05)
        assert seen == [str(allowed), None]  # a path outside the roots is dropped
    finally:
        gate.set()
        svc.stop()


# ---------------------------------------------------------------------------
# The operator, witness-only mode (MockContract)
# ---------------------------------------------------------------------------


def _operator(fix: str, contract, **kwargs) -> TendermintXOperator:
    cfg = OperatorConfig(chain_id=CHAIN_ID, max_validators=8, fixture_path=fix, device="cpu", **kwargs)
    return TendermintXOperator(cfg, contract=contract, fetcher=_fetcher(fix))


def test_operator_advances_mock_contract(chain_fixtures):
    chain, fix = chain_fixtures
    contract = MockContract(1, chain.headers[1].hash())
    op = _operator(fix, contract)
    assert op.tick(chain_tip=7) == ("skip", 7)
    assert contract.latest_block() == 7
    assert contract.header_hash(7) == chain.headers[7].hash()
    assert op.tick(chain_tip=7) is None


def test_operator_steps_when_adjacent(chain_fixtures):
    chain, fix = chain_fixtures
    contract = MockContract(6, chain.headers[6].hash())
    assert _operator(fix, contract).tick(chain_tip=7) == ("step", 7)
    assert contract.header_hash(7) == chain.headers[7].hash()


def test_operator_consistency_check(chain_fixtures):
    _, fix = chain_fixtures
    op = _operator(fix, MockContract(1, b"\xde\xad" * 16))  # forged head
    with pytest.raises(RuntimeError, match="does not match"):
        op.tick(chain_tip=7)


def test_operator_run_loop_keeps_a_failed_iteration_from_moving_the_head(chain_fixtures):
    _, fix = chain_fixtures
    contract = MockContract(1, b"\xde\xad" * 16)
    op = _operator(fix, contract, interval_seconds=0)
    op.run(max_iterations=2)  # logs each failure and goes on
    assert contract.latest_block() == 1


# ---------------------------------------------------------------------------
# runtime_configs and the device contract
# ---------------------------------------------------------------------------


def test_runtime_configs_honour_the_environment(monkeypatch):
    monkeypatch.setenv("TMX_FRI_CONFIG", "2,42,16,16")
    monkeypatch.setenv("TMX_WRAP_FRI_CONFIG", "4,22,32,12")
    monkeypatch.setenv("TMX_MIN_SECURITY_BITS", "110")
    base, wrap, bits = runtime_configs()
    assert (base.rate_bits, base.n_queries, base.final_poly_len, base.proof_of_work_bits) == (2, 42, 16, 16)
    assert (wrap.rate_bits, wrap.n_queries, wrap.final_poly_len, wrap.proof_of_work_bits) == (4, 22, 32, 12)
    assert bits == 110
    monkeypatch.delenv("TMX_FRI_CONFIG")
    monkeypatch.delenv("TMX_WRAP_FRI_CONFIG")
    monkeypatch.delenv("TMX_MIN_SECURITY_BITS")
    base, wrap, bits = runtime_configs()
    assert base.fri.security_bits == wrap.fri.security_bits == bits == MIN_SECURITY_BITS


@pytest.mark.parametrize("floor", ["99", "20", "0"])
def test_runtime_configs_refuse_a_floor_below_100(monkeypatch, floor):
    monkeypatch.setenv("TMX_MIN_SECURITY_BITS", floor)
    with pytest.raises(ValueError, match="floor"):
        runtime_configs()


@pytest.mark.parametrize("surface", ["cli_prove", "cli_serve", "service", "operator"])
def test_cuda_without_a_card_raises(monkeypatch, tmp_path, chain_fixtures, surface):
    """Asked for the card where there is none, every entry point raises at
    start-up; nothing runs on the CPU instead."""
    _, fix = chain_fixtures
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if surface == "cli_prove":
            cli.main(["prove", "--artifact", str(tmp_path), "--input", str(tmp_path / "x.json")])
        elif surface == "cli_serve":
            cli.main(["serve", "--port", "0"])
        elif surface == "service":
            ProverService(prover=_echo_prover)
        else:
            TendermintXOperator(
                OperatorConfig(chain_id=CHAIN_ID, fixture_path=fix),
                contract=MockContract(1, b"\x00" * 32), fetcher=_fetcher(fix),
            )


# ---------------------------------------------------------------------------
# Composite proofs through the runtime (slow on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def composite_files(tmp_path_factory, chain_fixtures):
    """`prove --composite` of skip 2 -> 6 at N=4 through each package's
    CLI at a 100-bit config: (port file, JAX file)."""
    chain, fix = chain_fixtures
    tmp = tmp_path_factory.mktemp("composite")
    input_path = str(tmp / "input.json")
    with open(input_path, "w") as f:
        json.dump({"input": "0x" + encode_skip_input(2, chain.headers[2].hash(), 6).hex()}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, TMX_FRI_CONFIG=FRI_100)
    paths = {}
    for pkg in ("tendermintx_tpu_torch", "tendermintx_tpu"):
        build = str(tmp / f"build_{pkg}")
        out = str(tmp / f"{pkg}.json")
        device = ["--device", "cpu"] if pkg == "tendermintx_tpu_torch" else []
        for args in (
            ["build", "--circuit", "skip", "--chain", CHAIN_ID, "--max-validators", "4", "--out", build],
            ["prove", "--artifact", build, "--input", input_path, "--out", out,
             "--fixture-path", fix, "--composite", *device],
        ):
            r = subprocess.run([sys.executable, "-m", f"{pkg}.runtime.cli", *args],
                               capture_output=True, text=True, env=env, timeout=1500)
            assert r.returncode == 0, r.stderr[-3000:]
        paths[pkg] = out
    return paths, env, tmp


def _cli_verify(pkg: str, path: str, env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", f"{pkg}.runtime.cli", "verify", "--proof", path],
                          capture_output=True, text=True, env=env, timeout=1200)


@pytest.mark.slow
def test_cli_composite_prove_verify_and_tamper(composite_files):
    """The port's proof file verifies through its own CLI; a tampered
    abi_output exits 1. The file has the JAX file's keys and output."""
    paths, env, tmp = composite_files
    with open(paths["tendermintx_tpu_torch"]) as f:
        port = json.load(f)
    with open(paths["tendermintx_tpu"]) as f:
        ref = json.load(f)
    assert set(port) == set(ref) and port["output"] == ref["output"] and port["valid"] is True
    r = _cli_verify("tendermintx_tpu_torch", paths["tendermintx_tpu_torch"], env)
    assert r.returncode == 0 and "composite proof: OK" in r.stdout, r.stderr[-2000:]
    port["composite_proof"]["abi_output"] = "00" * 32
    tampered = str(tmp / "tampered.json")
    with open(tampered, "w") as f:
        json.dump(port, f)
    assert _cli_verify("tendermintx_tpu_torch", tampered, env).returncode == 1


@pytest.mark.slow
@pytest.mark.parametrize("verifier, prover", [
    ("tendermintx_tpu_torch", "tendermintx_tpu"),
    ("tendermintx_tpu", "tendermintx_tpu_torch"),
])
def test_cli_verify_accepts_the_other_packages_file(composite_files, verifier, prover):
    paths, env, tmp = composite_files
    r = _cli_verify(verifier, paths[prover], env)
    assert r.returncode == 0 and "composite proof: OK" in r.stdout, r.stderr[-2000:]
    with open(paths[prover]) as f:
        d = json.load(f)
    d["composite_proof"]["abi_output"] = "00" * 32
    tampered = str(tmp / f"tampered_{prover}.json")
    with open(tampered, "w") as f:
        json.dump(d, f)
    assert _cli_verify(verifier, tampered, env).returncode == 1


@pytest.mark.slow
def test_cli_witness_file_equals_jax_cli(tmp_path, chain_fixtures):
    """The witness-mode proof file of each CLI, byte for byte."""
    chain, fix = chain_fixtures
    input_path = str(tmp_path / "input.json")
    with open(input_path, "w") as f:
        json.dump({"input": "0x" + encode_step_input(3, chain.headers[3].hash()).hex()}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    blobs = []
    for pkg in ("tendermintx_tpu_torch", "tendermintx_tpu"):
        build, out = str(tmp_path / f"b_{pkg}"), str(tmp_path / f"{pkg}.json")
        device = ["--device", "cpu"] if pkg == "tendermintx_tpu_torch" else []
        for args in (
            ["build", "--circuit", "step", "--chain", CHAIN_ID, "--max-validators", "8", "--out", build],
            ["prove", "--artifact", build, "--input", input_path, "--out", out, "--fixture-path", fix, *device],
        ):
            r = subprocess.run([sys.executable, "-m", f"{pkg}.runtime.cli", *args],
                               capture_output=True, text=True, env=env, timeout=900)
            assert r.returncode == 0, r.stderr[-3000:]
        with open(out, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]


@pytest.mark.slow
def test_wrap_drill(tmp_path, monkeypatch):
    """The operator with `wrap_composite: true` proves, wraps and verifies
    the wrapped proof before the head moves; the signer carries its ABI
    input; tampered wrapped proofs are rejected."""
    from tendermintx_tpu_torch.circuits.composite import CompositeProof, verify_skip_composite

    monkeypatch.setenv("TMX_FRI_CONFIG", FRI_100)
    chain = TestChain(n_validators=2, chain_id=CHAIN_ID)
    for _ in range(3):
        chain.extend()
    chain.write_fixtures(str(tmp_path))
    contract = MockContract(1, chain.headers[1].hash())
    op = TendermintXOperator(
        OperatorConfig(chain_id=CHAIN_ID, max_validators=2, fixture_path=str(tmp_path),
                       prove_composite=True, wrap_composite=True, device="cpu"),
        contract=contract, fetcher=_fetcher(str(tmp_path)),
    )
    assert op.tick(chain_tip=4) == ("skip", 4)
    assert contract.header_hash(4) == chain.headers[4].hash()
    assert op.last_composite is not None and op.last_composite.is_wrapped

    base, wrap, bits = runtime_configs()
    args = dict(config=base, min_security_bits=bits, wrap_config=wrap)
    reparsed = CompositeProof.from_bytes(op.last_composite.to_bytes())
    want = (1, chain.headers[1].hash(), 4, chain.headers[4].hash())
    assert verify_skip_composite(reparsed, CHAIN_ID, 100_800, **args) == want
    rpc = _MockRpc()
    EthSubmitter(rpc, "0x" + "11" * 32, chain_id=5).submit("0x" + "22" * 20, "0x" + reparsed.abi_inputs.hex())
    assert reparsed.abi_inputs in bytes.fromhex(rpc.sent["raw"].removeprefix("0x"))
    bad = copy.deepcopy(op.last_composite)
    bad.abi_output = bytes(32)
    assert verify_skip_composite(bad, CHAIN_ID, 100_800, **args) is None
    bad = copy.deepcopy(op.last_composite)
    bad.batch.wrapper.statements[0].trace_cap[0][0] ^= 1
    assert verify_skip_composite(bad, CHAIN_ID, 100_800, **args) is None
