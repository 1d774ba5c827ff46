"""Light-client operator: keep the on-chain head advancing.

Counterpart of ``tendermintx_tpu/runtime/operator.py`` (the upstream
TendermintX operator binary: configuration, step/skip requests, the
contract/chain consistency check and the long-running loop). Proving runs
on the operator's device through the circuit programs; contract reads go
through a minimal JSON-RPC client and writes through the EIP-155 signer
(runtime/signer.py), only after a composite proof verified.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.request
from dataclasses import dataclass, field

from ..circuits.config import TendermintConfig
from ..circuits.skip import SkipCircuit, encode_skip_input
from ..circuits.step import StepCircuit, encode_step_input
from ..inputs.fetcher import InputDataFetcher
from ..utils.keccak import selector
from .devices import require_device

log = logging.getLogger(__name__)

LATEST_BLOCK_SELECTOR = selector("latestBlock()")
HEADER_HASH_SELECTOR = selector("blockHeightToHeaderHash(uint64)")


class EthClient:
    """Minimal Ethereum JSON-RPC client."""

    def __init__(self, url: str):
        self.url = url
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        payload = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        req = urllib.request.Request(self.url, data=payload, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=20) as r:
            data = json.loads(r.read())
        if "error" in data:
            raise RuntimeError(f"eth rpc error: {data['error']}")
        return data["result"]

    def eth_call(self, to: str, calldata: str) -> str:
        return self.call("eth_call", [{"to": to, "data": calldata}, "latest"])


class ContractView:
    """Read side of the TendermintX contract."""

    def __init__(self, client: EthClient, address: str):
        self.client = client
        self.address = address

    def latest_block(self) -> int:
        return int(self.client.eth_call(self.address, LATEST_BLOCK_SELECTOR), 16)

    def header_hash(self, height: int) -> bytes:
        calldata = HEADER_HASH_SELECTOR + hex(height)[2:].rjust(64, "0")
        out = self.client.eth_call(self.address, calldata)
        return bytes.fromhex(out.removeprefix("0x"))


class MockContract:
    """In-memory light-client state for tests and dry runs: the contract's
    storage (latestBlock, blockHeightToHeaderHash)."""

    def __init__(self, genesis_height: int, genesis_header: bytes, skip_max: int = 100_800):
        self.skip_max = skip_max
        self.latest = genesis_height
        self.headers = {genesis_height: genesis_header}
        self.events: list[tuple] = []

    def latest_block(self) -> int:
        return self.latest

    def header_hash(self, height: int) -> bytes:
        return self.headers.get(height, b"\x00" * 32)

    # fulfilment callbacks (the gateway's verifiedCall)
    def step(self, prev_block: int, next_header: bytes):
        if prev_block != self.latest:
            raise ValueError("step must extend the head")
        self.headers[prev_block + 1] = next_header
        self.latest = prev_block + 1
        self.events.append(("HeadUpdate", self.latest, next_header))

    def skip(self, trusted_block: int, target_block: int, target_header: bytes):
        if trusted_block != self.latest:
            raise ValueError("skip must extend the head")
        if not trusted_block + 1 < target_block <= trusted_block + self.skip_max:
            raise ValueError("skip distance out of range")
        self.headers[target_block] = target_header
        self.latest = target_block
        self.events.append(("HeadUpdate", target_block, target_header))


@dataclass
class OperatorConfig:
    chain_id: str
    max_validators: int = 128
    fixture_path: str | None = None
    tendermint_rpc: list[str] = field(default_factory=list)
    ethereum_rpc: str | None = None
    contract_address: str | None = None
    interval_seconds: int = 240 * 60  # the upstream operator's cadence
    genesis_height: int | None = None
    genesis_header_hex: str | None = None
    # produce the validator-leaf SHA-256 STARK with every update; kept in
    # `last_bundle`
    prove_stark: bool = False
    # produce the full composite proof with every update, verify it
    # standalone, and advance the head on that verification rather than on
    # the witness program's validity bit; kept in `last_composite`
    prove_composite: bool = False
    # recursion-wrap each composite (requires prove_composite)
    wrap_composite: bool = False
    # write path: with a key + ethereum_rpc + contract_address, updates are
    # submitted as signed step(uint64)/skip(uint64,uint64) transactions;
    # requires prove_composite
    private_key: str | None = None
    eth_chain_id: int = 1
    # the torch device every witness program and proof runs on
    device: str = "cuda"

    @classmethod
    def from_dict(cls, d: dict) -> "OperatorConfig":
        return cls(**d)


class TendermintXOperator:
    def __init__(self, config: OperatorConfig, contract=None, fetcher=None):
        """Raises RuntimeError for a CUDA device without a card."""
        self.config = config
        self.device = require_device(config.device)
        tm_config = TendermintConfig(chain_id=config.chain_id)
        self.fetcher = fetcher or InputDataFetcher(
            urls=config.tendermint_rpc or None,
            fixture_path=config.fixture_path,
        )
        if contract is not None:
            self.contract = contract
        elif config.ethereum_rpc and config.contract_address:
            self.contract = ContractView(EthClient(config.ethereum_rpc), config.contract_address)
        else:
            if config.genesis_height is None or config.genesis_header_hex is None:
                raise ValueError("a mock contract needs genesis_height and genesis_header_hex")
            self.contract = MockContract(
                config.genesis_height,
                bytes.fromhex(config.genesis_header_hex.removeprefix("0x")),
                skip_max=tm_config.skip_max,
            )
        self.last_bundle = None  # most recent LeafProofBundle (prove_stark)
        self.last_composite = None  # most recent CompositeProof (prove_composite)
        self.submitter = None
        if config.private_key and config.ethereum_rpc and config.contract_address:
            from .signer import EthSubmitter

            if not config.prove_composite:
                raise ValueError(
                    "the write path requires prove_composite: transactions are "
                    "only submitted after independent proof verification"
                )
            client = (
                self.contract.client
                if isinstance(self.contract, ContractView)
                else EthClient(config.ethereum_rpc)
            )
            self.submitter = EthSubmitter(client, config.private_key, config.eth_chain_id)
        self.step_circuit = StepCircuit(config.max_validators, tm_config, self.fetcher, device=self.device)
        self.skip_circuit = SkipCircuit(config.max_validators, tm_config, self.fetcher, device=self.device)
        self.tm_config = tm_config

    def is_consistent(self) -> bool:
        """The contract head must match the real chain; raises otherwise."""
        height = self.contract.latest_block()
        onchain = self.contract.header_hash(height)
        real = self.fetcher.get_signed_header_from_number(height).header.hash()
        if onchain != real:
            raise RuntimeError(
                f"contract header at {height} ({onchain.hex()}) does not match "
                f"chain ({real.hex()})"
            )
        return True

    def tick(self, chain_tip: int | None = None) -> tuple[str, int] | None:
        """One operator iteration: ("step"|"skip", new_height), or None when
        there is nothing to do."""
        self.is_consistent()
        current = self.contract.latest_block()
        if chain_tip is None:
            chain_tip = int(self.fetcher.get_latest_signed_header().header.height)
        max_end = min(chain_tip, current + self.tm_config.skip_max)
        if max_end <= current:
            return None
        target = self.fetcher.find_block_to_request(current, max_end)
        header = self.contract.header_hash(current)
        if target == current + 1:
            enc = encode_step_input(current, header)
            if self.config.prove_composite:
                out = self._prove_step_composite(current, header)
            elif self.config.prove_stark:
                out, self.last_bundle = self.step_circuit.run_with_proof(enc)
            else:
                out = self.step_circuit.run(enc)
            self._submit_step(current, out)
            return ("step", current + 1)
        enc = encode_skip_input(current, header, target)
        if self.config.prove_composite:
            out = self._prove_skip_composite(current, header, target)
        elif self.config.prove_stark:
            out, self.last_bundle = self.skip_circuit.run_with_proof(enc)
        else:
            out = self.skip_circuit.run(enc)
        self._submit_skip(current, target, out)
        return ("skip", target)

    def _prove_step_composite(self, prev_block: int, prev_header: bytes) -> bytes:
        """Prove and independently verify a composite step proof; the
        returned header is the verifier's output, so the head advances only
        on a verified proof."""
        from ..circuits.composite import (
            prove_step_composite,
            runtime_configs,
            verify_step_composite,
            wrap_composite,
        )

        base_cfg, wrap_cfg, min_bits = runtime_configs()
        inputs = self.fetcher.get_step_inputs(prev_block, prev_header, self.config.max_validators)
        cp = prove_step_composite(prev_block, prev_header, inputs, base_cfg, device=self.device)
        if self.config.wrap_composite:
            cp = wrap_composite(cp, base_cfg, wrap_cfg, device=self.device)
        out = verify_step_composite(
            cp, self.tm_config.chain_id, config=base_cfg, min_security_bits=min_bits, wrap_config=wrap_cfg,
        )
        if out is None:
            raise RuntimeError("composite step proof failed verification")
        self.last_composite = cp
        return out[2]

    def _prove_skip_composite(self, trusted_block: int, trusted_header: bytes, target_block: int) -> bytes:
        from ..circuits.composite import (
            prove_skip_composite,
            runtime_configs,
            verify_skip_composite,
            wrap_composite,
        )

        base_cfg, wrap_cfg, min_bits = runtime_configs()
        inputs = self.fetcher.get_skip_inputs(
            trusted_block, trusted_header, target_block, self.config.max_validators
        )
        cp = prove_skip_composite(
            trusted_block, trusted_header, target_block, inputs, base_cfg, device=self.device
        )
        if self.config.wrap_composite:
            cp = wrap_composite(cp, base_cfg, wrap_cfg, device=self.device)
        out = verify_skip_composite(
            cp, self.tm_config.chain_id, self.tm_config.skip_max,
            config=base_cfg, min_security_bits=min_bits, wrap_config=wrap_cfg,
        )
        if out is None:
            raise RuntimeError("composite skip proof failed verification")
        self.last_composite = cp
        return out[3]

    def _submit_step(self, prev_block: int, next_header: bytes):
        if hasattr(self.contract, "step"):
            self.contract.step(prev_block, next_header)
        elif self.submitter is not None:
            calldata = selector("step(uint64)") + hex(prev_block)[2:].rjust(64, "0")
            tx = self.submitter.submit(self.config.contract_address, calldata)
            log.info("submitted step(%d) tx %s", prev_block, tx)
        else:
            log.info(
                "proved step %d -> %d header %s (no submitter configured)",
                prev_block, prev_block + 1, next_header.hex(),
            )

    def _submit_skip(self, trusted: int, target: int, target_header: bytes):
        if hasattr(self.contract, "skip"):
            self.contract.skip(trusted, target, target_header)
        elif self.submitter is not None:
            calldata = (
                selector("skip(uint64,uint64)")
                + hex(trusted)[2:].rjust(64, "0")
                + hex(target)[2:].rjust(64, "0")
            )
            tx = self.submitter.submit(self.config.contract_address, calldata)
            log.info("submitted skip(%d, %d) tx %s", trusted, target, tx)
        else:
            log.info(
                "proved skip %d -> %d header %s (no submitter configured)",
                trusted, target, target_header.hex(),
            )

    def run(self, max_iterations: int | None = None):
        i = 0
        while max_iterations is None or i < max_iterations:
            try:
                result = self.tick()
                if result:
                    log.info("advanced head: %s to %d", *result)
            except Exception:  # noqa: BLE001 — keep the loop alive; the traceback is logged
                log.exception("operator iteration failed; continuing")
            i += 1
            if max_iterations is None or i < max_iterations:
                time.sleep(self.config.interval_seconds)
