"""Prover service: a local proof-request queue over HTTP.

Counterpart of ``tendermintx_tpu/runtime/service.py``, with the same HTTP
contract: the operator posts proof requests (``POST /prove``), one worker
thread drives the composite prover on the service's device, and clients
poll ``/status/<id>`` and fetch ``/result/<id>`` (400 for a malformed
request, 404 for an unknown id, 409 for an unfinished one, 429 for a full
queue). JSON over HTTP, stdlib only, one worker: proving saturates the
card, so queueing is the point, not parallelism.

    service = ProverService(port=0, device="cuda")
    service.start()
    client = ProverClient(service.url)
    req_id = client.submit("skip", chain_id, input_hex, fixture_path=...)
    ... client.status(req_id) -> {"state": "pending|proving|done|failed"}
    ... client.result(req_id) -> {"proof": composite proof dict, "output": hex}
"""

from __future__ import annotations

import functools
import json
import logging
import os
import queue
import threading
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .devices import require_device

log = logging.getLogger(__name__)


def default_prover(request: dict, *, device) -> dict:
    """Prove a step/skip composite statement on `device` from a request
    dict with keys circuit ("step"|"skip"), chain_id, input (hex abi
    bytes), max_validators, fixture_path/rpc_urls, wrap; verify it on the
    host before returning it."""
    from ..circuits.composite import (
        prove_skip_composite,
        prove_step_composite,
        runtime_configs,
        verify_skip_composite,
        verify_step_composite,
        wrap_composite,
    )
    from ..circuits.config import TendermintConfig
    from ..circuits.skip import decode_skip_input
    from ..circuits.step import decode_step_input
    from ..inputs.fetcher import InputDataFetcher

    fetcher = InputDataFetcher(
        urls=request.get("rpc_urls") or None,
        fixture_path=request.get("fixture_path"),
    )
    cfg = TendermintConfig(chain_id=request["chain_id"])
    base_cfg, wrap_cfg, min_bits = runtime_configs()
    input_bytes = bytes.fromhex(request["input"].removeprefix("0x"))
    maxv = int(request.get("max_validators", 128))
    if request["circuit"] == "step":
        prev_block, prev_hash = decode_step_input(input_bytes)
        inputs = fetcher.get_step_inputs(prev_block, prev_hash, maxv)
        proof = prove_step_composite(prev_block, prev_hash, inputs, base_cfg, device=device)
    else:
        t_block, t_hash, target = decode_skip_input(input_bytes)
        inputs = fetcher.get_skip_inputs(t_block, t_hash, target, maxv)
        proof = prove_skip_composite(t_block, t_hash, target, inputs, base_cfg, device=device)
    if request.get("wrap"):
        # the constant-size recursion-wrapped proof; wrapping re-checks
        # every opening while it builds the witness
        proof = wrap_composite(proof, base_cfg, wrap_cfg, device=device)
    if request["circuit"] == "step":
        out = verify_step_composite(
            proof, cfg.chain_id, config=base_cfg, min_security_bits=min_bits, wrap_config=wrap_cfg,
        )
    else:
        out = verify_skip_composite(
            proof, cfg.chain_id, cfg.skip_max, config=base_cfg,
            min_security_bits=min_bits, wrap_config=wrap_cfg,
        )
    if out is None:
        raise RuntimeError("proof failed independent verification")
    return {"proof": proof.to_dict(), "output": "0x" + out[-1].hex()}


class ProverService:
    """Threaded HTTP server + one prover worker.

    Finished jobs are kept up to `keep_done` results (oldest evicted):
    composite proofs are megabytes, and a resident service would otherwise
    grow without bound."""

    def __init__(
        self,
        port: int = 0,
        prover=None,
        keep_done: int = 32,
        max_pending: int = 64,
        allowed_fixture_roots: list[str] | None = None,
        *,
        device="cuda",
    ):
        """prover: request dict -> result dict; default_prover on `device`
        when None. max_pending caps the queue (submissions beyond it get
        429); allowed_fixture_roots, when set, lists the directories a
        request's fixture_path may lie under (otherwise fixture_path is
        dropped: a resident service takes no local read paths from the
        network). Raises RuntimeError for a CUDA device without a card."""
        self.device = require_device(device)
        self.prover = prover or functools.partial(default_prover, device=self.device)
        self.jobs: dict[str, dict] = {}
        self.queue: queue.Queue = queue.Queue()
        self.keep_done = keep_done
        self.max_pending = max_pending
        self.allowed_fixture_roots = [os.path.realpath(r) for r in (allowed_fixture_roots or [])]
        self._pending = 0
        self._done_order: list[str] = []
        self._lock = threading.Lock()
        self.warm = False
        svc = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to logging
                log.debug("service: " + fmt, *args)

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/prove":
                    return self._json(404, {"error": "not found"})
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n))
                    if req["circuit"] not in ("step", "skip") or not isinstance(req["chain_id"], str):
                        raise ValueError("bad circuit or chain_id")
                    bytes.fromhex(req["input"].removeprefix("0x"))
                except Exception:  # noqa: BLE001 — any malformed request is a 400
                    return self._json(400, {"error": "bad request"})
                fp = req.get("fixture_path")
                if fp is not None and not svc._fixture_allowed(fp):
                    req.pop("fixture_path", None)
                req_id = uuid.uuid4().hex
                with svc._lock:
                    if svc._pending >= svc.max_pending:
                        return self._json(429, {"error": "queue full"})
                    svc._pending += 1
                    svc.jobs[req_id] = {"state": "pending", "request": req}
                svc.queue.put(req_id)
                self._json(200, {"request_id": req_id})

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                if len(parts) == 2 and parts[0] in ("status", "result"):
                    with svc._lock:
                        job = svc.jobs.get(parts[1])
                    if job is None:
                        return self._json(404, {"error": "unknown request"})
                    if parts[0] == "status":
                        extra = {"error": job["error"]} if job["state"] == "failed" else {}
                        return self._json(200, {"state": job["state"], **extra})
                    if job["state"] != "done":
                        return self._json(409, {"state": job["state"]})
                    return self._json(200, job["result"])
                return self._json(404, {"error": "not found"})

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._threads: list[threading.Thread] = []

    @property
    def url(self) -> str:
        host, port = self.server.server_address
        return f"http://{host}:{port}"

    def start(self):
        self._threads = [
            threading.Thread(target=self.server.serve_forever, daemon=True),
            threading.Thread(target=self._worker, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self):
        """Stop serving, let the worker finish its job, close the socket."""
        self.queue.put(None)
        self.server.shutdown()
        for t in self._threads:
            t.join(timeout=60)
        self.server.server_close()

    def prewarm(self, n_validators: int = 4, max_validators: int = 8) -> float:
        """Prove and verify one synthetic composite at the configured lane
        shape on the service's device before taking requests, so the first
        request does not pay for first-use work (kernel library load, host
        tables). Returns the prewarm's seconds."""
        import tempfile
        import time

        from ..circuits.composite import prove_skip_composite, verify_skip_composite
        from ..inputs.fetcher import InputDataFetcher, InputDataMode
        from ..inputs.testchain import TestChain

        t0 = time.time()
        chain = TestChain(n_validators=n_validators, chain_id="prewarm")
        for _ in range(5):
            chain.extend()
        with tempfile.TemporaryDirectory(prefix="prewarm_fixtures_") as tmp:
            chain.write_fixtures(tmp)
            fetcher = InputDataFetcher(fixture_path=tmp, mode=InputDataMode.FIXTURE)
            inputs = fetcher.get_skip_inputs(1, chain.headers[1].hash(), 4, max_validators=max_validators)
        proof = prove_skip_composite(1, chain.headers[1].hash(), 4, inputs, device=self.device)
        if verify_skip_composite(proof, "prewarm", 100_800) is None:
            raise RuntimeError("prewarm proof failed to verify")
        self.warm = True
        dt = time.time() - t0
        log.info("service prewarmed in %.1fs", dt)
        return dt

    def _fixture_allowed(self, path) -> bool:
        if not isinstance(path, str) or not self.allowed_fixture_roots:
            return False
        real = os.path.realpath(path)
        return any(real == root or real.startswith(root + os.sep) for root in self.allowed_fixture_roots)

    def _worker(self):
        while True:
            req_id = self.queue.get()
            if req_id is None:
                return
            with self._lock:
                job = self.jobs[req_id]
                job["state"] = "proving"
                self._pending -= 1
            try:
                result = self.prover(job["request"])
                with self._lock:
                    job["state"] = "done"
                    job["result"] = result
                    self._evict(req_id)
            except Exception as e:  # noqa: BLE001 — job-level isolation, traceback logged
                log.exception("prover job %s failed", req_id)
                with self._lock:
                    job["state"] = "failed"
                    job["error"] = repr(e)
                    self._evict(req_id)

    def _evict(self, req_id: str):
        # caller holds the lock
        self._done_order.append(req_id)
        while len(self._done_order) > self.keep_done:
            self.jobs.pop(self._done_order.pop(0), None)


class ProverClient:
    """Submit to and poll a ProverService."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")

    def _req(self, method: str, path: str, body: dict | None = None) -> tuple[int, dict]:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.url + path, data=data, method=method, headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def submit(
        self,
        circuit: str,
        chain_id: str,
        input_hex: str,
        max_validators: int = 128,
        fixture_path: str | None = None,
        rpc_urls: list[str] | None = None,
        wrap: bool = False,
    ) -> str:
        code, out = self._req(
            "POST",
            "/prove",
            {
                "circuit": circuit,
                "chain_id": chain_id,
                "input": input_hex,
                "max_validators": max_validators,
                "fixture_path": fixture_path,
                "rpc_urls": rpc_urls,
                "wrap": wrap,
            },
        )
        if code != 200:
            raise RuntimeError(f"submit failed: {out}")
        return out["request_id"]

    def status(self, request_id: str) -> dict:
        code, out = self._req("GET", f"/status/{request_id}")
        if code == 404:
            raise KeyError(request_id)
        return out

    def result(self, request_id: str) -> dict:
        code, out = self._req("GET", f"/result/{request_id}")
        if code == 409:
            raise RuntimeError(f"not done: {out}")
        if code != 200:
            raise KeyError(request_id)
        return out

    def wait(self, request_id: str, timeout: float = 3600, poll: float = 1.0) -> dict:
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.status(request_id)
            if st["state"] == "done":
                return self.result(request_id)
            if st["state"] == "failed":
                raise RuntimeError(f"proving failed: {st.get('error')}")
            time.sleep(poll)
        raise TimeoutError(request_id)
