"""Circuit artifacts: build once, prove many times.

Counterpart of ``tendermintx_tpu/runtime/artifact.py``. The JAX package
exports the traced verification program as StableHLO beside a JSON
manifest of the circuit parameters; the port keeps the manifest (same
keys) and has no exported program: ``CircuitArtifact.call`` runs the
port's ``step_verify`` / ``skip_verify`` on the device the artifact was
loaded for.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..circuits.config import CELESTIA, MOCHA_4, TendermintConfig
from ..circuits.verify import skip_verify, step_verify

CHAINS = {"celestia": CELESTIA, "mocha-4": MOCHA_4}

MANIFEST_NAME = "manifest.json"


@dataclasses.dataclass
class CircuitArtifact:
    circuit: str  # "step" | "skip"
    chain: str
    max_validators: int
    skip_max: int
    device: torch.device | None = None  # where `call` runs; set by load

    def call(self, witness, *scalars):
        """(valid, header) of the circuit's program on the witness (moved
        to the artifact's device) and the scalar arguments of
        step_verify / skip_verify after the witness."""
        if self.device is None:
            raise ValueError("artifact has no device: load it with CircuitArtifact.load(..., device=...)")
        w = witness.to(self.device)
        if self.circuit == "step":
            return step_verify(w, *scalars)
        return skip_verify(w, *scalars, skip_max=self.skip_max)

    def save(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        manifest = {
            "framework": "tendermintx-tpu-torch",
            "version": 1,
            "circuit": self.circuit,
            "chain": self.chain,
            "max_validators": self.max_validators,
            "skip_max": self.skip_max,
        }
        with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2)

    @classmethod
    def load(cls, out_dir: str, circuit: str | None = None, *, device) -> "CircuitArtifact":
        with open(os.path.join(out_dir, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        if circuit is not None and manifest["circuit"] != circuit:
            raise ValueError(f"artifact is for {manifest['circuit']}, wanted {circuit}")
        return cls(
            circuit=manifest["circuit"],
            chain=manifest["chain"],
            max_validators=manifest["max_validators"],
            skip_max=manifest["skip_max"],
            device=torch.device(device),
        )


def build_artifact(circuit: str, chain: str, max_validators: int) -> CircuitArtifact:
    if circuit not in ("step", "skip"):
        raise ValueError(f"unknown circuit {circuit!r}")
    config = CHAINS.get(chain) or TendermintConfig(chain_id=chain)
    return CircuitArtifact(
        circuit=circuit,
        chain=chain,
        max_validators=max_validators,
        skip_max=config.skip_max,
    )
