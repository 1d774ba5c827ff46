"""Per-chain configuration: a copy of ``tendermintx_tpu/circuits/config.py``
(the upstream TendermintX `TendermintConfig` trait with its Celestia and
Mocha-4 instances).
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class TendermintConfig:
    chain_id: str
    skip_max: int = 100_800  # ~2 weeks at 12 s blocks, as upstream

    @property
    def chain_id_bytes(self) -> bytes:
        return self.chain_id.encode()


CELESTIA = TendermintConfig(chain_id="celestia")
MOCHA_4 = TendermintConfig(chain_id="mocha-4")
