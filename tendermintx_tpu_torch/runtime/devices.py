"""The runtime's device check: every entry point (CLI, prover service,
operator) runs on the card unless its caller names another device, and
refuses to start on a missing card instead of falling back to the CPU."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises RuntimeError when it is a CUDA
    device and no CUDA device is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available "
            "(pass --device cpu / device='cpu' to run on the CPU)"
        )
    return dev
