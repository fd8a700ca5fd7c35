"""Explicit device selection — no silent fallback.

The port's functions take an explicit ``device``; this resolves the name a
user gave.  Asking for CUDA on a machine without it raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but CUDA is not available "
            f"(torch {torch.__version__}); pass --device cpu to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(name)!r} (cuda|cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (CUDA); nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
