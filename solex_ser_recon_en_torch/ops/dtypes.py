"""uint16 at the storage boundary only.

torch's ``uint16`` covers storage, copies and casts, but most arithmetic
and reduction kernels (``amax``, ``maximum``, ``clamp``, ``bincount``,
shifts, ``rot90``) are not implemented for it.  Data movement on uint16
goes through a bit-identical ``int16`` view; arithmetic widens to int32.
"""

from __future__ import annotations

import torch


def widen(t: torch.Tensor) -> torch.Tensor:
    """uint16 / uint8 / integer tensor -> int32 with the same values."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def as_f32(t: torch.Tensor) -> torch.Tensor:
    """Integer (uint16 included) or float tensor -> float32 with the same
    values (a float64 value rounds to nearest)."""
    if t.dtype.is_floating_point:
        return t.to(torch.float32)
    return widen(t).to(torch.float32)


def as_int16(t: torch.Tensor) -> torch.Tensor:
    """Bit-identical int16 view of a uint16 tensor (for indexing, flips)."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def to_u16(t: torch.Tensor) -> torch.Tensor:
    """Values already in [0, 65535] (float: truncated) -> uint16."""
    return t.to(torch.int32).to(torch.uint16)

