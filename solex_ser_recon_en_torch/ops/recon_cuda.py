"""Pass B on the card: wrapper of kernel B3 (csrc/recon.cu).

Counterpart of solex_ser_recon_en_tpu/ops/pallas_recon.py (the Pallas recon
kernel).  A CUDA tensor launches the kernel; a CPU tensor takes the plain
version (ops/recon.py:recon_plain); any other device raises.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .recon import recon_plain


def recon(raw: torch.Tensor, ind_l: torch.Tensor, left_w: torch.Tensor,
          rotate: bool, upscale: bool) -> torch.Tensor:
    """raw (F, H, W) u16/u8 -> disks (S, ih, F) u16 (see recon_plain)."""
    if raw.device.type == "cpu":
        return recon_plain(raw, ind_l, left_w, rotate, upscale)
    if raw.device.type != "cuda":
        raise ValueError(f"recon: unsupported device {raw.device}")
    if raw.ndim != 3 or raw.dtype not in (torch.uint16, torch.uint8):
        raise TypeError(f"recon: raw must be (F, H, W) u16/u8, got "
                        f"{tuple(raw.shape)} {raw.dtype}")
    F, H, W = raw.shape
    ih, iw = (W, H) if rotate else (H, W)
    S = ind_l.shape[0]
    if ind_l.dtype != torch.int32 or tuple(ind_l.shape) != (S, ih):
        raise TypeError(f"recon: ind_l must be ({S}, {ih}) int32")
    if left_w.dtype != torch.float32 or tuple(left_w.shape) != (ih,):
        raise TypeError(f"recon: left_w must be ({ih},) float32")
    for name, t in (("raw", raw), ("ind_l", ind_l), ("left_w", left_w)):
        if t.device != raw.device or not t.is_contiguous():
            raise ValueError(f"recon: {name} must be contiguous on {raw.device}")
    if not 1 <= S <= 65535 or F == 0 or iw < 2:
        raise ValueError(f"recon: S={S}, F={F}, iw={iw} out of range")
    out = torch.empty((S, ih, F), dtype=torch.uint16, device=raw.device)
    with torch.cuda.device(raw.device):
        rc = cuda_build.lib().solex_recon(
            raw.data_ptr(), raw.element_size(), ind_l.data_ptr(),
            left_w.data_ptr(), out.data_ptr(), S, F, H, W, ih,
            int(rotate), int(upscale), cuda_build.stream_handle(raw.device),
        )
    cuda_build.check(rc, "recon")
    cuda_build.LAUNCHES["recon"] += 1
    return out
