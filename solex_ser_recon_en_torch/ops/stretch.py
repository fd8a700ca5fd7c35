"""Brightness rescaling, plain torch on the image's device.

Counterpart of solex_ser_recon_en_tpu/ops/stretch.py (no Pallas kernel
there).  reference: solex_util.py:519-525 (rescale_brightness).  The JAX
module's ``percentile`` is not ported: nothing calls it (the CLAHE tool
takes ``np.percentile``, as the JAX tool does).
"""

from __future__ import annotations

import numpy as np
import torch

from .dtypes import as_f32


def rescale_brightness(img: torch.Tensor, lo, hi, alpha: float = 1.0
                       ) -> torch.Tensor:
    """Linear stretch of a uint8/uint16 image to [0, dtype max], clipped
    and truncated, in the JAX package's float32 order:
    ``sat * alpha * (img - lo) / (hi - lo)``.

    The divisor is a tensor on the image's device: torch's CUDA division
    by a host scalar multiplies by its reciprocal, which rounds otherwise
    than the CPU's division.
    """
    sat = 65535 if img.dtype == torch.uint16 else 255
    if not (sat >= hi > lo):
        raise ValueError(f"need sat >= hi > lo, got {sat} >= {hi} > {lo}")
    lo32, hi32 = np.float32(lo), np.float32(hi)
    gain = np.float32(sat) * np.float32(alpha)
    dev = img.device
    x = (torch.tensor(gain, device=dev) * (as_f32(img) - float(lo32))
         ) / torch.tensor(hi32 - lo32, device=dev)
    x = torch.clamp(x, 0, sat).to(torch.int32)
    return x.to(torch.uint16 if sat > 255 else torch.uint8)

