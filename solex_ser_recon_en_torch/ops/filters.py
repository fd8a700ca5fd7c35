"""Mean filters used by the stubborn-transversalium path.

Counterpart of solex_ser_recon_en_tpu/ops/filters.py.  reference:
solex_util.py:293-323 — ``cv2.filter2D`` with (a) a (2*half_width+1,
linlen) ones kernel whose centre row is zeroed and (b) a (1, linlen) ones
kernel, both normalised and with BORDER_REFLECT_101.  Expressed as
separable window sums (ops/blur.py) on the image's device.

The image is taken as float32, as in the JAX package, and the result is
float32; the window sums themselves run in float64, as ``box_blur``'s do.
A float32 cumulative sum over a 2000-pixel row of log values loses 1e-4 of
a window mean, and how much depends on the order of summation: the card
and the CPU then disagree by up to 7 levels of a 16-bit pixel on a quarter
of the image.  In float64 the two agree, and both lie within float32
rounding of the exact filter.
"""

from __future__ import annotations

import torch

from .blur import _window_sum_1d


def mean_filter_hole(img: torch.Tensor, linlen: int, half_width: int
                     ) -> torch.Tensor:
    """Normalised correlation with ones((2hw+1, linlen)) minus its centre
    row -> float32."""
    f = img.to(torch.float32).to(torch.float64)
    row_sums = _window_sum_1d(f, linlen, f.ndim - 1)            # (H, W)
    full = _window_sum_1d(row_sums, 2 * half_width + 1, f.ndim - 2)
    hole = full - row_sums
    return (hole / (2 * half_width * linlen)).to(torch.float32)


def mean_filter_line(img: torch.Tensor, linlen: int) -> torch.Tensor:
    """Normalised correlation with ones((1, linlen)) -> float32."""
    f = img.to(torch.float32).to(torch.float64)
    return (_window_sum_1d(f, linlen, f.ndim - 1) / linlen).to(torch.float32)
