"""Separable box blur with OpenCV-compatible semantics.

Counterpart of solex_ser_recon_en_tpu/ops/blur.py.  cv2.blur is a
normalised box filter with BORDER_REFLECT_101 edges and, for integer
images, round-half-to-even output.

- ``box_blur`` (device, float tensors): window sums as differences of
  float64 cumulative sums, exact for the ellipse-fit inputs (block means of
  u16/65536 values).  Never a convolution: on CUDA, cuDNN would run a
  float32 convolution in TF32.
- ``box_blur_host`` / ``box_blur_u16_host`` (host, integer images): the
  line fit's blur on the host mean image, bit-identical to the device
  program.  2-D uint16 images go through the native library's one-pass
  blur (io/native.py:box_blur_u16) wherever its domain holds
  (``box_blur_u16_fits``: the reflected border fits inside the image, and
  kx * ky <= 32767).  Outside that domain, and for other integer dtypes or
  ranks, the numpy twin below runs: that split is by the input alone.  A
  library that cannot be built raises; numpy never stands in for it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.native import box_blur_u16 as native_box_blur_u16
from ..io.native import box_blur_u16_fits


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of a BORDER_REFLECT_101 padding by (lo, hi)."""
    i = torch.arange(-lo, n + hi, device=device)
    period = 2 * (n - 1) if n > 1 else 1
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _window_sum_1d(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sliding-window sum of width k along ``dim`` (cv2 anchor k//2)."""
    if k <= 1:
        return x
    lo, hi = k // 2, k - 1 - k // 2
    n = x.shape[dim]
    xp = x.index_select(dim, _reflect_index(n, lo, hi, x.device))
    c = torch.cumsum(xp, dim=dim, dtype=x.dtype)
    zshape = list(c.shape)
    zshape[dim] = 1
    c = torch.cat([torch.zeros(zshape, dtype=c.dtype, device=c.device), c],
                  dim=dim)
    return c.narrow(dim, k, n) - c.narrow(dim, 0, n)


def box_blur(img: torch.Tensor, kx: int, ky: int) -> torch.Tensor:
    """Box mean filter of a float image, kx columns wide x ky rows tall ->
    float32."""
    s = _window_sum_1d(img.to(torch.float64), ky, img.ndim - 2)
    s = _window_sum_1d(s, kx, img.ndim - 1)
    # a divisor on the image's device: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which can round the other way
    k = torch.full((), kx * ky, dtype=torch.float32, device=img.device)
    return s.to(torch.float32) / k


# --- host twin for the line fit (integer numpy images) ---------------------


def _window_sum_1d_host(x: np.ndarray, k: int, axis: int,
                        acc_dtype) -> np.ndarray:
    if k <= 1:
        return x.astype(acc_dtype)
    lo, hi = k // 2, k - 1 - k // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (lo, hi)
    xp = np.pad(x, pad, mode="reflect")
    c = np.cumsum(xp.astype(acc_dtype), axis=axis)
    zshape = list(c.shape)
    zshape[axis] = 1
    c = np.concatenate([np.zeros(zshape, c.dtype), c], axis=axis)
    n = x.shape[axis]
    sl_hi = [slice(None)] * c.ndim
    sl_lo = [slice(None)] * c.ndim
    sl_hi[axis] = slice(k, k + n)
    sl_lo[axis] = slice(0, n)
    return c[tuple(sl_hi)] - c[tuple(sl_lo)]


def _native_takes(img: np.ndarray, kx: int, ky: int) -> bool:
    return (img.dtype == np.uint16 and img.ndim == 2
            and box_blur_u16_fits(img.shape, kx, ky))


def box_blur_host_plain(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    """numpy box blur of an INTEGER image (exact int32 sums) -> float32:
    the plain version of ``box_blur_host``."""
    if not np.issubdtype(img.dtype, np.integer):
        raise TypeError("box_blur_host is exact for integer inputs only")
    s = _window_sum_1d_host(img, ky, img.ndim - 2, np.int32)
    s = _window_sum_1d_host(s, kx, img.ndim - 1, np.int32)
    k = kx * ky
    q = s // k
    r = s - q * k
    return q.astype(np.float32) + r.astype(np.float32) / np.float32(k)


def box_blur_u16_host_plain(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    """The plain version of ``box_blur_u16_host``."""
    out = box_blur_host_plain(img, kx, ky)
    return np.clip(np.round(out), 0, 65535).astype(np.uint16)


def box_blur_host(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    """Box blur of an INTEGER host image (exact int32 sums) -> float32;
    native for 2-D uint16 images inside ``box_blur_u16_fits``."""
    if _native_takes(img, kx, ky):
        return native_box_blur_u16(img, kx, ky, "f32")
    return box_blur_host_plain(img, kx, ky)


def box_blur_u16_host(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    """uint16 box blur with cv2's round-half-to-even output; native for
    2-D uint16 images inside ``box_blur_u16_fits``."""
    if _native_takes(img, kx, ky):
        return native_box_blur_u16(img, kx, ky, "u16")
    return box_blur_u16_host_plain(img, kx, ky)
