"""Canny edge detection on the device.

Counterpart of solex_ser_recon_en_tpu/ops/canny.py.  reference:
ellipse_to_circle.py:244-250 — skimage.feature.canny(sigma=2, thresholds
from the image median) on the flooded (0/65000) downscaled disk; the
consumer is an outlier-robust ellipse fit, so only the blob outline
matters.

Gaussian blur (shifted multiply-adds, constant padding, divided by the
blurred support mask as skimage does) -> Sobel gradients (shifted
multiply-adds, reflect borders) -> quantised-direction non-maximum
suppression -> double threshold -> hysteresis by masked dilation, looped
in Python until a fixed point.  Float32 elementwise arithmetic in the JAX
package's order; no convolution (cuDNN would use TF32 on CUDA).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel_1d(sigma: float) -> np.ndarray:
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d(img: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    r = len(k) // 2
    pad = [0, 0, 0, 0]
    pad[2 * (1 - dim): 2 * (1 - dim) + 2] = [r, r]   # F.pad: last dim first
    xp = F.pad(img, pad)
    n = img.shape[dim]
    out = torch.zeros_like(img)
    for i in range(len(k)):
        out = out + float(k[i]) * xp.narrow(dim, i, n)
    return out


def _reflect_pad1(img: torch.Tensor) -> torch.Tensor:
    """jnp.pad(img, 1, mode="reflect") for a 2-D tensor."""
    img = torch.cat([img[1:2], img, img[-2:-1]], dim=0)
    return torch.cat([img[:, 1:2], img, img[:, -2:-1]], dim=1)


def _sobel(img: torch.Tensor):
    """ndi.sobel-compatible gradients with reflect borders."""
    smooth = (1.0, 2.0, 1.0)
    deriv = (-1.0, 0.0, 1.0)
    h, w = img.shape

    def sep(ky, kx):
        pad = _reflect_pad1(img)
        rows = 0
        for i in range(3):
            rows = rows + ky[i] * pad.narrow(0, i, h)
        out = 0
        for i in range(3):
            out = out + kx[i] * rows.narrow(1, i, w)
        return out

    return sep(deriv, smooth), sep(smooth, deriv)   # d/dy, d/dx


def _shift(p: torch.Tensor, dy: int, dx: int, shape) -> torch.Tensor:
    return p[1 + dy: 1 + dy + shape[0], 1 + dx: 1 + dx + shape[1]]


def _dilate(m: torch.Tensor) -> torch.Tensor:
    p = F.pad(m.to(torch.uint8), (1, 1, 1, 1)).bool()
    acc = m
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc | _shift(p, dy, dx, m.shape)
    return acc


def canny(image: torch.Tensor, sigma: float = 2.0,
          low_threshold: float = 0.1, high_threshold: float = 0.2
          ) -> torch.Tensor:
    """Boolean edge map (H, W) on ``image``'s device."""
    img = image.to(torch.float32)
    k = _gaussian_kernel_1d(sigma)
    sm = _conv1d(_conv1d(img, k, 0), k, 1)
    ones = torch.ones_like(img)
    norm = _conv1d(_conv1d(ones, k, 0), k, 1)
    sm = sm / torch.clamp(norm, min=1e-12)

    gy, gx = _sobel(sm)
    mag = torch.hypot(gy, gx)

    # non-maximum suppression over 4 quantised gradient directions
    ang = torch.atan2(gy, gx)                                   # [-pi, pi]
    ang = torch.where(ang < 0, ang + math.pi, ang)              # [0, pi)
    sector = torch.floor_divide(ang + math.pi / 8, math.pi / 4).to(
        torch.int32) % 4

    pad = F.pad(mag, (1, 1, 1, 1))

    def nb(dy, dx):
        return _shift(pad, dy, dx, mag.shape)

    neighbours = [
        (nb(0, 1), nb(0, -1)),    # sector 0: horizontal gradient
        (nb(1, 1), nb(-1, -1)),   # sector 1: diagonal
        (nb(1, 0), nb(-1, 0)),    # sector 2: vertical
        (nb(1, -1), nb(-1, 1)),   # sector 3: anti-diagonal
    ]
    keep = torch.zeros(mag.shape, dtype=torch.bool, device=mag.device)
    for s, (a, b) in enumerate(neighbours):
        keep = keep | ((sector == s) & (mag >= a) & (mag >= b))
    border = torch.zeros_like(keep)
    border[1:-1, 1:-1] = True
    # tiny absolute magnitude floor: a constant image yields no edges
    keep = keep & border & (mag > 1e-3)

    low = keep & (mag >= low_threshold)
    cur = _dilate(keep & (mag >= high_threshold)) & low
    # hysteresis: grow the strong edges through the weak mask
    while True:
        nxt = _dilate(cur) & low
        if torch.equal(nxt, cur):
            return cur
        cur = nxt
