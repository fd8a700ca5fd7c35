"""Projective image warp (inverse map, bilinear, constant cval).

Counterpart of solex_ser_recon_en_tpu/ops/warp.py.  reference:
ellipse_to_circle.py:112-114 — ``skimage.transform.warp`` with the 3x3
correction matrix (maps OUTPUT (x, y) = (col, row) to INPUT coordinates),
bilinear, ``cval = image[0, 0]``.

``warp_projective`` is the general four-term path on a float image;
``warp_projective_u16`` runs it on a uint16 image scaled by 1/65536, and is
taken for matrices the separable kernel (ops/warp_fast.py) refuses.  Same
float32 expressions as the JAX package, so tap positions and weights round
identically.

``warp_host_u16`` is the ``host`` feed's warp: the native library's, on
host arrays (the numpy twin ``warp_host_u16_plain`` beside it).
"""

from __future__ import annotations

import numpy as np
import torch

from .dtypes import to_u16, widen


def _grid(mat3: np.ndarray, out_h: int, out_w: int, device):
    """Output pixel grid mapped through ``mat3`` in float32: (sx, sy)."""
    xs = torch.arange(out_w, dtype=torch.float32, device=device)
    ys = torch.arange(out_h, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    m = torch.as_tensor(np.asarray(mat3), dtype=torch.float32, device=device)
    sx = m[0, 0] * gx + m[0, 1] * gy + m[0, 2]
    sy = m[1, 0] * gx + m[1, 1] * gy + m[1, 2]
    w = m[2, 0] * gx + m[2, 1] * gy + m[2, 2]
    return sx / w, sy / w


def warp_projective(image: torch.Tensor, mat3: np.ndarray, out_h: int,
                    out_w: int, cval: float = 0.0) -> torch.Tensor:
    """Warp a float image (h, w) by the inverse map ``mat3`` -> float32
    (out_h, out_w).  Each of the four neighbours contributes ``cval`` when
    it falls outside the image (scipy/skimage 'constant')."""
    h, w_in = image.shape
    sx, sy = _grid(mat3, out_h, out_w, image.device)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    dx = sx - x0
    dy = sy - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    flat = image.to(torch.float32).reshape(-1)
    cv = torch.tensor(cval, dtype=torch.float32, device=image.device)

    def sample(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w_in)
        idx = yi.clamp(0, h - 1).long() * w_in + xi.clamp(0, w_in - 1).long()
        return torch.where(valid, flat[idx], cv)

    return (
        sample(y0i, x0i) * (1 - dy) * (1 - dx)
        + sample(y0i, x0i + 1) * (1 - dy) * dx
        + sample(y0i + 1, x0i) * dy * (1 - dx)
        + sample(y0i + 1, x0i + 1) * dy * dx
    )


def warp_projective_u16(image_u16: torch.Tensor, mat3: np.ndarray,
                        out_h: int, out_w: int, cval: float = 0.0
                        ) -> torch.Tensor:
    """Warp a uint16 image scaled by 1/65536 -> float32 [0, 1) image
    (``cval`` on the [0, 1) scale)."""
    image = widen(image_u16).to(torch.float32) * np.float32(1 / 65536)
    return warp_projective(image, mat3, out_h, out_w, cval)


def warp_to_u16(warped01: torch.Tensor) -> torch.Tensor:
    """float [0,1) image -> uint16 like the reference's ``2**16 * img`` cast
    (ellipse_to_circle.py:115-118), clipped instead of wrapped."""
    return to_u16(torch.clamp(warped01 * 65536.0, 0, 65535))


def warp_host_u16(image: np.ndarray, mat3: np.ndarray, out_h: int,
                  out_w: int, cval: float, out: np.ndarray = None
                  ) -> np.ndarray:
    """The host pipeline's warp straight to uint16 (the ``host`` feed):
    the native kernel (io/native.py:warp_u16, ``warp_u16_u16`` for a
    uint16 image taken /65536, ``warp_f32_u16`` for a float32 [0, 1) one),
    bit-identical to ``warp_host_u16_plain``.  ``cval`` is on the [0, 1)
    scale; ``out`` receives the result in place when given.

    Counterpart of solex_ser_recon_en_tpu/ops/warp.py:warp_host_u16.
    """
    from ..io.native import warp_u16

    if image.dtype != np.uint16:
        image = image.astype(np.float32, copy=False)
    return warp_u16(image, mat3, out_h, out_w, cval, out=out)


def warp_host_u16_plain(image: np.ndarray, mat3: np.ndarray, out_h: int,
                        out_w: int, cval: float) -> np.ndarray:
    """numpy twin of ``warp_host_u16`` (ops/warp_host.py: the float32
    four-term bilinear and the clipped u16 store)."""
    from .warp_host import warp_projective_host, warp_to_u16_host

    if image.dtype == np.uint16:
        image = image.astype(np.float32) / 65536.0
    return warp_to_u16_host(warp_projective_host(image, mat3, out_h, out_w,
                                                 cval))
