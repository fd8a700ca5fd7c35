"""Separable warp for the pipeline's circularisation matrices: kernel B4.

Counterpart of solex_ser_recon_en_tpu/ops/warp_fast.py.  Every correction
matrix the pipeline builds has second row ``[0, 1, ty]``, so the bilinear
warp separates:

- vertical: ``sy = y + ty`` — per output row one integer row shift and one
  lerp weight: a row gather in plain torch;
- horizontal: per-row two-tap resample at ``sx = a*x + b*y + c``: kernel
  B4 (csrc/warp.cu) on CUDA, ``hresample_plain`` on the CPU.

The coordinate math and the vertical row lerp are the JAX package's
``_warp_unit_y`` expression for expression, in float32, so floors and
fractional weights round identically; only the separable evaluation order
differs from the four-term sum of ops/warp.py (~1 f32 ulp).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from .dtypes import widen

RB = 8      # row tile of the TPU kernel (window_for geometry)
XB = 128    # column tile of the TPU kernel (window_for geometry)
_MAX_WIN = 1024


def unit_y_row(mat3: np.ndarray) -> bool:
    """True when ``mat3`` is affine with second row [0, 1, ty] — the shape
    every pipeline correction matrix has."""
    m = np.asarray(mat3)
    return (
        m.shape == (3, 3)
        and m[1, 0] == 0.0
        and m[1, 1] == 1.0
        and m[2, 0] == 0.0
        and m[2, 1] == 0.0
        and m[2, 2] == 1.0
    )


def window_for(mat3: np.ndarray) -> int:
    """The JAX kernel's source-window width, or 0 when the horizontal scale
    is too extreme.  Kept as the routing gate so that both packages send
    the same matrices to the separable path."""
    a = abs(float(mat3[0, 0]))
    b = abs(float(mat3[0, 1]))
    span = a * (XB - 1) + b * (RB - 1) + 2.0 + 127.0
    win = int(-(-span // 128) * 128)
    return win if win <= _MAX_WIN else 0


def hresample_plain(V, loc, w0, w1, cadd) -> torch.Tensor:
    """Plain PyTorch version of kernel B4.

    V (K, H, Wp) f32; loc (H, OW) i32; w0, w1 (H, OW) f32; cadd (K, H, OW)
    f32 -> (K, H, OW) f32:  (V[loc]*w0 + V[loc+1]*w1) + cadd, a tap outside
    [0, Wp) contributing exactly 0."""
    K, H, Wp = V.shape
    zero = torch.zeros((), dtype=torch.float32, device=V.device)

    def tap(col, w):
        ok = (col >= 0) & (col < Wp)
        idx = col.clamp(0, Wp - 1).long().expand(K, -1, -1)
        return torch.where(ok, torch.gather(V, 2, idx) * w, zero)

    return (tap(loc, w0) + tap(loc + 1, w1)) + cadd


def hresample(V, loc, w0, w1, cadd) -> torch.Tensor:
    """Kernel B4 on CUDA tensors, ``hresample_plain`` on CPU tensors."""
    if V.device.type == "cpu":
        return hresample_plain(V, loc, w0, w1, cadd)
    if V.device.type != "cuda":
        raise ValueError(f"hresample: unsupported device {V.device}")
    K, H, Wp = V.shape
    OW = loc.shape[1]
    want = {"V": (V, torch.float32, (K, H, Wp)),
            "loc": (loc, torch.int32, (H, OW)),
            "w0": (w0, torch.float32, (H, OW)),
            "w1": (w1, torch.float32, (H, OW)),
            "cadd": (cadd, torch.float32, (K, H, OW))}
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise TypeError(f"hresample: {name} must be {shape} {dt}, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if t.device != V.device or not t.is_contiguous():
            raise ValueError(f"hresample: {name} must be contiguous on {V.device}")
    if not (0 < K <= 65535 and 0 < H <= 65535 and OW > 0):
        raise ValueError(f"hresample: K={K}, H={H}, OW={OW} out of range")
    out = torch.empty((K, H, OW), dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        rc = cuda_build.lib().solex_hresample(
            V.data_ptr(), loc.data_ptr(), w0.data_ptr(), w1.data_ptr(),
            cadd.data_ptr(), out.data_ptr(), K, H, Wp, OW,
            cuda_build.stream_handle(V.device),
        )
    cuda_build.check(rc, "hresample")
    cuda_build.count_launch("hresample")
    return out


def warp_inputs(images_f01: torch.Tensor, mat3: np.ndarray, out_h: int,
                out_w: int, cval: torch.Tensor):
    """The separable warp up to the horizontal pass: (V, loc, w0, w1, cadd).

    images_f01 (K, h, w_in) f32; cval (K,) f32 on the [0, 1) scale."""
    K, h, w_in = images_f01.shape
    dev = images_f01.device
    m = torch.as_tensor(np.asarray(mat3), dtype=torch.float32, device=dev)
    cval_f = cval.to(torch.float32).reshape(K, 1, 1)

    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    sx = m[0, 0] * gx + m[0, 1] * gy + m[0, 2]
    sy_col = m[1, 0] * xs[:1] + m[1, 1] * ys + m[1, 2]   # x-independent
    w = m[2, 0] * gx + m[2, 1] * gy + m[2, 2]            # == 1.0 everywhere
    sx = sx / w
    x0 = torch.floor(sx)
    dx = sx - x0
    x0i = x0.to(torch.int32)
    y0 = torch.floor(sy_col)
    dy = (sy_col - y0)[:, None]
    y0i = y0.to(torch.int32)

    # vertical pass: a row gather and one lerp per output row
    ok0 = ((y0i >= 0) & (y0i < h))[:, None]
    ok1 = ((y0i + 1 >= 0) & (y0i + 1 < h))[:, None]
    r0 = images_f01.index_select(1, y0i.clamp(0, h - 1).long())
    r1 = images_f01.index_select(1, (y0i + 1).clamp(0, h - 1).long())
    V = (
        torch.where(ok0, r0, cval_f) * (1.0 - dy)
        + torch.where(ok1, r1, cval_f) * dy
    )                                                    # (K, out_h, w_in)

    # horizontal tap weights; invalid taps contribute cval instead
    val0 = ((x0i >= 0) & (x0i < w_in)).to(torch.float32)
    val1 = ((x0i + 1 >= 0) & (x0i + 1 < w_in)).to(torch.float32)
    w0 = (1.0 - dx) * val0
    w1 = dx * val1
    cadd = cval_f * ((1.0 - dx) * (1.0 - val0) + dx * (1.0 - val1))
    # x0i stays unclipped: out-of-image taps carry zero weight
    return V.contiguous(), x0i.contiguous(), w0, w1, cadd.contiguous()


def warp_unit_y_u16(images_u16: torch.Tensor, mat3: np.ndarray, out_h: int,
                    out_w: int, cval: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Separable warp of uint16 images (K, h, w) or (h, w) scaled by
    1/65536 -> float32 [0, 1) of shape (K, out_h, out_w) or (out_h, out_w).

    ``cval`` (K,) on the [0, 1) scale; None uses each image's own [0, 0]
    pixel (the per-image cval of the reference's sequential loop).  Caller
    checks ``unit_y_row`` and ``window_for`` first."""
    if not window_for(mat3):
        raise ValueError("horizontal scale too extreme for the separable warp")
    single = images_u16.ndim == 2
    imgs = images_u16[None] if single else images_u16
    f01 = widen(imgs).to(torch.float32) * np.float32(1 / 65536)
    if cval is None:
        cval = f01[:, 0, 0]
    out = hresample(*warp_inputs(f01, mat3, out_h, out_w, cval))
    return out[0] if single else out
