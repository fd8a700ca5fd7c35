"""De-vignetting.

Counterpart of solex_ser_recon_en_tpu/pipeline/vignette.py.  reference:
solex_util.py:590-654 (removeVignette) — 85th-percentile profiles along
both axes inside the circle (shrunk 65 px), savgol trends, axis-ratio
curve, NaN forward/backward fill, gaussian smooth, per-row multiply.

The two image-sized percentile profiles run on the frame's device, as a
float32 sort along each axis and a linear interpolation between the two
order statistics written out (``torch.quantile`` refuses inputs above 16 M
elements); the (H,)-vector trend math runs on the host in float64 with
scipy, as in the reference.  The result is float64 on the frame's device
and stays float until the product stage casts it.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d
from scipy.signal import savgol_filter

from ..ops.dtypes import as_f32, widen


def _percentile_along(f: torch.Tensor, q_pct: float, dim: int) -> torch.Tensor:
    """jnp.percentile(f, q_pct, axis=dim) of a float32 tensor, linear
    interpolation: the index arithmetic in float32 on the host, each step
    rounded (value_low * low_weight + value_high * high_weight)."""
    n = f.shape[dim]
    q = np.float32(q_pct) / np.float32(100)
    nf = np.float32(n)
    qn = q * (nf - np.float32(1))
    low = np.clip(np.floor(qn), np.float32(0), nf - np.float32(1))
    high = np.clip(np.ceil(qn), np.float32(0), nf - np.float32(1))
    high_w = qn - np.floor(qn)
    low_w = np.float32(1) - high_w
    s = torch.sort(f, dim=dim).values
    return (s.select(dim, int(low)) * float(low_w)
            + s.select(dim, int(high)) * float(high_w))


def _axis_percentiles(img: torch.Tensor):
    """85th percentile of every column and of every row, float32."""
    f = as_f32(img)
    return _percentile_along(f, 85.0, 0), _percentile_along(f, 85.0, 1)


def remove_vignette(frame: torch.Tensor, circle) -> torch.Tensor:
    """Returns the de-vignetted frame (float64, like the reference), or
    ``frame`` itself where the profiles are too short to correct.

    ``circle`` is the fitted (cx, cy, r) from the ellipse step; without a
    valid circle the caller must skip (Solex_recon.py:125-128).
    """
    y_arr, y_arr2 = (a.cpu().numpy().astype(np.float64)
                     for a in _axis_percentiles(frame))
    shrink = 65
    start1 = max(0, int(circle[0] - circle[2] + shrink))
    end1 = min(y_arr.shape[0], int(circle[0] + circle[2] + 1 - shrink))
    start2 = max(0, int(circle[1] - circle[2] + shrink))
    end2 = min(y_arr2.shape[0], int(circle[1] + circle[2] + 1 - shrink))

    y1 = y_arr[start1:end1]
    y2 = y_arr2[start2:end2]
    x1 = np.arange(y1.shape[0]) + start1 - int(circle[0])
    x2 = np.arange(y2.shape[0]) + start2 - int(circle[1])

    if y1.shape[0] < 20 or y2.shape[0] < 20:
        return frame  # not enough data (reference :606-608)

    scale_pix = int(min(y1.shape[0] // 2.75, y2.shape[0] // 2.75)) // 2 * 2 - 1
    trend1 = savgol_filter(y1, min(801, scale_pix), 3)
    trend2 = savgol_filter(y2, min(801, scale_pix), 3)

    mm = min(np.min(x1), np.min(x2))
    width = int(max(np.max(x1), np.max(x2)) - mm + 1)
    prof1 = np.full(width, np.nan)
    prof2 = np.full(width, np.nan)
    offsets = np.arange(width) + mm
    prof1[int(x1[0] - mm) : int(x1[-1] - mm + 1)] = trend1
    prof2[int(x2[0] - mm) : int(x2[-1] - mm + 1)] = trend2

    ratio_axes = prof1 / prof2
    ratio_axes[prof1 == 0] = np.nan
    ratio_axes[prof2 == 0] = np.nan

    correction = np.full(frame.shape[0], np.nan)
    idx = offsets.astype(int) + int(circle[1])
    ok = (idx >= 0) & (idx < frame.shape[0])
    correction[idx[ok]] = ratio_axes[ok]
    # forward then backward fill
    for i in range(1, len(correction)):
        if np.isnan(correction[i]):
            correction[i] = correction[i - 1]
    for i in range(len(correction) - 2, -1, -1):
        if np.isnan(correction[i]):
            correction[i] = correction[i + 1]
    if np.isnan(correction).any():
        return frame
    correction = gaussian_filter1d(correction, max(2, min(150, scale_pix // 4)))
    f64 = (widen(frame) if not frame.dtype.is_floating_point else frame).to(
        torch.float64)
    return f64 * torch.from_numpy(correction).to(frame.device)[:, None]
