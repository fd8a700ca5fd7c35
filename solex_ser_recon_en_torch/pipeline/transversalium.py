"""Transversalium (row-gain striping) correction.

Counterpart of solex_ser_recon_en_tpu/pipeline/transversalium.py: the device
branches of transversalium_gain and correct_transversalium, stubborn_filter, and numpy copies of
_gain_from_mean_r, tukey_taper and fix_edge_effect.  reference:
solex_util.py:383-516 (correct_transversalium2), :277-354 (apply_lin_filter,
the "stubborn" variant) and :357-375 (fix_edge_effect): inside the fitted
circle, the log-ratio of adjacent row strips measures the per-row gain
steps; a Savitzky-Golay smooth separates the brightness trend from the
striping; the cumulative detrended log-ratio, exponentiated and
Tukey-tapered at the band edges, is the per-row gain.

The image-sized work (masked per-row robust log-ratio means, the row
multiply, the stubborn variant's mean filters) runs on the image's device
(ops/rowstats.py, ops/filters.py); the (H,)-vector math stays on the host in
float64 with scipy's savgol, as in the JAX package.  On the fused branch of
pipeline/run.py the gain multiply itself runs inside the product step
(pipeline/products.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from scipy.signal import savgol_filter

from ..ops.filters import mean_filter_hole, mean_filter_line
from ..ops.dtypes import widen
from ..ops.rowstats import apply_row_gain, row_log_ratio_stats, strip_mask


def tukey_taper(n: int, a: float = 0.05) -> np.ndarray:
    """The reference's Tukey taper (solex_util.py:456-470), vectorised."""
    x = np.arange(n, dtype=np.float64)
    x = np.minimum(x, n - x)  # fold: t(x) = t(N - x) for x > N/2
    ramp = 0.5 * (1 - np.cos(2 * np.pi * x / (a * n)))
    return np.where(x < a * n / 2, ramp, 1.0)


def _row_band(circle, borders) -> Tuple[int, int]:
    y1 = math.ceil(max(circle[1] - circle[2], borders[1]))
    y2 = math.floor(min(circle[1] + circle[2], borders[3]))
    return y1, y2


def _gain_from_mean_r(
    mean_r: np.ndarray, y1: int, y2: int, h: int, trans_strength: int
) -> Tuple[np.ndarray, np.ndarray]:
    """savgol detrend + cumsum + Tukey taper (solex_util.py:396-470)."""
    # reference builds y_ratios_r = [0] + [rows y1+1 .. y2-1]
    y_ratios_r = np.zeros(y2 - y1, dtype=np.float64)
    y_ratios_r[1:] = mean_r[y1 + 1 : y2]

    n = len(y_ratios_r)
    if n < 7:
        return np.ones(h), np.ones(n)

    window = min(trans_strength, n // 2 * 2 - 1)
    trend = savgol_filter(y_ratios_r, window, 3)
    detrended = y_ratios_r - trend
    detrended -= np.mean(detrended)
    correction = np.exp(-np.cumsum(detrended))

    correction_t = 1.0 + (correction - 1.0) * tukey_taper(n)
    c = np.ones(h, dtype=np.float64)
    c[y1:y2] = correction_t
    return c, correction


def _valid_mask(shape, circle, borders, device) -> torch.Tensor:
    h, w = shape
    valid, _, _ = strip_mask(h, w, np.asarray(circle, dtype=np.float32),
                             np.asarray(borders, dtype=np.float32), device)
    return valid


def _clipped_band(circle, borders, h: int) -> Tuple[int, int]:
    y1, y2 = _row_band(circle, borders)
    return max(y1, 0), min(y2, h)


def transversalium_gain(
    img: torch.Tensor, circle, borders, trans_strength: int,
) -> Tuple[np.ndarray, int, int, np.ndarray]:
    """Per-row gain vector c (H,) and the correction band [y1, y2).

    ``img`` is a uint16 image, or a float one (the de-vignetted frame).
    Returns (c, y1, y2, correction_raw), correction_raw being the
    un-tapered correction over the band (used by the stubborn variant).
    """
    h = img.shape[0]
    _, mean_r = row_log_ratio_stats(
        img, _valid_mask(img.shape, circle, borders, img.device))
    mean_r = mean_r.cpu().numpy().astype(np.float64)
    y1, y2 = _clipped_band(circle, borders, h)
    c, correction = _gain_from_mean_r(mean_r, y1, y2, h, trans_strength)
    return c, y1, y2, correction


def fix_edge_effect(mult: np.ndarray, circle, linlen: int) -> np.ndarray:
    """Zero/extend the stubborn multiplier outside the disk circle.

    reference: solex_util.py:357-375 — vectorised over rows instead of the
    Python loop; identical per-row semantics (zero outside the chord, hold
    the value half a window in from each limb, skip rows narrower than
    linlen).
    """
    h, w = mult.shape
    cx, cy, r = circle[0], circle[1], circle[2]
    y1 = math.ceil(max(cy - r, 0))
    y2 = math.floor(min(cy + r, h - 1))
    halflen = linlen // 2
    out = np.array(mult, dtype=np.float64)
    out[:y1, :] = 0
    out[y2 + 1 :, :] = 0
    ys = np.arange(h)
    band = (ys >= y1) & (ys < y2)
    d2 = r * r - (ys - cy) ** 2
    dx = np.floor(np.sqrt(np.maximum(d2, 0.0)))
    x2v = np.floor(np.minimum(cx + dx, w - 1)).astype(int)
    x1v = np.ceil(np.maximum(cx - dx, 0)).astype(int)
    xs = np.arange(w)[None, :]
    bandm = band[:, None]
    out[bandm & ((xs < x1v[:, None]) | (xs >= x2v[:, None]))] = 0
    wide = band & (x2v - x1v >= linlen)
    left_src = np.clip(x1v + halflen, 0, w - 1)
    right_src = np.clip(x2v - halflen - 1, 0, w - 1)
    left_vals = out[ys, left_src][:, None]
    right_vals = out[ys, right_src][:, None]
    fill_left = wide[:, None] & (x1v[:, None] > 0) & (xs >= x1v[:, None]) & (
        xs < x1v[:, None] + halflen
    )
    fill_right = (
        wide[:, None]
        & (x2v[:, None] < w - 1)
        & (xs >= x2v[:, None] - halflen)
        & (xs < x2v[:, None])
    )
    out = np.where(fill_left, left_vals, out)
    out = np.where(fill_right, right_vals, out)
    return out


def stubborn_filter(
    img: torch.Tensor,
    spurious: np.ndarray,
    y1: int,
    y2: int,
    circle,
    linlen: int = 101,
    half_width: int = 5,
) -> np.ndarray:
    """The stubborn-transversalium image filter -> uint16 host array.

    reference: solex_util.py:277-354 (apply_lin_filter, live path only).
    The log image, the fill of spurious rows and the final multiply are
    float64 on the host, as in the JAX package; the two big mean filters
    run in float32 on the image's device (ops/filters.py).
    """
    device = img.device
    img = (img if img.dtype.is_floating_point else widen(img)).cpu().numpy()
    logimg = np.log(np.maximum(img.astype(np.float64), 1e-12))

    # fill spurious rows with the mean of the nearest good rows above/below
    filt2 = logimg.copy()
    prev = np.zeros(img.shape[1])
    for i in range(img.shape[0]):
        if spurious[i]:
            filt2[i, :] = prev / 2
        else:
            prev = filt2[i, :]
    prev = np.zeros(img.shape[1])
    for i in range(img.shape[0] - 1, -1, -1):
        if spurious[i]:
            filt2[i, :] += prev / 2
        else:
            prev = filt2[i, :]

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.float32)).to(device)

    result3 = mean_filter_hole(on_device(filt2), linlen, half_width)
    result4 = mean_filter_line(on_device(logimg), linlen)
    delta = (result4 - result3).cpu().numpy()

    n = y2 - y1
    c = np.zeros(img.shape[0])
    c[y1:y2] = tukey_taper(n)

    delta = fix_edge_effect(delta, circle, linlen + 20)
    out = img.astype(np.float64) * np.exp(-delta * c.reshape(-1, 1))
    return np.minimum(out, 65535).astype(np.uint16)


def correct_transversalium(
    img: torch.Tensor,
    circle,
    borders,
    trans_strength: int = 301,
    stubborn: bool = False,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Apply the transversalium correction; returns (uint16 image on the
    image's device, gain c).  ``img`` is uint16, or float after
    de-vignetting.

    reference: solex_util.py:383-516.  When no circle is available the
    caller passes the backup band as in Solex_recon.py:145-146.
    """
    c, y1, y2, correction = transversalium_gain(img, circle, borders,
                                                trans_strength)
    if stubborn:
        logc = np.log(np.maximum(correction, 1e-300))
        thresh = np.std(logc) * 2.5
        flag = np.zeros(img.shape[0], dtype=bool)
        band_flag = np.abs(logc) > thresh
        flag[y1:y2] = band_flag
        flag = flag | np.roll(flag, -1) | np.roll(flag, 1)
        out = stubborn_filter(img, flag, y1, y2, circle)
        return torch.from_numpy(out).to(img.device), c
    gain = torch.as_tensor(c, dtype=torch.float32, device=img.device)
    return apply_row_gain(img, gain), c
