"""Transversalium (row-gain striping) correction: the gain vector.

Counterpart of solex_ser_recon_en_tpu/pipeline/transversalium.py
(transversalium_gain, with _gain_from_mean_r and tukey_taper copied as
numpy).  reference: solex_util.py:383-516: inside the fitted circle, the
log-ratio of adjacent row strips measures the per-row gain steps; a
Savitzky-Golay smooth separates the brightness trend from the striping;
the cumulative detrended log-ratio, exponentiated and Tukey-tapered at the
band edges, is the per-row gain.

The image-sized row statistics run on the image's device
(ops/rowstats.py); the (H,)-vector math stays on the host in float64 with
scipy's savgol, as in the JAX package.  The gain multiply itself is fused
into the product step (pipeline/products.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from scipy.signal import savgol_filter

from ..ops.rowstats import row_log_ratio_stats, strip_mask


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


def transversalium_gain(
    img: torch.Tensor, circle, borders, trans_strength: int,
) -> Tuple[np.ndarray, int, int, np.ndarray]:
    """Per-row gain vector c (H,) and the correction band [y1, y2).

    Returns (c, y1, y2, correction_raw), correction_raw being the
    un-tapered correction over the band.
    """
    h, w = img.shape
    valid, _, _ = strip_mask(h, w, np.asarray(circle, dtype=np.float32),
                             np.asarray(borders, dtype=np.float32), img.device)
    _, mean_r = row_log_ratio_stats(img, valid)
    mean_r = mean_r.cpu().numpy().astype(np.float64)

    y1, y2 = _row_band(circle, borders)
    y1 = max(y1, 0)
    y2 = min(y2, h)
    c, correction = _gain_from_mean_r(mean_r, y1, y2, h, trans_strength)
    return c, y1, y2, correction
