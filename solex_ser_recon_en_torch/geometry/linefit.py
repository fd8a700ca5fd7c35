"""Spectral-line detection and cubic fit on the mean image (host, numpy).

Counterpart of solex_ser_recon_en_tpu/geometry/linefit.py
(fit_spectral_line).  reference: solex_util.py:165-172 (detect_bord),
:191-274 (compute_mean_return_fit): blur the mean image, take the per-row
argmin as the line position, then a degree-3 polynomial fit with two
outlier-rejection rounds (3-sigma against the blurred fit, then a
mode-shift +/-5 px gate against the sharp argmin).

Runs on the host as in the JAX package: the mean image comes back from
pass A as a host integer array, and cubic fits over y up to 4096 need
float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..ops.blur import box_blur_u16_host


def detect_bord(img: np.ndarray, axis: int) -> Tuple[int, int]:
    """Object extent along the other axis from a 5x5-blurred projection
    (threshold = median/5 of the projected mean)."""
    blur = box_blur_u16_host(img, 5, 5)
    proj = np.mean(blur, axis=axis)
    threshold = np.median(proj) / 5
    where = proj > threshold
    if not where.any():
        return 0, img.shape[int(not axis)] - 1
    lb = int(np.argmax(where))
    ub = int(img.shape[int(not axis)] - 1 - np.argmax(where[::-1]))
    return lb, ub


@dataclass
class LineFit:
    """Cubic spectral-line fit and its diagnostics."""

    poly: np.ndarray          # [c0, c1, c2, c3], curve(y) = sum c_k y^k
    curve: np.ndarray         # (ih,) float64 line position per row
    floor: np.ndarray         # (ih,) int64 floor(curve)
    frac: np.ndarray          # (ih,) float64 fractional part
    y1: int
    y2: int
    # diagnostics for the _spectral_line_data.png plot
    sharp_min: np.ndarray = None
    mask_good: np.ndarray = None


def _polyfit3(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Degree-3 least squares, returned lowest-order-first (float64)."""
    return np.polyfit(y.astype(np.float64), x.astype(np.float64), 3)[::-1].copy()


def _polyval(p: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.polynomial.polynomial.polyval(y.astype(np.float64), p)


def fit_spectral_line(mean_img: np.ndarray, max_img: np.ndarray) -> LineFit:
    """Locate the absorption line on the mean image and fit a cubic."""
    ih, iw = mean_img.shape
    y1, y2 = detect_bord(max_img, axis=1)
    clip = int((y2 - y1) * 0.05)
    y1 = min(ih - 1, y1 + clip)
    y2 = max(0, y2 - clip)
    if y2 - y1 < 4:
        raise ValueError(f"sun vertical extent too small: y1={y1}, y2={y2}")

    bw_x = 25
    bw_y = max(1, int((y2 - y1) * 0.01))
    blurred = box_blur_u16_host(mean_img, bw_x, bw_y)
    half = bw_x // 2
    min_blur = half + np.argmin(blurred[:, half:-half], axis=1)

    ys = np.arange(y1, y2, dtype=np.float64)
    p = _polyfit3(ys, min_blur[y1:y2])

    # round 1: 3-sigma rejection against the blurred-argmin fit
    delta = _polyval(p, ys) - min_blur[y1:y2]
    std = np.std(delta)
    keep = np.abs(delta / std) < 3 if std > 0 else np.ones_like(delta, bool)
    p = _polyfit3(ys[keep], min_blur[y1:y2][keep])

    # round 2: mode shift + tolerance gate against the sharp argmin
    sharp = np.argmin(mean_img, axis=1)
    delta_sharp = _polyval(p, ys) - sharp[y1:y2]
    values, counts = np.unique(np.around(delta_sharp, 1), return_counts=True)
    shift = values[np.argmax(counts)]
    mask_good = np.abs(delta_sharp - shift) < 5  # tol_line_fit
    if mask_good.sum() >= 4:
        p = _polyfit3(ys[mask_good], sharp[y1:y2][mask_good])

    curve = _polyval(p, np.arange(ih))
    floor = np.floor(curve).astype(np.int64)
    return LineFit(
        poly=p,
        curve=curve,
        floor=floor,
        frac=curve - floor,
        y1=int(y1),
        y2=int(y2),
        sharp_min=sharp,
        mask_good=mask_good,
    )
