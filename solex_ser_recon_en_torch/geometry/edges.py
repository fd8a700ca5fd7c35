"""Limb edge extraction: flood threshold + Canny + region/hull filtering.

Counterpart of solex_ser_recon_en_tpu/geometry/edges.py.  reference:
ellipse_to_circle.py:148-291.  The image-sized work (box blurs, Canny)
runs on ``device`` (the CPU when the feed puts the small ops there,
utils/placement.py:small_ops_device); the small point-set work (histogram
threshold search, connected-component labelling, convex hull) runs on the
host with scipy, as in the JAX package.  A blob of ``HOST_CANNY_MAX_PX``
pixels or fewer takes the numpy/scipy Canny (ops/canny_host.py) on every
feed: the choice is by size only, so every feed of a scan finds the same
edges.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import scipy.ndimage
import torch
from scipy.spatial import ConvexHull

from ..ops.blur import box_blur
from ..ops.canny import canny
from ..ops.canny_host import canny as canny_host

NUM_REG = 2  # include biggest NUM_REG regions (ellipse_to_circle.py:31)
#: blobs of this many pixels or fewer take the host Canny (JAX
#: geometry/edges.py:113-122: a launch's latency dwarfs their math)
HOST_CANNY_MAX_PX = 65536


def _blur(img: np.ndarray, kx: int, ky: int, device) -> np.ndarray:
    """Box blur of a host float image on ``device`` -> host float32."""
    if kx <= 1 and ky <= 1:
        return np.asarray(img, dtype=np.float32)
    t = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    return box_blur(t.to(device), kx, ky).cpu().numpy()


def downscale_local_mean(image: np.ndarray, factor: int) -> np.ndarray:
    """Block-mean downscale, zero-padding ragged edges (skimage semantics).

    reference consumer: ellipse_to_circle.py:301 (the pipeline downscales
    on the device, geometry/correct.py:downscale_mean; the reference
    replica, utils/cpu_reference.py, takes this numpy one)
    """
    h, w = image.shape
    ph = (-h) % factor
    pw = (-w) % factor
    if ph or pw:
        image = np.pad(image, ((0, ph), (0, pw)), mode="constant")
    H, W = image.shape
    return image.reshape(H // factor, factor, W // factor, factor).mean(axis=(1, 3))


def flood_threshold(image: np.ndarray, device):
    """Binarisation threshold from a cubic fit of the brightness histogram.

    reference: ellipse_to_circle.py:148-228 (get_flood_image) — find the
    local minimum of a cubic fit to the (sub-very-bright) histogram, walk
    downhill to the nearest histogram valley, back off one bin; fall back to
    0.9*mean when the cubic has no local minimum or the bin search fails.
    Returns (threshold, blurred image).
    """
    mean_thresh = 0.9 * float(np.sum(image)) / image.size
    bw = max(1, int(image.shape[0] * 0.01))
    blurred = _blur(image, bw, bw, device)

    very_bright = np.percentile(blurred, 99)
    data = blurred.ravel()
    data = data[data < very_bright]
    n, bins = np.histogram(data, bins=20)

    coef = np.polynomial.polynomial.Polynomial.fit(bins[1:], n, 3).convert().coef
    if len(coef) < 4 or coef[3] == 0:
        thresh2 = mean_thresh
    else:
        d_, c_, b_, a_ = coef
        disc = 4 * b_ * b_ - 12 * a_ * c_
        thresh2 = (-2 * b_ + math.sqrt(disc)) / (6 * a_) if disc >= 0 else mean_thresh

    start_i = -1
    for i in range(len(bins) - 1):
        if bins[i] <= thresh2 < bins[i + 1]:
            start_i = i
    if start_i == -1:
        return mean_thresh, blurred
    i = start_i
    while 0 < i < len(bins) - 2:
        if n[i - 1] < n[i]:
            i -= 1
        elif n[i + 1] < n[i]:
            i += 1
        else:
            break
    if i >= 1:
        i -= 1  # make the blob slightly bigger
    return float(bins[i]), blurred


def get_flood_image(image: np.ndarray, device) -> np.ndarray:
    thresh, blurred = flood_threshold(image, device)
    return np.where(blurred < thresh, 0.0, 65000.0).astype(np.float32)


def get_edge_list(image: np.ndarray, device, sigma: float = 2.0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Edge points (filtered, raw) of the solar limb, (row, col) like
    np.argwhere.  Retries with smaller sigma when nothing is found."""
    while sigma > 0:
        low = float(np.median(_blur(image, 5, 5, device))) / 10
        high = low * 1.5
        flooded = get_flood_image(image, device)
        if flooded.size <= HOST_CANNY_MAX_PX:
            edges = canny_host(flooded, sigma=float(sigma),
                               low_threshold=low, high_threshold=high)
        else:
            edges = canny(torch.from_numpy(flooded).to(device),
                          sigma=float(sigma), low_threshold=low,
                          high_threshold=high).cpu().numpy()
        raw_X = np.argwhere(edges)
        labelled, nf = scipy.ndimage.label(edges, structure=np.ones((3, 3)))
        if nf > 0:
            break
        sigma -= 0.5
    else:
        raise ValueError("could not find any edges")

    sizes = scipy.ndimage.sum_labels(edges, labelled, index=np.arange(1, nf + 1))
    big = 1 + np.argsort(sizes)[::-1][: min(nf, NUM_REG)]
    filt = np.isin(labelled, big)

    X = np.argwhere(filt)
    hull_pts = X[ConvexHull(X).vertices]
    hull_mask = np.zeros(edges.shape, bool)
    hull_mask[hull_pts[:, 0], hull_pts[:, 1]] = True
    keep = [lbl for lbl in big if np.any(hull_mask & (labelled == lbl))]
    filt = np.isin(labelled, keep)

    x_min, x_max = X[:, 0].min(), X[:, 0].max()
    crop = 0.017
    dx = x_max - x_min
    mask = np.zeros(filt.shape, bool)
    mask[int(x_min + dx * crop) : int(x_max - dx * crop), :] = True
    filt &= mask
    X = np.argwhere(filt).astype(np.float64)
    if X.shape[0] < 6:
        raise ValueError("too few limb edge points for an ellipse fit")
    return X, raw_X.astype(np.float64)
