"""Canny edge detection — jax-free numpy/scipy twin of ops/canny.py.

Two consumers:
- geometry/edges.get_edge_list dispatches small blobs here (the XLA
  program is faster above ~64k px, but on a folder batch of tiny scans
  the per-dispatch latency dwarfs the math);
- benchmarks/refshims backs the reference's skimage.feature.canny with
  this file, loaded BY PATH (the reference forks a Pool; its workers must
  never touch jax, so this module must not import it).

Same algorithm as the device kernel (gaussian blur with support-mask
normalisation, sobel, quantised-direction NMS, double threshold,
hysteresis via binary propagation); agreement on the binarised blobs the
pipeline feeds it is asserted in tests/test_canny.py (the consumer is an
outlier-robust ellipse fit — sub-pixel agreement is not load-bearing,
reference ellipse_to_circle.py:245-250).
"""

import numpy as np
import scipy.ndimage as ndi


def _gaussian_kernel_1d(sigma):
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


_NORM_CACHE: dict = {}  # (shape, sigma) -> support-mask convolution


def _support_norm(shape, sigma, k):
    """Gaussian convolution of an all-ones image — depends only on shape
    and sigma, so folder batches of same-size scans compute it once."""
    key = (shape, float(sigma))
    norm = _NORM_CACHE.get(key)
    if norm is None:
        ones = np.ones(shape, dtype=np.float64)
        norm = ndi.convolve1d(
            ndi.convolve1d(ones, k, axis=0, mode="constant"),
            k, axis=1, mode="constant")
        if len(_NORM_CACHE) > 8:
            _NORM_CACHE.clear()
        _NORM_CACHE[key] = norm
    return norm


def canny(image, sigma=1.0, low_threshold=None, high_threshold=None):
    # float64 like skimage's own canny: on a CONSTANT image the support-mask
    # division must cancel to ~1e-10 noise so the magnitude floor below
    # genuinely silences the degenerate flat case (float32 leaves ~0.2-1.0
    # absolute ripple on 65000-scale data, which a low_threshold of 0 —
    # the median of an all-dark image — would pass)
    img = np.asarray(image, dtype=np.float64)
    k = _gaussian_kernel_1d(float(sigma))
    sm = ndi.convolve1d(ndi.convolve1d(img, k, axis=0, mode="constant"),
                        k, axis=1, mode="constant")
    norm = _support_norm(img.shape, sigma, k)
    sm = sm / np.maximum(norm, 1e-12)

    gy = ndi.sobel(sm, axis=0, mode="reflect")
    gx = ndi.sobel(sm, axis=1, mode="reflect")
    mag = np.hypot(gy, gx)

    ang = np.arctan2(gy, gx)
    ang = np.where(ang < 0, ang + np.pi, ang)
    sector = (np.floor_divide(ang + np.pi / 8, np.pi / 4).astype(np.int32)) % 4

    pad = np.pad(mag, 1, mode="constant")

    def nb(dy, dx):
        return pad[1 + dy:1 + dy + mag.shape[0], 1 + dx:1 + dx + mag.shape[1]]

    neighbours = [
        (nb(0, 1), nb(0, -1)),
        (nb(1, 1), nb(-1, -1)),
        (nb(1, 0), nb(-1, 0)),
        (nb(1, -1), nb(-1, 1)),
    ]
    keep = np.zeros(mag.shape, bool)
    for s, (a, b) in enumerate(neighbours):
        keep |= (sector == s) & (mag >= a) & (mag >= b)
    border = np.zeros(mag.shape, bool)
    border[1:-1, 1:-1] = True
    # strictly-positive magnitude with a tiny absolute floor: even in f64 a
    # CONSTANT image leaves ~1e-10 float-noise gradients; real limb
    # gradients are thousands, so the floor only silences the degenerate
    # all-flat case (edge-free input must yield no edges)
    keep &= border & (mag > 1e-3)

    low = keep & (mag >= float(low_threshold))
    high = keep & (mag >= float(high_threshold))
    # hysteresis: strong edges propagated through the weak mask
    return ndi.binary_propagation(high, mask=low, structure=np.ones((3, 3)))
