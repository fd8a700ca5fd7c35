"""The plain reference of ``shg -c`` on one scan: numpy and scipy, float64.

It follows the published Sol'Ex reconstruction (Solex_ser_recon_EN:
Solex_recon.py, solex_util.py, ellipse_to_circle.py) stage by stage, with
the semantics the port documents for each stage, and imports nothing of
the program.  It reads the SER file with its own reader.

- pass A: the exact mean (uint64 sums over the frames, divided in float64
  and truncated) and maximum of every normalised pixel;
- the line fit: 5 x 5 box blur of the maximum for the disk's rows, 25-px
  blur of the mean, per-row argmin, cubic fit with a 3-sigma rejection
  round and a mode-shift gate against the sharp argmin (float64);
- pass B: per frame and row, the float64 lerp of the two taps at
  ``floor(curve) + shift``, truncated to uint16, for the hidden
  ellipse-fit shift 10 and the requested shifts;
- the ellipse fit on the shift-10 disk: a 4x block mean, a flood
  threshold from a cubic fit of the brightness histogram, a float64
  Canny, the two largest edge regions on the convex hull, a direct
  least-squares conic fit with one radial-outlier round;
- the circularisation: the stretch-and-unrotate matrix, a float64 bilinear
  warp with the image's corner value outside;
- transversalium: inside the fitted circle, the outlier-rejected mean of
  the log ratio of adjacent rows, Savitzky-Golay detrended, summed,
  exponentiated and Tukey-tapered into a row gain;
- the product: the gained image, CLAHE (clip 0.8, 2 x 2 tiles, 65536
  bins, OpenCV's algorithm) and a linear stretch between the CLAHE
  image's 10th percentile and its maximum.

The circularisation, transversalium and the product run for every
requested shift, with the one geometry of the fit shift's disk.

``bits`` runs the whole chain on samples cut to their ``bits`` most
significant bits: the control of the benchmark's comparison.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

HEADER_SIZE = 178


# -- the SER file ------------------------------------------------------------

def read_ser(path: str):
    """(frames (F, Height, Width) memmap, pixel depth, rotate): a frame
    stored wide (Width > Height) is turned by rot90 to (Width, Height)."""
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
    width, height, depth, count = (int.from_bytes(head[26 + 4 * i:30 + 4 * i],
                                                  "little") for i in range(4))
    dtype = np.uint8 if depth == 8 else np.dtype("<u2")
    frames = np.memmap(path, dtype=dtype, mode="r", offset=HEADER_SIZE,
                       shape=(count, height, width))
    return frames, depth, width > height


def _samples(chunk: np.ndarray, depth: int, bits: Optional[int]) -> np.ndarray:
    """Stored samples as uint16 on the 16-bit scale (8-bit ones x 256),
    cut to ``bits`` significant bits when asked."""
    c = chunk.astype(np.uint16)
    if bits is not None and bits < depth:
        drop = depth - bits
        c = (c >> drop) << drop
    if depth == 8:
        c = c << 8
    return c


def _normalise(img: np.ndarray, rotate: bool) -> np.ndarray:
    return np.rot90(img) if rotate else img


def mean_max(frames, depth: int, rotate: bool, bits: Optional[int] = None,
             block: int = 64):
    """Exact per-pixel mean (uint16) and maximum of the normalised frames."""
    n = frames.shape[0]
    acc = np.zeros(frames.shape[1:], np.uint64)
    mx = np.zeros(frames.shape[1:], np.uint16)
    for f0 in range(0, n, block):
        c = _samples(frames[f0:f0 + block], depth, bits)
        acc += np.add.reduce(c, axis=0, dtype=np.uint64)
        np.maximum(mx, c.max(axis=0), out=mx)
    mean = (acc.astype(np.float64) / n).astype(np.uint16)
    return _normalise(mean, rotate), _normalise(mx, rotate)


# -- the line fit --------------------------------------------------------------

def _window_sums(x: np.ndarray, k: int, axis: int) -> np.ndarray:
    """Exact sliding-window sums (anchor k // 2) over the image extended by
    reflection without repeating the edge pixel."""
    if k <= 1:
        return x.astype(np.int64)
    lo, hi = k // 2, k - 1 - k // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (lo, hi)
    c = np.cumsum(np.pad(x, pad, mode="reflect").astype(np.int64), axis=axis)
    z = list(c.shape)
    z[axis] = 1
    c = np.concatenate([np.zeros(z, np.int64), c], axis=axis)
    n = x.shape[axis]
    return np.take(c, np.arange(k, k + n), axis) - np.take(c, np.arange(n), axis)


def blur_u16(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    """Box mean of a uint16 image, rounded half to even."""
    s = _window_sums(_window_sums(img, ky, 0), kx, 1)
    k = kx * ky
    q = s // k
    val = q.astype(np.float32) + (s - q * k).astype(np.float32) / np.float32(k)
    return np.clip(np.round(val), 0, 65535).astype(np.uint16)


def _fit3(y, x):
    return np.polyfit(np.asarray(y, np.float64), np.asarray(x, np.float64),
                      3)[::-1]


def _val3(p, y):
    return np.polynomial.polynomial.polyval(np.asarray(y, np.float64), p)


def line_fit(mean: np.ndarray, mx: np.ndarray) -> Dict[str, np.ndarray]:
    ih = mean.shape[0]
    proj = np.mean(blur_u16(mx, 5, 5), axis=1)
    where = proj > np.median(proj) / 5
    y1 = int(np.argmax(where))
    y2 = int(ih - 1 - np.argmax(where[::-1]))
    clip = int((y2 - y1) * 0.05)
    y1, y2 = min(ih - 1, y1 + clip), max(0, y2 - clip)
    if y2 - y1 < 4:
        raise ValueError(f"sun vertical extent too small: {y1}, {y2}")
    half = 12
    blurred = blur_u16(mean, 25, max(1, int((y2 - y1) * 0.01)))
    min_blur = half + np.argmin(blurred[:, half:-half], axis=1)
    ys = np.arange(y1, y2, dtype=np.float64)
    p = _fit3(ys, min_blur[y1:y2])
    delta = _val3(p, ys) - min_blur[y1:y2]
    std = np.std(delta)
    keep = np.abs(delta / std) < 3 if std > 0 else np.ones_like(delta, bool)
    p = _fit3(ys[keep], min_blur[y1:y2][keep])
    sharp = np.argmin(mean, axis=1)
    dsharp = _val3(p, ys) - sharp[y1:y2]
    values, counts = np.unique(np.around(dsharp, 1), return_counts=True)
    good = np.abs(dsharp - values[np.argmax(counts)]) < 5
    if good.sum() >= 4:
        p = _fit3(ys[good], sharp[y1:y2][good])
    curve = _val3(p, np.arange(ih))
    floor = np.floor(curve)
    return {"curve": curve, "floor": floor, "frac": curve - floor,
            "y1": y1, "y2": y2}


# -- pass B --------------------------------------------------------------------

def recon(frames, depth: int, rotate: bool, floor: np.ndarray,
          frac: np.ndarray, shifts: List[int], bits: Optional[int] = None,
          block: int = 64) -> np.ndarray:
    """(S, ih, F) uint16 disks: per frame, row y of shift s is the float64
    lerp of columns c = clip(floor[y] + s, 0, iw - 2) and c + 1."""
    n = frames.shape[0]
    ih = frames.shape[2] if rotate else frames.shape[1]
    iw = frames.shape[1] if rotate else frames.shape[2]
    rows = np.arange(ih)
    lw = 1.0 - frac
    rw = 1.0 - lw
    disks = np.zeros((len(shifts), ih, n), np.uint16)
    for f0 in range(0, n, block):
        c = _samples(frames[f0:f0 + block], depth, bits)
        for i, s in enumerate(shifts):
            col = np.clip((floor + s).astype(np.int64), 0, iw - 2)
            if rotate:     # normalised[y, x] = stored[x, ih - 1 - y]
                left = c[:, col, ih - 1 - rows]
                right = c[:, col + 1, ih - 1 - rows]
            else:
                left = c[:, rows, col]
                right = c[:, rows, col + 1]
            v = left * lw + right * rw
            disks[i, :, f0:f0 + c.shape[0]] = v.astype(np.uint16).T
    return disks


# -- the ellipse fit -----------------------------------------------------------

def _reflect_pad_sum(x: np.ndarray, k: int, axis: int) -> np.ndarray:
    if k <= 1:
        return x
    lo, hi = k // 2, k - 1 - k // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (lo, hi)
    c = np.cumsum(np.pad(x, pad, mode="reflect"), axis=axis)
    z = list(c.shape)
    z[axis] = 1
    c = np.concatenate([np.zeros(z), c], axis=axis)
    n = x.shape[axis]
    return np.take(c, np.arange(k, k + n), axis) - np.take(c, np.arange(n), axis)


def blur_f(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    if kx <= 1 and ky <= 1:
        return np.asarray(img, np.float64)
    s = _reflect_pad_sum(_reflect_pad_sum(np.asarray(img, np.float64), ky, 0),
                         kx, 1)
    return s / (kx * ky)


def _flood(image: np.ndarray) -> np.ndarray:
    mean_thresh = 0.9 * float(np.sum(image)) / image.size
    bw = max(1, int(image.shape[0] * 0.01))
    blurred = blur_f(image, bw, bw)
    data = blurred.ravel()
    data = data[data < np.percentile(blurred, 99)]
    n, bins = np.histogram(data, bins=20)
    coef = np.polynomial.polynomial.Polynomial.fit(bins[1:], n, 3).convert().coef
    thresh2 = mean_thresh
    if len(coef) == 4 and coef[3] != 0:
        d_, c_, b_, a_ = coef
        disc = 4 * b_ * b_ - 12 * a_ * c_
        if disc >= 0:
            thresh2 = (-2 * b_ + math.sqrt(disc)) / (6 * a_)
    start = -1
    for i in range(len(bins) - 1):
        if bins[i] <= thresh2 < bins[i + 1]:
            start = i
    if start == -1:
        thresh = mean_thresh
    else:
        i = start
        while 0 < i < len(bins) - 2:
            if n[i - 1] < n[i]:
                i -= 1
            elif n[i + 1] < n[i]:
                i += 1
            else:
                break
        thresh = float(bins[max(i - 1, 0)] if i >= 1 else bins[i])
    return np.where(blurred < thresh, 0.0, 65000.0)


def _canny(image: np.ndarray, sigma: float, low: float, high: float):
    import scipy.ndimage as ndi

    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()

    def smooth(a):
        return ndi.convolve1d(ndi.convolve1d(a, k, axis=0, mode="constant"),
                              k, axis=1, mode="constant")

    sm = smooth(image) / np.maximum(smooth(np.ones_like(image)), 1e-12)
    gy = ndi.sobel(sm, axis=0, mode="reflect")
    gx = ndi.sobel(sm, axis=1, mode="reflect")
    mag = np.hypot(gy, gx)
    ang = np.arctan2(gy, gx)
    ang = np.where(ang < 0, ang + np.pi, ang)
    sector = np.floor_divide(ang + np.pi / 8, np.pi / 4).astype(np.int32) % 4
    pad = np.pad(mag, 1)
    h, w = mag.shape

    def nb(dy, dx):
        return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    keep = np.zeros(mag.shape, bool)
    for s, (a, b) in enumerate(((nb(0, 1), nb(0, -1)), (nb(1, 1), nb(-1, -1)),
                                (nb(1, 0), nb(-1, 0)), (nb(1, -1), nb(-1, 1)))):
        keep |= (sector == s) & (mag >= a) & (mag >= b)
    border = np.zeros(mag.shape, bool)
    border[1:-1, 1:-1] = True
    keep &= border & (mag > 1e-3)
    return ndi.binary_propagation(keep & (mag >= high), mask=keep & (mag >= low),
                                  structure=np.ones((3, 3)))


def _edges(image: np.ndarray) -> np.ndarray:
    import scipy.ndimage as ndi
    from scipy.spatial import ConvexHull

    sigma = 2.0
    while sigma > 0:
        low = float(np.median(blur_f(image, 5, 5))) / 10
        edges = _canny(_flood(image), sigma, low, low * 1.5)
        labelled, nf = ndi.label(edges, structure=np.ones((3, 3)))
        if nf > 0:
            break
        sigma -= 0.5
    else:
        raise ValueError("no limb edges")
    sizes = ndi.sum_labels(edges, labelled, index=np.arange(1, nf + 1))
    big = 1 + np.argsort(sizes)[::-1][:min(nf, 2)]
    pts = np.argwhere(np.isin(labelled, big))
    hull = pts[ConvexHull(pts).vertices]
    on_hull = np.zeros(edges.shape, bool)
    on_hull[hull[:, 0], hull[:, 1]] = True
    keep = [lbl for lbl in big if np.any(on_hull & (labelled == lbl))]
    filt = np.isin(labelled, keep)
    lo, hi = pts[:, 0].min(), pts[:, 0].max()
    band = np.zeros(filt.shape, bool)
    band[int(lo + (hi - lo) * 0.017):int(hi - (hi - lo) * 0.017), :] = True
    out = np.argwhere(filt & band).astype(np.float64)
    if out.shape[0] < 6:
        raise ValueError("too few limb edge points")
    return out


def _rot(x: float) -> np.ndarray:
    return np.array([[np.cos(x), np.sin(x)], [-np.sin(x), np.cos(x)]])


def correction_matrix(phi: float, r: float):
    stretch = _rot(phi) @ np.array([[r, 0.0], [0.0, 1.0]]) @ _rot(-phi)
    theta = np.arctan(stretch[1, 0] / stretch[0, 0])
    corr = _rot(theta) @ stretch
    corr[1, 0] = 0.0
    corr /= corr[1, 1]
    return np.linalg.inv(corr)


def _conic(points: np.ndarray):
    """Direct least-squares ellipse (Halir and Flusser): (center, semi-axis
    along phi, the other semi-axis, phi)."""
    u, v = points[:, 0], points[:, 1]
    D1 = np.stack([u * u, u * v, v * v], axis=1)
    D2 = np.stack([u, v, np.ones_like(u)], axis=1)
    S1, S2, S3 = D1.T @ D1, D1.T @ D2, D2.T @ D2
    T = -np.linalg.solve(S3, S2.T)
    M = S1 + S2 @ T
    M = np.array([M[2] / 2.0, -M[1], M[0] / 2.0])
    val, vec = np.linalg.eig(M)
    cond = 4 * vec[0] * vec[2] - vec[1] ** 2
    a1 = vec[:, np.real(cond) > 0][:, 0].real
    a, b, c, d, e, f = np.concatenate([a1, T @ a1])
    A = np.array([[a, b / 2.0], [b / 2.0, c]])
    bv = np.array([d, e])
    center = -0.5 * np.linalg.solve(A, bv)
    k0 = f - 0.25 * bv @ np.linalg.solve(A, bv)
    lam, vecs = np.linalg.eigh(A)
    ax2 = -k0 / lam
    if np.any(ax2 <= 0):
        raise ValueError("conic is not an ellipse")
    semi = np.sqrt(ax2)
    phi = math.atan2(vecs[1, 0], vecs[0, 0])
    if phi <= -math.pi / 2:
        phi += math.pi
    elif phi > math.pi / 2:
        phi -= math.pi
    return center, float(semi[0]), float(semi[1]), phi


def geometry(disk: np.ndarray) -> Dict[str, object]:
    """Ellipse fit of a uint16 disk and the circularisation it implies."""
    h, w = disk.shape
    img = disk.astype(np.float64) / 65536.0
    ph, pw = (-h) % 4, (-w) % 4
    img = np.pad(img, ((0, ph), (0, pw)))
    small = img.reshape(img.shape[0] // 4, 4, img.shape[1] // 4, 4).mean(
        axis=(1, 3))
    X = _edges(small) * 4
    center, width, height, phi = _conic(X)
    mat = correction_matrix(phi, height / width)
    resid = np.linalg.norm(mat @ (X - center).T * height, axis=0) - 1
    kept = X[resid > -np.max(resid)]
    center, width, height, phi = _conic(kept)
    ratio = width / height
    for _ in range(2):
        if phi > math.pi / 4:
            phi -= math.pi / 2
            ratio = 1 / ratio
            height = height / ratio
        if phi < -math.pi / 4:
            phi += math.pi / 2
            ratio = 1 / ratio
            height = height / ratio
    mat = correction_matrix(phi, ratio)
    corners = np.array([[0, 0], [0, h], [w, 0], [w, h]], np.float64)
    nc = (np.linalg.inv(mat) @ corners.T).T
    tx, ty = float(np.min(nc[:, 0])), float(np.min(nc[:, 1]))
    out_h = int(math.ceil(float(np.max(nc[:, 1]) - np.min(nc[:, 1]))))
    out_w = int(math.ceil(float(np.max(nc[:, 0]) - np.min(nc[:, 0]))))
    mat3 = np.eye(3)
    mat3[:2, :2] = mat
    mat3 = mat3 @ np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1.0]])
    cxy = np.array([center[1], center[0]])
    new_center = np.linalg.inv(mat) @ cxy - np.array([tx, ty])
    radius = height * np.sqrt(abs(ratio / np.linalg.det(mat)))
    pts = np.stack([kept[:, 1], kept[:, 0], np.ones(len(kept))], axis=1)
    pt = (np.linalg.inv(mat3) @ pts.T).T
    borders = [float(pt[:, 0].min()), float(pt[:, 1].min()),
               float(pt[:, 0].max()), float(pt[:, 1].max())]
    return {"circle": (float(new_center[0]), float(new_center[1]),
                       float(radius)),
            "mat3": mat3, "out_h": out_h, "out_w": out_w, "phi": phi,
            "ratio": ratio, "borders": borders}


def warp(disk: np.ndarray, mat3: np.ndarray, out_h: int, out_w: int
         ) -> np.ndarray:
    """Bilinear warp of disk / 65536 at source (x, y) = mat3 @ (x', y', 1),
    the corner value outside, stored back as uint16 (x 65536, truncated)."""
    img = disk.astype(np.float64) / 65536.0
    h, w = img.shape
    cval = img[0, 0]
    gy, gx = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    sx = mat3[0, 0] * gx + mat3[0, 1] * gy + mat3[0, 2]
    sy = mat3[1, 0] * gx + mat3[1, 1] * gy + mat3[1, 2]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    dx, dy = sx - x0, sy - y0
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    flat = img.ravel()

    def tap(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return np.where(ok, flat[np.clip(yi, 0, h - 1) * w
                                 + np.clip(xi, 0, w - 1)], cval)

    out = ((tap(y0, x0) * (1 - dx) + tap(y0, x0 + 1) * dx) * (1 - dy)
           + (tap(y0 + 1, x0) * (1 - dx) + tap(y0 + 1, x0 + 1) * dx) * dy)
    return np.clip(out * 65536.0, 0, 65535).astype(np.uint16)


# -- transversalium and the product ------------------------------------------

def _tukey(n: int, a: float = 0.05) -> np.ndarray:
    x = np.arange(n, dtype=np.float64)
    x = np.minimum(x, n - x)
    return np.where(x < a * n / 2, 0.5 * (1 - np.cos(2 * np.pi * x / (a * n))),
                    1.0)


def _median(x: np.ndarray) -> float:
    """The median with NaNs (0 / 0 pixels) counted and sorted last."""
    s = np.sort(x)
    return 0.5 * (s[(len(s) - 1) // 2] + s[len(s) // 2])


def transversalium_gain(img: np.ndarray, circle, borders,
                        strength: int = 301) -> np.ndarray:
    from scipy.signal import savgol_filter

    h, w = img.shape
    cx, cy, r = (np.float32(v) for v in circle)
    bx0, by1, bx2, by3 = (np.float32(b) for b in borders)
    y1 = max(math.ceil(max(circle[1] - circle[2], borders[1])), 0)
    y2 = min(math.floor(min(circle[1] + circle[2], borders[3])), h)
    # the chord of each row inside the circle and the borders
    ys = np.arange(h, dtype=np.float32)
    my1 = np.ceil(max(cy - r, by1))
    my2 = np.floor(min(cy + r, by3))
    d2 = r * r - (ys - cy) ** 2
    dx = np.floor(np.sqrt(np.maximum(d2, np.float32(0))))
    lo = np.ceil(np.maximum(cx - dx, bx0))
    hi = np.floor(np.minimum(cx + dx, bx2))
    row_ok = (ys > my1) & (ys < my2) & (d2 >= 0)
    f = img.astype(np.float64)
    mean_r = np.zeros(h)
    xs = np.arange(w)
    with np.errstate(divide="ignore", invalid="ignore"):
        for y in range(max(y1 + 1, 1), y2):
            if not row_ok[y]:
                continue
            sel = (xs >= lo[y]) & (xs < hi[y])
            if not sel.any():
                continue
            rat = np.log(f[y, sel] / f[y - 1, sel])
            med = _median(rat)
            d = np.abs(rat - med)
            mdev = _median(d)
            s = d / mdev if mdev > 0 else np.zeros_like(d)
            kept = rat[s < 2.0]
            v = kept.mean() if kept.size else 0.0
            # a row with no finite statistic gets no correction
            mean_r[y] = v if np.isfinite(v) else 0.0
    band = np.zeros(y2 - y1)
    band[1:] = mean_r[y1 + 1:y2]
    n = len(band)
    if n < 7:
        return np.ones(h)
    trend = savgol_filter(band, min(strength, n // 2 * 2 - 1), 3)
    det = band - trend
    det -= det.mean()
    corr = np.exp(-np.cumsum(det))
    c = np.ones(h)
    c[y1:y2] = 1.0 + (corr - 1.0) * _tukey(n)
    return c


def clahe_u16(img: np.ndarray, clip_limit: float = 0.8, tiles=(2, 2)
              ) -> np.ndarray:
    """OpenCV's CLAHE of a uint16 image (65536 bins): tile histograms on the
    image extended by reflection, clip and redistribute, float32 LUTs,
    bilinear blend of the four neighbouring tiles' LUTs."""
    bins = 65536
    f32 = np.float32
    tx, ty = tiles
    h, w = img.shape

    def refl(n, m):
        i = np.abs(np.arange(n)) % (2 * (m - 1))
        return np.where(i >= m, 2 * (m - 1) - i, i)

    ext = img if (h % ty == 0 and w % tx == 0) else img[
        refl(h + ty - h % ty, h)][:, refl(w + tx - w % tx, w)]
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    scale = f32(bins - 1) / f32(area)
    clip = max(int(clip_limit * area / bins), 1)
    tile = ((np.arange(ty * th) // th)[:, None] * tx
            + (np.arange(tx * tw) // tw)[None, :])
    keys = tile * bins + ext[:ty * th, :tx * tw].astype(np.int64)
    hists = np.bincount(keys.ravel(), minlength=tx * ty * bins).reshape(
        tx * ty, bins)
    luts = np.empty((tx * ty, bins), np.uint16)
    for k, hist in enumerate(hists):
        over = int(np.maximum(hist - clip, 0).sum())
        hist = np.minimum(hist, clip) + over // bins
        rest = over % bins
        if rest:
            hist[np.arange(0, bins, max(bins // rest, 1))[:rest]] += 1
        luts[k] = np.clip(np.rint(np.cumsum(hist).astype(f32) * scale), 0,
                          65535).astype(np.uint16)

    def axis(n, size, count):
        pos = np.arange(n).astype(f32) * (f32(1.0) / f32(size)) - f32(0.5)
        lo = np.floor(pos)
        a = (pos - lo).astype(f32)
        lo = lo.astype(np.int64)
        return np.maximum(lo, 0), np.minimum(lo + 1, count - 1), a, f32(1) - a

    y1, y2, ya, ya1 = axis(h, th, ty)
    x1, x2, xa, xa1 = axis(w, tw, tx)
    flat = luts.ravel()
    v = img.astype(np.int64)

    def lut(ry, rx):
        return flat[(ry[:, None] * tx + rx[None, :]) * bins + v].astype(f32)

    res = ((lut(y1, x1) * xa1 + lut(y1, x2) * xa) * ya1[:, None]
           + (lut(y2, x1) * xa1 + lut(y2, x2) * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 65535).astype(np.uint16)


def clahe_product(img: np.ndarray, gain: np.ndarray) -> np.ndarray:
    gained = np.clip(img.astype(np.float64) * gain[:, None], 0, 65535).astype(
        np.uint16)
    cl = clahe_u16(gained)
    dark = float(np.percentile(cl, 10))
    bright = max(float(cl.max()), dark + 1.0)
    return np.clip(65535.0 * (cl - dark) / (bright - dark), 0, 65535).astype(
        np.uint16)


# -- the whole scan --------------------------------------------------------------

def product(disk: np.ndarray, geo: Dict[str, object]) -> Dict[str, object]:
    """One shift's circularised disk, its row gain and its product."""
    warped = warp(disk, geo["mat3"], geo["out_h"], geo["out_w"])
    gain = transversalium_gain(warped, geo["circle"], geo["borders"])
    return {"warped": warped, "gain": gain,
            "clahe": clahe_product(warped, gain)}


def post(disks: np.ndarray, shifts: List[int], requested: List[int]
         ) -> Dict[str, object]:
    """The ellipse fit on the first disk, then the product of every
    requested shift (``products``, by shift); the first requested shift's
    also at the top level."""
    geo = geometry(disks[0])
    products = {s: product(disks[shifts.index(s)], geo)
                for s in dict.fromkeys(requested)}
    return {"geometry": geo, **products[requested[0]], "products": products}


def run(path: str, shifts=(0,), fit_shift: int = 10,
        bits: Optional[int] = None) -> Dict[str, object]:
    """Everything ``shg -c`` computes for each requested shift, the ellipse
    fit once on the fit shift's disk."""
    frames, depth, rotate = read_ser(path)
    try:
        mean, mx = mean_max(frames, depth, rotate, bits)
        fit = line_fit(mean, mx)
        all_shifts = list(dict.fromkeys([fit_shift, 0] + list(shifts)))
        disks = recon(frames, depth, rotate, fit["floor"], fit["frac"],
                      all_shifts, bits)
    finally:
        del frames
    out = {"mean": mean, "max": mx, "fit": fit, "shifts": all_shifts,
           "disks": disks}
    out.update(post(disks, all_shifts, list(shifts)))
    return out
