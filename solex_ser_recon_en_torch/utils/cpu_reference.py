"""CPU baseline: a faithful numpy replica of the reference's hot path.

Counterpart of solex_ser_recon_en_tpu/utils/cpu_reference.py, which needs
OpenCV (cv2).  The reference itself (pure Python+NumPy+OpenCV) cannot run
here (FreeSimpleGUI/skimage/astropy/lsq-ellipse are absent), so the
benchmark denominator and the golden tests' plain reference is this
replica of its per-frame algorithm, written to the same semantics it
executes:

- streaming read with a 25-frame buffer (video_reader.py:94-109),
- per-frame rot90 + x256 upscale (video_reader.py:117-122),
- pass 1: uint64 mean + max accumulation frame loop (solex_util.py:174-188),
- line detect + cubic fit (solex_util.py:223-259, via cv2.blur/np.polyfit),
- pass 2: per-frame per-shift fancy-indexed gather-lerp loop
  (solex_util.py:113-144),
- CLAHE + percentile stretch products (solex_util.py:532-541, via cv2).

This is exactly the work the reference does per scan on the CPU; timing it
on the same input gives the honest speedup denominator.

The machines the port runs on need not have cv2, so the reference's five
OpenCV calls are numpy stand-ins here, written from OpenCV's own
algorithms and held to cv2 by tests/test_torch_golden.py where cv2 exists:
``_blur_u16`` (cv2.blur), ``_clahe_u16`` (cv2.createCLAHE(...).apply),
``_fill_circle`` (cv2.circle, filled), ``_write_png_u16`` (cv2.imwrite,
compression 0) and the AVI source (cv2.VideoCapture; only uncompressed
8-bit grey-scale AVIs are read).  They are not the pipeline's kernels or
their plain versions (ops/), so the reference stays independent of the
code it checks.  The same code runs with and without cv2.
"""

from __future__ import annotations

import struct
import time
import zlib
from typing import List

import numpy as np

from ..io.ser import SerReader
from ..io.video import _parse_raw_gray_avi


class _StreamingReader:
    """25-frame-buffered frame iterator (video_reader.py:94-109 semantics)."""

    def __init__(self, path: str, buffer_size: int = 25):
        self._r = SerReader(path)
        self.ih, self.iw = self._r.ih, self._r.iw
        self.frame_count = self._r.frame_count
        self._buffer_size = buffer_size
        self._idx = 0
        self._buf = None
        self._buf_start = 0

    def has_frames(self) -> bool:
        return self._idx < self.frame_count

    def next_frame(self) -> np.ndarray:
        if self._buf is None or self._idx >= self._buf_start + self._buf.shape[0]:
            self._buf_start = self._idx
            n = min(self._buffer_size, self.frame_count - self._idx)
            raw = np.asarray(self._r.raw_frames(self._idx, n))
            self._buf = raw
        img = self._buf[self._idx - self._buf_start]
        self._idx += 1
        if self._r.flag_rotate:
            img = np.rot90(img)
        if self._r.header.pixel_depth == 8:
            img = np.asarray(img, dtype="uint16") * 256
        return img


class _AviStreamingReader:
    """The replica's AVI source (video_reader.py:68-80, 111-113): frames
    one at a time, grey, forced 8-bit, upscaled x256.

    The reference decodes with cv2.VideoCapture; for an uncompressed 8-bit
    grey-scale AVI (Y800/GREY) that decode is the container's planes
    unchanged (io/video.py:_parse_raw_gray_avi), which are read here
    straight from the file.  Any other AVI needs OpenCV's decoders and
    raises."""

    def __init__(self, path: str):
        raw = _parse_raw_gray_avi(path)
        if raw is None:
            raise RuntimeError(
                f"{path}: not an uncompressed 8-bit grey-scale AVI "
                f"(Y800/GREY); the reference replica reads no other AVI "
                f"(decoding it needs OpenCV's cv2.VideoCapture)")
        w, h, self._offsets = raw
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self._h, self._w = h, w
        self.frame_count = len(self._offsets)
        self._rotate = w > h
        self.ih, self.iw = max(w, h), min(w, h)
        self._idx = 0

    def has_frames(self) -> bool:
        return self._idx < self.frame_count

    def next_frame(self) -> np.ndarray:
        off = self._offsets[self._idx]
        self._idx += 1
        img = self._mm[off:off + self._h * self._w].reshape(self._h, self._w)
        if self._rotate:
            img = np.rot90(img)
        return np.asarray(img, dtype="uint16") * 256


def _make_reader(path: str):
    if path.lower().endswith(".avi"):
        return _AviStreamingReader(path)
    return _StreamingReader(path)


# -- numpy stand-ins for the reference's OpenCV calls -----------------------

def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's borderInterpolate for BORDER_REFLECT_101 (gfedcb|abcdefgh|
    gfedcba), any distance outside [0, n)."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _blur_u16(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    """``cv2.blur(img, ksize=(kx, ky))`` of a uint16 image, bit for bit.

    OpenCV (imgproc box_filter, RowSum<ushort, int> then ColumnSum<int,
    ushort>): exact integer window sums over the BORDER_REFLECT_101
    extension, anchor at (kx // 2, ky // 2), scaled by 1 / (kx * ky).  The
    scaling's vector loop (8 or more columns at a time) multiplies in
    float32 by ``(float)(1. / n)`` and rounds half to even; the last
    ``width % 8`` columns, left to its scalar loop, multiply in float64.
    So neither one precision nor the other reproduces it at 25 x 16 or
    25 x 20 (a float64 scaling misses about 1 pixel in 1600 there)."""
    h, w = img.shape
    ys = _reflect101(np.arange(h + ky - 1) - ky // 2, h)
    xs = _reflect101(np.arange(w + kx - 1) - kx // 2, w)
    ext = np.asarray(img, dtype=np.int64)[ys][:, xs]
    c = np.zeros((ext.shape[0] + 1, ext.shape[1] + 1), np.int64)
    c[1:, 1:] = ext.cumsum(0).cumsum(1)
    s = c[ky:, kx:] - c[:-ky, kx:] - c[ky:, :-kx] + c[:-ky, :-kx]
    n = kx * ky
    out = np.rint(s.astype(np.float32) * np.float32(1.0 / n))
    tail = w - w % 8
    out[:, tail:] = np.rint(s[:, tail:] * (1.0 / n))
    return np.clip(out, 0, 65535).astype(np.uint16)


def _clahe_u16(img: np.ndarray, clip_limit: float = 0.8,
               tiles=(2, 2)) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, tiles).apply(img)`` of a uint16 image,
    bit for bit; ``tiles`` is cv2's tileGridSize, (tiles across, tiles
    down).

    OpenCV imgproc/src/clahe.cpp (CLAHE_Impl::apply, 65536 bins):
    - the tiles are cut from the image extended by BORDER_REFLECT_101 with
      ``tiles - n % tiles`` rows and columns on BOTH axes as soon as one
      axis does not divide (a whole tile's worth on an axis that does;
      ROADMAP C13: the pipeline pads only the axis that needs it);
    - the clip limit is ``max(int(clip_limit * area / 65536), 1)``; the
      excess is given back ``excess // 65536`` to every bin and one count
      more to every ``max(65536 // residual, 1)``-th bin from bin 0 until
      the residual is spent (CLAHE_CalcLut_Body);
    - each tile's LUT is ``saturate_cast<ushort>(cumsum * (float)65535 /
      area)``: a float32 product rounded half to even;
    - each pixel blends the four neighbouring tiles' LUTs in float32 at
      ``y * (1.f / tile_h) - 0.5f`` (and likewise in x),
      ``(l11 xa1 + l12 xa) ya1 + (l21 xa1 + l22 xa) ya``, rounded half to
      even (CLAHE_Interpolation_Body)."""
    bins = 65536
    f32 = np.float32
    tx, ty = tiles
    img = np.asarray(img)
    h, w = img.shape
    if h % ty == 0 and w % tx == 0:
        ext = img
    else:
        ext = img[_reflect101(np.arange(h + ty - h % ty), h)][
            :, _reflect101(np.arange(w + tx - w % tx), w)]
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    lut_scale = f32(bins - 1) / f32(area)
    clip = max(int(clip_limit * area / bins), 1) if clip_limit > 0 else 0

    tile = ((np.arange(ty * th) // th)[:, None] * tx
            + (np.arange(tx * tw) // tw)[None, :])
    keys = tile * bins + ext[:ty * th, :tx * tw].astype(np.int64)
    hists = np.bincount(keys.ravel(), minlength=tx * ty * bins).reshape(
        tx * ty, bins)
    luts = np.empty((tx * ty, bins), np.uint16)
    for k, hist in enumerate(hists):
        if clip > 0:
            clipped = int(np.maximum(hist - clip, 0).sum())
            hist = np.minimum(hist, clip) + clipped // bins
            residual = clipped % bins
            if residual:
                step = max(bins // residual, 1)
                hist[np.arange(0, bins, step)[:residual]] += 1
        cdf = np.cumsum(hist).astype(f32) * lut_scale
        luts[k] = np.clip(np.rint(cdf), 0, 65535).astype(np.uint16)

    def axis(n: int, size: int, count: int):
        pos = np.arange(n).astype(f32) * (f32(1.0) / f32(size)) - f32(0.5)
        lo = np.floor(pos)
        a = (pos - lo).astype(f32)
        lo = lo.astype(np.int64)
        return (np.maximum(lo, 0), np.minimum(lo + 1, count - 1), a,
                f32(1.0) - a)

    y1, y2, ya, ya1 = axis(h, th, ty)
    x1, x2, xa, xa1 = axis(w, tw, tx)
    flat = luts.ravel()
    v = img.astype(np.int64)

    def lut(ry, rx):
        return flat[(ry[:, None] * tx + rx[None, :]) * bins + v].astype(f32)

    res = ((lut(y1, x1) * xa1 + lut(y1, x2) * xa) * ya1[:, None]
           + (lut(y2, x1) * xa1 + lut(y2, x2) * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 65535).astype(np.uint16)


def _fill_circle(img: np.ndarray, center, r: int, value) -> np.ndarray:
    """``cv2.circle(img, center, r, value, -1)`` (thickness -1: filled,
    LINE_8, shift 0), in place; ``center`` is (x, y).

    OpenCV imgproc/src/drawing.cpp (Circle, fill): Bresenham's midpoint
    walk from (dx, dy) = (r, 0); every step fills the rows cy -+ dy over
    [cx - dx, cx + dx] and the rows cy -+ dx over [cx - dy, cx + dy],
    each span clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for (y_a, y_b, xl, xr) in ((cy - dy, cy + dy, cx - dx, cx + dx),
                                   (cy - dx, cy + dx, cx - dy, cx + dy)):
            if xl >= w or xr < 0:
                continue
            xl, xr = max(xl, 0), min(xr, w - 1)
            for y in (y_a, y_b):
                if 0 <= y < h:
                    img[y, xl:xr + 1] = value
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def _write_png_u16(path: str, img: np.ndarray) -> None:
    """A 16-bit grey PNG as ``cv2.imwrite(path, img,
    [IMWRITE_PNG_COMPRESSION, 0])`` writes one: deflate level 0 (stored
    blocks), big-endian samples; every row filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint16 or img.ndim != 2:
        raise ValueError(f"{path}: a 2-D uint16 image is written, not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(img, dtype=">u2").view(
        np.uint8).reshape(h, 2 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 0))
                + chunk(b"IEND", b""))


def _new_figure():
    """A matplotlib Figure on the Agg backend; the reference's figures
    need matplotlib, and where it cannot be imported the run raises."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.figure
    except ImportError as e:
        raise ImportError(
            f"the replica's figures need matplotlib, which cannot be "
            f"imported ({e}); run it with clahe_only or figures=False") from e
    return matplotlib.figure.Figure()


# -- the reference's stages --------------------------------------------------

def cpu_mean_max(path: str):
    rdr = _make_reader(path)
    acc = np.zeros((rdr.ih, rdr.iw), dtype="uint64")
    mx = np.zeros((rdr.ih, rdr.iw), dtype="uint16")
    while rdr.has_frames():
        img = rdr.next_frame()
        acc += img
        mx = np.maximum(mx, img)
    return (acc / rdr.frame_count).astype("uint16"), mx


def cpu_line_fit(mean_img: np.ndarray, max_img: np.ndarray):
    blur = _blur_u16(max_img, 5, 5)
    ymean = np.mean(blur, axis=1)
    th = np.median(ymean) / 5
    where = ymean > th
    y1 = int(np.argmax(where))
    y2 = int(mean_img.shape[0] - 1 - np.argmax(where[::-1]))
    clip = int((y2 - y1) * 0.05)
    y1 = min(mean_img.shape[0] - 1, y1 + clip)
    y2 = max(0, y2 - clip)
    bw_y = max(1, int((y2 - y1) * 0.01))
    blur2 = _blur_u16(mean_img, 25, bw_y)
    mins = 12 + np.argmin(blur2[:, 12:-12], axis=1)
    p = np.polyfit(np.arange(y1, y2), mins[y1:y2], 3)[::-1]
    curve = np.polynomial.polynomial.polyval(
        np.arange(mean_img.shape[0], dtype="d"), p
    )
    floor = np.floor(curve)
    return np.stack([floor, curve - floor], axis=1)


def cpu_recon(path: str, fit: np.ndarray, shifts: List[int]):
    """The reference hot loop (solex_util.py:113-144)."""
    rdr = _make_reader(path)
    ih, iw = rdr.ih, rdr.iw
    disks = [np.zeros((ih, rdr.frame_count), dtype="uint16") for _ in shifts]
    cols = []
    for s in shifts:
        ind_l = (fit[:, 0] + np.ones(ih) * s).astype(int)
        ind_l[ind_l < 0] = 0
        ind_l[ind_l > iw - 2] = iw - 2
        cols.append((ind_l, (ind_l + 1).astype(int)))
    lw = np.ones(ih) - fit[:, 1]
    rw = np.ones(ih) - lw
    rows = np.arange(ih)
    f = 0
    while rdr.has_frames():
        img = rdr.next_frame()
        for i in range(len(shifts)):
            ind_l, ind_r = cols[i]
            disks[i][:, f] = img[rows, ind_l] * lw + img[rows, ind_r] * rw
        f += 1
    return disks


def cpu_products(disk: np.ndarray, protus: bool = False):
    cl1 = _clahe_u16(disk, 0.8, (2, 2))
    bright = np.percentile(disk, 99.9999)
    dark_c = np.percentile(cl1, 10)
    bright_c = np.max(cl1)
    cc = (65535.0 * (cl1 - dark_c) / max(bright_c - dark_c, 1)).clip(0, 65535)
    hc = (65535.0 * (disk - bright * 0.25) / max(bright * 0.75, 1)).clip(0, 65535)
    # the protus stretch is UNCONDITIONAL in the reference (solex_util.py
    # :541 runs before any mode gate) — the replica must pay the float
    # pass in every mode for the pairing to be honest; only the disc fill
    # (:543-547, gated by disk_display) and the extra return depend on the
    # protus flag
    fp = (65535.0 * disk / max(bright * 0.18, 1)).clip(0, 65535)
    fp = fp.astype(np.uint16)
    if protus:
        # disc fill (solex_util.py:542-547); painted at the frame centre
        # here (the replica has no ellipse fit), same rasterisation cost
        h, w = fp.shape
        _fill_circle(fp, (w // 2, h // 2), int(0.4 * min(h, w)), 80)
        return cc.astype(np.uint16), hc.astype(np.uint16), fp
    return cc.astype(np.uint16), hc.astype(np.uint16)


def cpu_detect_bounds(max_img: np.ndarray):
    """detect_bord's vertical band (solex_util.py:165-172) — the
    transversalium backup bounds (Solex_recon.py:145-146)."""
    blur = _blur_u16(max_img, 5, 5)
    ymean = np.mean(blur, axis=1)
    th = np.median(ymean) / 5
    where = ymean > th
    y1 = int(np.argmax(where))
    y2 = int(max_img.shape[0] - 1 - np.argmax(where[::-1]))
    return y1 + 20, y2 - 20


def cpu_transversalium(disk: np.ndarray, y1: int, y2: int,
                       trans_strength: int = 301,
                       correction_out: list = None) -> np.ndarray:
    """correct_transversalium2 replica (solex_util.py:383-516): a Python
    per-row loop over the band computing the MAD-outlier-rejected mean of
    the row-pair log ratio (the reference's cost structure), then savgol
    detrend, cumulative sum, Tukey taper and the per-row multiply."""
    from scipy.signal import savgol_filter

    from ..pipeline.transversalium import tukey_taper

    h, w = disk.shape
    y1 = max(y1, 1)
    y2 = min(y2, h)
    f = np.maximum(disk.astype(np.float64), 1.0)
    mean_r = np.zeros(h)
    for y in range(y1 + 1, y2):         # reference loops rows in Python
        rat = np.log(f[y] / f[y - 1])
        med = np.median(rat)
        d = np.abs(rat - med)
        mdev = np.median(d)
        s = d / mdev if mdev else np.zeros_like(d)
        kept = rat[s < 2.0]
        mean_r[y] = kept.mean() if kept.size else 0.0

    band = np.zeros(y2 - y1)
    band[1:] = mean_r[y1 + 1 : y2]
    n = len(band)
    if n < 7:
        return disk
    window = min(trans_strength, n // 2 * 2 - 1)
    trend = savgol_filter(band, window, 3)
    det = band - trend
    det -= det.mean()
    corr = np.exp(-np.cumsum(det))
    corr_t = 1.0 + (corr - 1.0) * tukey_taper(n)
    c = np.ones(h)
    c[y1:y2] = corr_t
    if correction_out is not None:
        correction_out.append(c)
    return np.clip(disk.astype(np.float64) * c[:, None], 0, 65535).astype(
        np.uint16
    )


def cpu_ellipse_warp(disks, requested_idx, figures: bool = False,
                     base: str = None):
    """Replica of the reference's geometry stage.

    The reference runs this in EVERY mode without ``-x``
    (Solex_recon.py:105-133): ellipse fit on the hidden shift-10 disk with
    one full-resolution circularisation warp inside the fit
    (ellipse_to_circle.py:294-342), then one warp per requested shift
    (Solex_recon.py:123), plus the 4-panel ``_ellipse_fit.png`` diagnostic
    (three full-resolution imshows, dpi 300, ellipse_to_circle.py:316-341)
    whenever not clahe/protus-only.

    Cost-conservative stand-ins where the reference's own libs are absent
    in this image: the port's host edge/ellipse chain on the CPU (the same
    flood/canny/label/hull/conic-LSQ algorithms the reference runs via
    skimage/scipy/lsq-ellipse) and the float32 numpy warp twin
    (ops/warp_host.py:warp_projective_host) — the reference's
    skimage.transform.warp does the same four-tap bilinear work in
    float64 and costs more.  On fit failure the reference degrades to no
    correction (README.md:110); the replica mirrors that.

    Returns (warped requested disks, circle or None).
    """
    import torch

    from ..geometry.correct import correction_geometry
    from ..geometry.edges import downscale_local_mean, get_edge_list
    from ..geometry.ellipse import two_step
    from ..ops.warp_host import warp_projective_host, warp_to_u16_host

    def _warp(img01: np.ndarray, mat3, oh: int, ow: int) -> np.ndarray:
        return warp_to_u16_host(
            warp_projective_host(
                img01.astype(np.float32), mat3, oh, ow,
                cval=float(img01[0, 0]),
            )
        )

    image = disks[0] / 65536.0  # float64 full image (ellipse_to_circle:299)
    try:
        small = downscale_local_mean(image, 4)
        X, raw_X = get_edge_list(small, torch.device("cpu"))
        X = X * 4
        raw_X = raw_X * 4
        center_yx, height, phi, ratio, X_f, ell_pts = two_step(X)
        if (len(X_f) < 20 or height < 8
                or height > 2.0 * max(image.shape)
                or not (0 <= center_yx[0] < image.shape[0])
                or not (0 <= center_yx[1] < image.shape[1])):
            # degenerate fit (featureless input / spurious edge specks) —
            # the reference's LsqEllipse raises on such edge sets and the
            # run degrades to no correction (README.md:110)
            raise ValueError("degenerate ellipse fit")
        center = np.array([center_yx[1], center_yx[0]])
        circle, mat3, oh, ow = correction_geometry(
            image.shape, phi, ratio, center, height
        )
    except Exception:
        return [disks[i] for i in requested_idx], None

    fix_img = _warp(image, mat3, oh, ow)  # the fit's own warp (:308)
    if figures and base is not None:
        fig = _new_figure()
        ax = [
            [fig.add_subplot(2, 2, 1), fig.add_subplot(2, 2, 2)],
            [fig.add_subplot(2, 2, 3), fig.add_subplot(2, 2, 4)],
        ]
        fig.tight_layout()
        ax[0][0].imshow(image, cmap="gray")
        ax[0][0].set_title("uncorrected image", fontsize=11)
        ax[0][0].set_aspect("equal")
        ax[0][1].set_aspect("equal")
        ax[0][1].imshow(image, cmap="gray")
        ax[0][1].plot(raw_X[:, 1], raw_X[:, 0], "ro", label="edge detection")
        ax[0][1].legend(prop={"size": 6})
        ax[1][1].set_aspect("equal")
        ax[1][1].plot(X_f[:, 1], X_f[:, 0], "ro", label="filtered edges")
        ax[1][1].plot(ell_pts[:, 1], ell_pts[:, 0], color="b",
                      label="ellipse fit")
        ax[1][1].set_ylim([image.shape[0], 0])
        ax[1][1].legend(prop={"size": 6})
        ax[1][0].set_aspect("equal")
        ax[1][0].imshow(fix_img, cmap="gray")
        ax[1][0].set_title("geometrically corrected image", fontsize=11)
        fig.savefig(base + "_ellipse_fit.png", dpi=300)

    # one warp per REQUESTED shift (Solex_recon.py:120-123, disk/65536)
    return [_warp(disks[i] / 65536.0, mat3, oh, ow)
            for i in requested_idx], circle


def cpu_crop_width(disk: np.ndarray, fixed_width: int) -> np.ndarray:
    """Fixed-width crop/pad around the frame centre (Solex_recon.py:155-171
    cost replica — no fitted circle here, so centre = w/2)."""
    h, w = disk.shape
    nw2 = fixed_width // 2
    cx = w // 2
    out = np.full((h, fixed_width), disk[0, 0], dtype=disk.dtype)
    lo, hi = max(0, cx - nw2), min(cx + nw2, w)
    out[:, : hi - lo] = disk[:, lo:hi]
    return out


def cpu_pipeline(
    path: str,
    shifts: List[int],
    *,
    transversalium: bool = False,
    save_dir: str = None,
    save_fits: bool = False,
    protus: bool = False,
    img_rotate: int = 0,
    flip_x: bool = False,
    fixed_width: int = None,
    clahe_only: bool = False,
    figures: bool = None,
    ellipse: bool = True,
) -> float:
    """Run the replica end-to-end; returns elapsed seconds.

    The keyword extensions replicate the extra work of BASELINE configs
    2-5 (transversalium + the five FITS writes; protus paint + rotate +
    fixed-width crop; multi-shift product loops).  ``ellipse`` replicates
    the reference's always-on geometry stage (hidden shift-10/0 disks,
    ellipse fit, one circularisation warp per requested shift + one inside
    the fit, the 4-panel diagnostic in figure modes — see cpu_ellipse_warp;
    pass False to model a ``-x`` ratio_fixe run).  The warp stand-in runs
    in float32 where the reference's skimage warp runs float64, so paired
    speedups remain (mildly) conservative.  A run that saves figures
    raises ImportError where matplotlib cannot be imported; the ``-c``
    leg (``clahe_only``) needs neither it nor cv2.
    """
    import os

    t0 = time.perf_counter()
    mean_img, max_img = cpu_mean_max(path)
    fit = cpu_line_fit(mean_img, max_img)
    base = (
        os.path.join(save_dir, os.path.splitext(os.path.basename(path))[0])
        if save_dir
        else None
    )

    def fits(name, arr):
        if base and save_fits:
            from ..io.fits import write_fits

            write_fits(base + name, np.asarray(arr))

    def png(name, arr):
        if base:
            # compression 0, exactly the reference's product writes
            # (solex_util.py:558-567 pass IMWRITE_PNG_COMPRESSION 0) —
            # cv2's own default deflate level would overcharge the replica
            _write_png_u16(base + name, arr)

    fits("_mean.fits", mean_img)
    if figures is None:
        # reference gate: every mode that is not clahe-only/protus-ONLY
        # (solex_util.py:263).  The ``protus`` kwarg here also covers
        # configs that merely ADD the protus product (reference still
        # renders figures there) — those pass figures=True explicitly.
        figures = not clahe_only and not protus
    if base and figures:
        # the reference renders the spectral-line diagnostic figure in
        # every non-clahe/protus-only mode (solex_util.py:263-273): a
        # FULL-RESOLUTION imshow of the mean image at dpi 400.  The
        # replica must pay the same cost for the pairing to be honest
        # (the pipeline's own figure decimates the background and saves
        # at dpi 200 — pipeline/plots.py).
        fig = _new_figure()
        ax = fig.add_subplot(1, 1, 1)
        ax.imshow(mean_img, cmap="gray")
        curve = fit[:, 0] + fit[:, 1]
        ax.plot(curve, np.arange(len(curve)), label="polynomial fit")
        ax.legend(loc="center left", bbox_to_anchor=(1, 0.5))
        ax.set_aspect(0.1)
        fig.tight_layout()
        fig.savefig(base + "_spectral_line_data.png", dpi=400)
    if ellipse:
        # the reference reconstructs the hidden ellipse-fit/line-centre
        # disks in every run (Solex_recon.py:54-55 prepends [10, 0])
        shifts_all = list(dict.fromkeys([10, 0] + list(shifts)))
        requested_idx = [shifts_all.index(s) for s in shifts]
    else:
        shifts_all, requested_idx = list(shifts), list(range(len(shifts)))
    disks = cpu_recon(path, fit, shifts_all)
    if flip_x:
        disks = [d[:, ::-1] for d in disks]
    raw_disks = [disks[i] for i in requested_idx]
    if ellipse:
        disks, _circle = cpu_ellipse_warp(
            disks, requested_idx, figures=bool(figures), base=base
        )
    else:
        disks = raw_disks
    for i, d in enumerate(disks):
        tag = f"_shift={shifts[i]}"
        fits(tag + "_raw.fits", raw_disks[i])
        fits(tag + "_circular.fits", d)
        if transversalium:
            y1, y2 = cpu_detect_bounds(max_img)
            cout = []
            d = cpu_transversalium(d, y1, y2, correction_out=cout)
            if base and cout and figures:
                # the reference also saves the correction-factor figure in
                # this mode (solex_util.py:482-488, dpi 300)
                fig = _new_figure()
                ax = fig.add_subplot(1, 1, 1)
                ax.plot(cout[0])
                ax.set_xlabel("y")
                ax.set_ylabel("transversalium correction factor")
                fig.savefig(base + tag + "_transversalium_correction.png",
                            dpi=300)
            fits(tag + "_detransversaliumed.fits", d)
        if fixed_width is not None:
            d = cpu_crop_width(d, fixed_width)
        prods = cpu_products(d, protus=protus)
        cc, hc = prods[0], prods[1]
        k = img_rotate // 90
        if k:
            prods = tuple(np.rot90(p, k) for p in prods)
            cc, hc = prods[0], prods[1]
        fits(tag + "_clahe.fits", cc)
        png(tag + "_clahe.png", cc)
        if not clahe_only:
            # solex_util.py:556-566 — the full product set
            if protus:
                png(tag + "_protus.png", prods[2])
            png(tag + "_uncontrasted.png", np.rot90(d, k) if k else d)
            png(tag + "_high_contrast.png", hc)
    return time.perf_counter() - t0
