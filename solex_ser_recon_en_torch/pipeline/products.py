"""Final image products: CLAHE / stretches / protus / crop / rotate / saves.

Counterpart of solex_ser_recon_en_tpu/pipeline/products.py (its device
branches: ``_products_body``, ``_products_core_gained``, ``crop_width``,
``image_process``).  reference:
solex_util.py:519-588 (image_process, rescale_brightness) and
Solex_recon.py:155-171 (fixed-width / square crop): CLAHE(0.8, 2x2) of the
transversalium-corrected disk, a linear stretch of it between its 10th
percentile and its maximum, and two stretches of the disk itself against
its 99.9999th percentile; the percentiles come from exact value histograms
(ops/clahe.py, kernel B5) instead of sorts.

Every image stays on the frame's device until a file write needs host
bytes: the crop, the protus disc and the rotation run there.  The writer
pool (io/writers.py) brings each image down into pinned memory on its own
thread (PNGs band by band under the encode, FITS data in one copy).

In the host pipeline (the ``host`` feed, utils/placement.py) the product
core is the JAX package's host core (``_products_body_host``,
``_products_core_gained_host``): the native library's CLAHE
(``clahe_u16``, OpenCV's algorithm) with the output histogram from the
same pass, np.percentile's interpolation read off value histograms
(``hist_u16``, ``gain_hist_u16``) and the stretches as value LUTs
(``lut_u16``), on host arrays.  The JAX package's SOLEX_HOST_PRODUCTS
switch and its cv2 check are not carried over: the host core runs exactly
when the host pipeline is on, and a missing library raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import Options, output_path
from ..geometry.correct import NO_CIRCLE, Circle
from ..io import native
from ..io.fits import write_fits
from ..io.png import band_bounds, write_png_bands, write_png_streaming
from ..io.writers import submit
from ..ops.clahe import _clahe, percentile_from_hist, value_histogram
from ..ops.dtypes import as_int16, to_u16, widen
from ..ops.rowstats import apply_row_gain
from ..utils.placement import host_pipeline


def _stretch(img: torch.Tensor, lo, hi) -> torch.Tensor:
    x = 65535.0 * (widen(img).to(torch.float32) - lo) / (hi - lo)
    return to_u16(torch.clamp(x, 0, 65535))


def _products_body(fj: torch.Tensor, want=(True, True)):
    """CLAHE + percentiles + stretches of a uint16 image -> (cl1, cc,
    high_contrast, protus), uint16; the stretches ``want`` =
    (high_contrast, protus) does not ask for come back as None."""
    cl1, img_hist = _clahe(fj, 0.8, 2, 2, 65536, return_full_hist=True)
    cl1 = to_u16(cl1)
    dark_clahe = percentile_from_hist(value_histogram(cl1, 65536), cl1.numel(),
                                      10.0)
    bright_clahe = torch.maximum(widen(cl1).max().to(torch.float32),
                                 dark_clahe + 1.0)
    cc = _stretch(cl1, dark_clahe, bright_clahe)
    frame_hc = frame_protus = None
    if want[0] or want[1]:
        if img_hist is None:  # odd-sized image: reflect padding taints the sum
            img_hist = value_histogram(fj, 65536)
        bright = torch.clamp(
            percentile_from_hist(img_hist, fj.numel(), 99.9999), min=1.0)
        if want[0]:
            frame_hc = _stretch(fj, bright * 0.25, bright)
        if want[1]:
            frame_protus = _stretch(fj, 0.0, torch.clamp(bright * 0.18, min=1.0))
    return cl1, cc, frame_hc, frame_protus


def _products_core_gained(fj: torch.Tensor, gain: torch.Tensor, want=(True, True)):
    """Transversalium row-gain multiply followed by the products; returns
    (detrans, cl1, cc, high_contrast, protus)."""
    detrans = apply_row_gain(fj, gain)
    return (detrans,) + _products_body(detrans, want)


def host_products_enabled() -> bool:
    """Whether the product core runs on the host: exactly in the host
    pipeline."""
    return host_pipeline()


def _np_percentile_from_counts(counts: np.ndarray, n: int, q: float) -> float:
    """``float(np.percentile(img, q))`` from a uint16 value histogram.

    numpy's linear-interpolation quantile in float64 — the virtual index
    ``q/100 * (n-1)`` and the ``_lerp`` branch that switches to
    ``b - (b-a)*(1-t)`` at t >= 0.5 — on the two order statistics read from
    the histogram's CDF; bit-identical to np.percentile for integer
    images.
    """
    virtual = np.float64(q) / 100.0 * (n - 1)
    lo = int(np.floor(virtual))
    hi = int(np.ceil(virtual))
    c = np.cumsum(counts)
    a = np.float64(np.searchsorted(c, lo + 1, side="left"))
    b = np.float64(np.searchsorted(c, hi + 1, side="left"))
    t = np.float64(virtual - lo)
    if t >= 0.5:
        return float(b - (b - a) * (1.0 - t))
    return float(a + (b - a) * t)


def _stretch_lut(img: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The reference's linear stretch (solex_util.py:532-541) of a uint16
    image as a value LUT (the float32 form computed once a value, then
    ``lut_u16``): bit-identical to the float32 pass over the image."""
    vals = np.arange(65536, dtype=np.float32)
    x = 65535.0 * (vals - lo) / np.float32(hi - lo)
    lut = np.clip(x, 0, 65535).astype(np.uint16)
    return native.lut_u16(img, lut)


def _hist_u16(img: np.ndarray) -> np.ndarray:
    """np.bincount(img.ravel(), minlength=65536) of a uint16 image
    (``hist_u16``), int64."""
    return native.hist_u16(img).astype(np.int64)


def _products_body_host(f: np.ndarray, want=(True, True), hist_f=None):
    """Host twin of ``_products_body`` on a uint16 host image: (cl1, cc,
    high_contrast, protus), uint16 numpy, the stretches ``want`` does not
    ask for None.  CLAHE is the native library's (OpenCV's algorithm, its
    output histogram from the same pass); the stretch thresholds are
    np.percentile's, read off value histograms, so they can differ from
    the device core's histogram-CDF percentiles (JAX docs/PARITY.md,
    deviation 7)."""
    f = np.ascontiguousarray(f, dtype=np.uint16)
    cl1, hist_u32 = native.clahe_u16(f, 0.8, (2, 2), want_hist=True)
    hist_c = hist_u32.astype(np.int64)
    dark_clahe = _np_percentile_from_counts(hist_c, cl1.size, 10.0)
    cl1_max = float(65535 - int(np.argmax(hist_c[::-1] > 0)))
    bright_clahe = max(cl1_max, dark_clahe + 1.0)
    cc = _stretch_lut(cl1, dark_clahe, bright_clahe)

    want_hc, want_protus = want
    frame_hc = frame_protus = None
    if want_hc or want_protus:
        hist_f = _hist_u16(f) if hist_f is None else hist_f
        bright = max(_np_percentile_from_counts(hist_f, f.size, 99.9999), 1.0)
        if want_hc:
            frame_hc = _stretch_lut(f, bright * 0.25, bright)
        if want_protus:
            frame_protus = _stretch_lut(f, 0.0, max(bright * 0.18, 1.0))
    return cl1, cc, frame_hc, frame_protus


def _products_core_gained_host(f: np.ndarray, gain: np.ndarray,
                               want=(True, True)):
    """The row-gain multiply (``gain_hist_u16``, the brightness histogram
    from the same pass) followed by the host core: (detrans, cl1, cc,
    high_contrast, protus)."""
    f = np.ascontiguousarray(f, dtype=np.uint16)
    want_hist = want[0] or want[1]
    detrans, hist = native.gain_hist_u16(f, np.asarray(gain, np.float32),
                                         want_hist=want_hist)
    hist_f = hist.astype(np.int64) if hist is not None else None
    return (detrans,) + _products_body_host(detrans, want, hist_f=hist_f)


def _host_core(frame: torch.Tensor, gain, want):
    """The host core of a CPU image: (fj, cl1, cc, high_contrast, protus)
    as CPU tensors (None where not wanted)."""
    f = frame.numpy()
    if not np.issubdtype(f.dtype, np.integer):
        f = np.clip(f, 0, 65535)
    f = f.astype(np.uint16)
    if gain is not None:
        outs = _products_core_gained_host(f, gain, want)
    else:
        outs = (f,) + _products_body_host(f, want)
    return tuple(None if a is None else torch.from_numpy(a) for a in outs)


def needed_products(options: Options, save: bool = True):
    """(high_contrast, protus) consumption gates (solex_util.py:556-566):
    a stretch nothing saves or returns is not computed."""
    protus_needed = (
        not save
        or (not options._nolog and
            (options.protus_only or not options.clahe_only))
        or options.flag_display
    )
    hc_needed = options.flag_display or (
        save and not options._nolog
        and not options.clahe_only and not options.protus_only
    )
    return (hc_needed, protus_needed)


def crop_width(img: torch.Tensor, circle: Circle, options: Options):
    """Crop/pad to fixed width or square, centred on the disk, on the
    image's device.

    reference: Solex_recon.py:155-171 — pads with the corner pixel value,
    recentres the circle x to the new centre.
    """
    if options.fixed_width is None and not options.crop_width_square:
        return img, circle
    h, w = img.shape
    nw = h if options.fixed_width is None else options.fixed_width
    nw2 = nw // 2
    cx = w // 2 if circle == NO_CIRCLE else int(circle[0])
    tx = nw2 - cx
    src = as_int16(img)
    fill = src[:1, :1]
    new_img = fill.expand(h, nw).clone()
    src_lo, src_hi = max(0, cx - nw2), min(cx + nw2, w)
    new_img[:, : src_hi - src_lo] = src[:, src_lo:src_hi]
    if tx > 0:
        new_img = torch.roll(new_img, tx, dims=1)
        new_img[:, :tx] = fill
    if circle != NO_CIRCLE:
        circle = (nw2, circle[1], circle[2])
    return new_img.view(img.dtype), circle


def protus_disc(img: torch.Tensor, x0: int, y0: int, r: int,
                value: int = 80) -> torch.Tensor:
    """``cv2.circle(img, (x0, y0), r, value, -1)`` of a uint16 image on its
    own device, pixel for pixel (clipping at the image's edges included).
    Returns a new image.

    OpenCV fills a circle with a midpoint walk that draws one horizontal
    span per row (drawing.cpp, ``Circle``); the union of its spans is the
    set ``dx*dx + dy*dy <= r*r`` for every radius (the tests walk OpenCV's
    loop for each radius and compare with cv2 itself), so the mask needs
    no host round trip.
    """
    h, w = img.shape
    dy = torch.arange(h, device=img.device, dtype=torch.int64) - y0
    dx = torch.arange(w, device=img.device, dtype=torch.int64) - x0
    mask = (dy * dy)[:, None] + (dx * dx)[None, :] <= r * r
    src = as_int16(img)
    painted = torch.where(mask, torch.tensor(value, dtype=src.dtype,
                                             device=img.device), src)
    return painted.view(img.dtype)


def to_host(img: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array: from the card in one
    non-blocking copy into pinned memory (recorded on the tensor's device,
    since a pool thread starts on device 0), waited for here."""
    if img.device.type != "cuda":
        return img.numpy()
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    with torch.cuda.device(img.device):
        host.copy_(img, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
    ev.synchronize()
    return host.numpy()


def _save_fits_sync(path: str, img, header) -> None:
    write_fits(path, to_host(img) if isinstance(img, torch.Tensor) else img,
               header)


def save_fits(path: str, img, header) -> None:
    """FITS write on the writer pool of a tensor (brought down on the pool's
    thread) or of a host array (a slice of one bulk copy);
    pipeline/run.py joins it."""
    submit(_save_fits_sync, path, img, header)


def _save_png_sync(path: str, img: torch.Tensor) -> None:
    """Encode and write a (h, w) uint8/uint16 image.  From the card it
    comes down in the encoder's row bands, into pinned memory with
    non-blocking copies all queued at once, and band k is encoded while
    the later ones are in flight (counterpart of the JAX encoder's
    ``copy_to_host_async`` bands)."""
    if img.device.type != "cuda":
        write_png_streaming(path, img.numpy())
        return
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    arrived = []
    # the writer pool's threads start on device 0: the events must be
    # recorded on the image's device, on the stream that copies
    with torch.cuda.device(img.device):
        for a, b in band_bounds(img.shape[0]):
            host[a:b].copy_(img[a:b], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            arrived.append((a, b, ev))
    rows = host.numpy()

    def bands():
        for a, b, ev in arrived:
            ev.synchronize()
            yield rows[a:b]

    write_png_bands(path, rows.shape, rows.dtype, bands())


def _save_png(path: str, img: torch.Tensor) -> None:
    """PNG write on the writer pool; pipeline/run.py joins it."""
    submit(_save_png_sync, path, img)


def _rot(a: Optional[torch.Tensor], k: int) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.rot90(as_int16(a), k, dims=(0, 1)).contiguous().view(a.dtype)


def image_process(
    frame: torch.Tensor,
    circle: Circle,
    options: Options,
    header: Optional[Dict] = None,
    basefich: str = "",
    save: bool = True,
    gain: Optional[np.ndarray] = None,
):
    """CLAHE + stretches + protus disc + rotation + product files of one
    corrected disk.

    reference: solex_util.py:527-588.  Returns (clahe_image, protus_image)
    after rotation, uint16 on the frame's device; the protus image is None
    when nothing consumes it (the ``-c`` save set).  ``gain`` (H,) puts the
    transversalium row multiply in front of the products (``frame`` is then
    the pre-transversalium image).
    """
    want = needed_products(options, save)
    _, protus_needed = want
    if host_products_enabled():
        fj, cl1, cc, frame_hc, frame_protus = _host_core(frame, gain, want)
    else:
        fj = frame
        if fj.dtype.is_floating_point:
            # float input (de-vignette path): clip to the uint16 range
            # before the cast; the reference's numpy cast wraps values above
            # 65535 (solex_util.py:528), saturation is the JAX package's
            # choice too
            fj = torch.clamp(fj, 0, 65535)
        if fj.dtype != torch.uint16:
            fj = to_u16(fj)
        if gain is not None:
            g = torch.as_tensor(np.asarray(gain), dtype=torch.float32,
                                device=fj.device)
            fj, cl1, cc, frame_hc, frame_protus = _products_core_gained(
                fj, g, want)
        else:
            cl1, cc, frame_hc, frame_protus = _products_body(fj, want)
    frame_raw = fj

    # the disc is painted only when something will consume the image
    if protus_needed and circle != NO_CIRCLE and options.disk_display:
        x0, y0 = int(circle[0]), int(circle[1])
        r = int(circle[2]) + options.delta_radius
        if r > 0:
            frame_protus = protus_disc(frame_protus, x0, y0, r)

    k = options.img_rotate // 90
    if k:
        frame_raw, frame_hc, frame_protus, cc = (
            _rot(a, k) for a in (frame_raw, frame_hc, frame_protus, cc))

    if save and not options._nolog:
        if options.clahe_only or not options.protus_only:
            _save_png(output_path(basefich + "_clahe.png", options), cc)
        if options.protus_only or not options.clahe_only:
            _save_png(output_path(basefich + "_protus.png", options),
                      frame_protus)
        if not options.clahe_only and not options.protus_only:
            _save_png(output_path(basefich + "_uncontrasted.png", options),
                      frame_raw)
            _save_png(output_path(basefich + "_high_contrast.png", options),
                      frame_hc)
    if save and options.save_fit:
        save_fits(output_path(basefich + "_clahe.fits", options), cl1, header)
    return cc, frame_protus
