"""Final image products of the ``-c`` (clahe-only) path.

Counterpart of solex_ser_recon_en_tpu/pipeline/products.py
(``_products_body``, ``_products_core_gained``, ``image_process``).
reference math: solex_util.py:519-588 — CLAHE(0.8, 2x2) of the
transversalium-corrected disk, then a linear stretch between the CLAHE
image's 10th percentile and its maximum; the percentiles come from exact
value histograms (ops/clahe.py, kernel B5) instead of sorts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Options, output_path
from ..io.png import band_bounds, write_png_bands, write_png_streaming
from ..io.writers import submit
from ..ops.clahe import _clahe, percentile_from_hist, value_histogram
from ..ops.dtypes import as_int16, to_u16, widen
from ..ops.rowstats import apply_row_gain


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


def needed_products(options: Options, save: bool = True):
    """(high_contrast, protus) consumption gates (solex_util.py:556-566)."""
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


def image_process(
    frame: torch.Tensor,
    options: Options,
    basefich: str = "",
    save: bool = True,
    gain: Optional[np.ndarray] = None,
):
    """CLAHE + stretch + rotation + ``_clahe.png`` of one corrected uint16
    disk.

    ``gain`` (H,) fuses the transversalium row multiply in front of the
    products (``frame`` is then the pre-transversalium image).  Returns
    (clahe_image, protus_image); the protus image is None when nothing
    consumes it (the ``-c`` save set).
    """
    want = needed_products(options, save)
    if gain is not None:
        g = torch.as_tensor(np.asarray(gain), dtype=torch.float32,
                            device=frame.device)
        _, _, cc, _, frame_protus = _products_core_gained(frame, g, want)
    else:
        _, cc, _, frame_protus = _products_body(frame, want)

    k = options.img_rotate // 90
    if k:
        cc = torch.rot90(as_int16(cc), k, dims=(0, 1)).contiguous().view(
            torch.uint16)

    if save and not options._nolog:
        _save_png(output_path(basefich + "_clahe.png", options), cc)
    return cc, frame_protus
