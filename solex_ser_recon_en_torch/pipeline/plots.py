"""Diagnostic plot products.

The port's own copy of solex_ser_recon_en_tpu/pipeline/plots.py (the same
figures from the same inputs; images may also be tensors on any device and
come to the host when the figure renders).  matplotlib is imported by this
module and by nothing else of the package: pipeline/run.py imports it only
when a run's options want figures (``figures_wanted``), and refuses such a
run where matplotlib is absent before anything is written.

reference: solex_util.py:263-273 (_spectral_line_data.png),
ellipse_to_circle.py:316-341 (_ellipse_fit.png, 4 panels),
solex_util.py:482-488 (_transversalium_correction.png).
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.figure  # noqa: E402

# PNG is lossless at every zlib level; level 1 quarters the encode time
# of each diagnostic figure on the single host core (~35 ms each).
# (Pooling/reusing Figure objects was measured and rejected: ~10% at
# best and tight_layout drifts across reuses, making renders
# call-order-dependent.)
_FAST_PNG = {"compress_level": 1}


def _host(img) -> np.ndarray:
    """numpy view of a numpy array or of a tensor on any device."""
    return img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img)


def _bg(img, max_px: float = 2.5e5):
    """Strided downsample of a plot background image.

    Full-resolution imshow at dpi 300-400 costs minutes of host CPU on slow
    hosts for zero diagnostic value; the stride keeps the image coordinate
    frame via the returned extent so overlays stay aligned.  0.25 Mpx at
    dpi 110-120 keeps the figures legible while Agg's per-pixel resample
    stays off the per-file budget (the three figures cost ~0.9 s of the
    single host core at the previous 1.5 Mpx / dpi 150-300).
    """
    img = _host(img)
    h, w = img.shape[:2]
    step = max(1, int(np.ceil(np.sqrt(h * w / max_px))))
    return img[::step, ::step], (-0.5, w - 0.5, h - 0.5, -0.5)


def save_spectral_line_plot(path, mean_img, linefit) -> None:
    fig = matplotlib.figure.Figure()
    ax = fig.add_subplot(1, 1, 1)
    bg, extent = _bg(mean_img)
    ax.imshow(bg, cmap="gray", extent=extent)
    y1, y2 = linefit.y1, linefit.y2
    s = (y2 - y1) // 20 + 1
    ys = np.arange(y1, y2)[linefit.mask_good][::s]
    ax.plot(
        linefit.sharp_min[y1:y2][linefit.mask_good][::s],
        ys,
        "rx",
        label="line detection",
    )
    ax.plot(linefit.curve, np.arange(len(linefit.curve)), label="polynomial fit")
    ax.legend(loc="center left", bbox_to_anchor=(1, 0.5))
    ax.set_aspect(0.1)
    fig.tight_layout()
    fig.savefig(path, dpi=120, pil_kwargs=_FAST_PNG)


def deferred_spectral_line_plot(path, scan_path, linefit) -> None:
    """_spectral_line_data.png for the banded fast pass A, whose full mean
    image exists nowhere: the full-frame sweep (io/hostreduce.py:
    host_mean_max, the call a full sweep makes, so the figure's bytes are
    the same) runs here, on the figure lane, off the critical path."""
    from ..io.hostreduce import host_mean_max
    from ..io.ser import SerReader

    mean_img, _ = host_mean_max(SerReader(scan_path))
    save_spectral_line_plot(path, mean_img, linefit)


def save_ellipse_fit_plot(path, image_u16, geo) -> None:
    image = _host(image_u16)
    fig = matplotlib.figure.Figure()
    ax = [
        [fig.add_subplot(2, 2, 1), fig.add_subplot(2, 2, 2)],
        [fig.add_subplot(2, 2, 3), fig.add_subplot(2, 2, 4)],
    ]
    fig.tight_layout()
    bg, extent = _bg(image)
    bg = bg.astype(np.float64) / 65536  # divide after the downsample
    ax[0][0].imshow(bg, cmap="gray", extent=extent)
    ax[0][0].set_title("uncorrected image", fontsize=11)
    ax[0][0].set_aspect("equal")
    ax[0][1].set_aspect("equal")
    ax[0][1].imshow(bg, cmap="gray", extent=extent)
    ax[0][1].plot(geo.raw_edges[:, 1], geo.raw_edges[:, 0], "ro", label="edge detection")
    ax[0][1].legend(prop={"size": 6})
    ax[1][1].set_aspect("equal")
    ax[1][1].plot(geo.kept_edges[:, 1], geo.kept_edges[:, 0], "ro", label="filtered edges")
    ax[1][1].plot(geo.ellipse_pts[:, 1], geo.ellipse_pts[:, 0], color="b", label="ellipse fit")
    ax[1][1].set_ylim([image.shape[0], 0])
    ax[1][1].legend(prop={"size": 6})
    ax[1][0].set_aspect("equal")
    bg2, extent2 = _bg(geo.image)
    ax[1][0].imshow(bg2, cmap="gray", extent=extent2)
    for y in (geo.borders[1], geo.borders[3]):
        ax[1][0].axhline(y=y)
    for x in (geo.borders[0], geo.borders[2]):
        ax[1][0].axvline(x=x)
    ax[1][0].set_title("geometrically corrected image", fontsize=11)
    fig.savefig(path, dpi=110, pil_kwargs=_FAST_PNG)


def save_transversalium_plot(path, c) -> None:
    fig = matplotlib.figure.Figure()
    ax = fig.add_subplot(1, 1, 1)
    ax.plot(c)
    ax.set_xlabel("y")
    ax.set_ylabel("transversalium correction factor")
    fig.savefig(path, dpi=120, pil_kwargs=_FAST_PNG)
