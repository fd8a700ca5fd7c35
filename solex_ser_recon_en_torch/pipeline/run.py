"""End-to-end single-file pipeline: read -> reconstruct -> correct -> products.

Counterpart of solex_ser_recon_en_tpu/pipeline/run.py (read_scan on the
device feed, single_image_process, process_scan, process_file).  reference: Solex_recon.py:49-174.  Data flow for
one scan:

  SER file -> native reader, copy threads -> pinned staging ring -> raw
  chunks resident on the device                 (io/feeder.py, io/native.py)
      device: int32 sum + max over frames       (pass A, ops/fused.py)
      host:   cubic line fit (float64)          (geometry/linefit.py)
      device: multi-shift recon, kernel B3      (pass B, ops/recon_cuda.py)
      device: 4x downscale + Canny; host: ellipse LSQ (geometry/correct.py)
      device: circularisation warp, kernel B4   (ops/warp_fast.py)
      device: de-vignette profiles (pipeline/vignette.py), on request
      device: transversalium row statistics     (ops/rowstats.py)
      device: gain multiply, CLAHE + stretches, kernel B5, crop, protus
              disc, rotation                    (pipeline/products.py)
      host:   PNG encode (native, band by band as the image comes down),
              FITS pack (native), diagnostic figures (matplotlib)

Every product mode of one scan runs: the default four-PNG set with its
three figures, ``-c``, ``protus_only``, ``-f`` (FITS), ``-s`` / ``-r``
(crops), ``stubborn_transversalium``, ``de_vignette``, and Doppler sweeps
(``-w a:b:c``), whose shifts are circularised by one batched warp and then
go through the per-shift products one after the other.
``flag_display`` and ``mesh`` raise, and so does a run that wants figures
where matplotlib is absent.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Options, output_path
from ..geometry.correct import (
    NO_CIRCLE,
    Circle,
    correct_image,
    correct_images_batched,
    ellipse_to_circle,
)
from ..geometry.linefit import fit_spectral_line
from ..io.feeder import raw_device_chunks
from ..io.fits import make_header
from ..io.ser import SerReader
from ..io.writers import barrier as write_barrier
from ..io.writers import submit_figure
from ..ops.dtypes import as_int16
from ..ops.fused import RawScanProcessor
from ..utils.device import synchronize
from ..utils.log import RunLog
from ..utils.timer import StageTimer
from .products import (
    crop_width,
    image_process,
    save_fits,
    to_host,
)
from .transversalium import correct_transversalium, transversalium_gain
from .vignette import remove_vignette


#: scans whose normalised u16 slab is larger than this are not kept on the
#: device after pass A; pass B re-reads them from the file
RESIDENT_CAP_BYTES = 4 * 1024**3


@dataclass
class ScanResult:
    """Everything read_scan produces (reference: Solex_recon.py:49-83)."""

    disk_list: torch.Tensor          # (S, ih, F) uint16 on the device
    shifts: List[int]                # augmented shift list
    shift_requested: List[int]
    backup_bounds: Tuple[int, int]
    header: dict
    basefich0: str
    mean_img: np.ndarray = None
    linefit: object = None


class FiguresNeedMatplotlib(RuntimeError):
    """The options ask for the diagnostic figures and matplotlib is absent."""


def figures_wanted(options: Options) -> bool:
    """Whether a run writes the three diagnostic figures
    (solex_util.py:263-273, :482-488, ellipse_to_circle.py:316-341)."""
    return (not options.clahe_only and not options.protus_only
            and not options._nolog)


def check_supported(options: Options) -> None:
    """Raise for the options this package does not run, and for a run that
    wants figures where matplotlib cannot be imported: before any file or
    log is written, never a silent skip of the figures."""
    unsupported = {
        "flag_display (-d)": options.flag_display,
        "mesh": options.mesh is not None,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            "solex_ser_recon_en_torch does not run: " + ", ".join(bad))
    if figures_wanted(options):
        try:
            import matplotlib  # noqa: F401
            from . import plots  # noqa: F401  (matplotlib's Agg figures)
        except ImportError as e:
            raise FiguresNeedMatplotlib(
                "these options write the diagnostic figures "
                "(_spectral_line_data.png, _ellipse_fit.png, "
                "_transversalium_correction.png), which need matplotlib, "
                f"and it cannot be imported ({e}); the clahe-only (-c) and "
                "protus_only product sets need no matplotlib") from e


def read_scan(file: str, options: Options, device: torch.device,
              timer: Optional[StageTimer] = None) -> ScanResult:
    """Read a SER scan and reconstruct the per-shift disks on ``device``.

    reference: Solex_recon.py:49-83 — prepends the hidden
    [ellipse_fit_shift, 0] shifts (deduplicated), computes the mean and
    the line fit, and runs the recon; saves ``_mean.fits`` / ``_raw.fits``
    (``-f``) and queues the spectral-line figure.
    """
    check_supported(options)
    timer = timer or StageTimer()
    basefich0 = os.path.splitext(file)[0]
    options.basefich0 = basefich0
    log = RunLog(basefich0, options)
    log.clear()
    log("Pixel shift : " + str(options.shift))
    requested = list(options.shift)
    options.shift_requested = requested
    shifts = list(dict.fromkeys([options.ellipse_fit_shift, 0] + requested))

    with timer.stage("open"):
        if os.path.splitext(file)[1].lower() != ".ser":
            raise NotImplementedError(f"{file}: only SER scans are supported")
        reader = SerReader(file)
    hdr = make_header(reader.iw, reader.ih)
    log(f"Width, Height : {reader.Width} {reader.Height}")
    log(f"Number of frames : {reader.frame_count}")

    keep_resident = (reader.frame_count * reader.ih * reader.iw * 2
                     <= RESIDENT_CAP_BYTES)
    with timer.stage("mean/max"):
        raw_iter, rotate, upscale = raw_device_chunks(
            reader, options.frame_chunk, device)
        proc = RawScanProcessor(reader.Height, reader.Width, rotate, upscale,
                                device)
        # closing: an error between chunks must stop the feed's producer
        with contextlib.closing(raw_iter):
            for start, chunk in raw_iter:
                proc.accumulate(start, chunk, keep=keep_resident)
        mean_img, max_img = proc.mean_max()

    if options.save_fit:
        save_fits(output_path(basefich0 + "_mean.fits", options), mean_img,
                  hdr)

    with timer.stage("line fit"):
        lf = fit_spectral_line(mean_img, max_img)
    log(f"Vertical limits y1, y2 : {lf.y1} {lf.y2}")
    log("Spectral line polynomial fit: " + str(lf.poly))

    if figures_wanted(options):
        from .plots import save_spectral_line_plot

        submit_figure(
            save_spectral_line_plot,
            output_path(basefich0 + "_spectral_line_data.png", options),
            mean_img, lf,
        )

    with timer.stage("recon"):
        if keep_resident:
            disk_list = proc.reconstruct(lf.floor, lf.frac, shifts)
        else:
            raw_iter, _, _ = raw_device_chunks(reader, options.frame_chunk,
                                               device)
            with contextlib.closing(raw_iter):
                disk_list = proc.reconstruct_streaming(raw_iter, lf.floor,
                                                       lf.frac, shifts)
        synchronize(device)

    if options.flip_x:
        disk_list = as_int16(disk_list).flip(2).view(torch.uint16)

    hdr["NAXIS1"] = disk_list.shape[2]  # recon width (reference :65)
    if options.save_fit:
        idxs = [i for i, s in enumerate(shifts) if s in requested]
        # one copy to the host for all the requested disks
        raw = to_host(as_int16(disk_list)[idxs].view(torch.uint16))
        for pos, i in enumerate(idxs):
            save_fits(
                output_path(basefich0 + f"_shift={shifts[i]}_raw.fits",
                            options), raw[pos], hdr)

    return ScanResult(
        disk_list=disk_list,
        shifts=shifts,
        shift_requested=requested,
        backup_bounds=(lf.y1, lf.y2),
        header=hdr,
        basefich0=basefich0,
        mean_img=mean_img,
        linefit=lf,
    )


def _transversalium_geometry(circle: Circle, borders, backup_bounds, width: int):
    """Correction geometry: the fitted circle, or the detect_bord backup
    band when no ellipse was fitted (reference: Solex_recon.py:145-146)."""
    if circle != NO_CIRCLE:
        return circle, borders
    return (0, 0, 99999), [
        0, backup_bounds[0] + 20, width - 1, backup_bounds[1] - 20,
    ]


def single_image_process(
    frame: torch.Tensor,
    hdr: dict,
    options: Options,
    circle: Circle,
    borders,
    basefich: str,
    backup_bounds: Tuple[int, int],
    save: bool = True,
):
    """Per-shift post-processing after circularisation: ``_circular.fits``,
    the transversalium correction (with its figure and
    ``_detransversaliumed.fits``), the crop and the products.

    reference: Solex_recon.py:136-174.
    """
    if save and options.save_fit:
        save_fits(output_path(basefich + "_circular.fits", options), frame,
                  hdr)

    if options.transversalium:
        tr_circle, tr_borders = _transversalium_geometry(
            circle, borders, backup_bounds, frame.shape[1]
        )
        # Nothing consumes the detransversaliumed intermediate (no fits
        # write, no crop, no stubborn filter): the row-gain multiply goes
        # in front of the products.  Bit-identical only for integer inputs
        # (the float de-vignette path casts before vs after the multiply),
        # so gate on the dtype.
        fuse = (
            not options.stubborn_transversalium
            and not (save and options.save_fit)
            and options.fixed_width is None
            and not options.crop_width_square
            and not frame.dtype.is_floating_point
        )
        if fuse:
            c, _, _, _ = transversalium_gain(
                frame, tr_circle, tr_borders, options.trans_strength
            )
        else:
            detrans, c = correct_transversalium(
                frame, tr_circle, tr_borders,
                trans_strength=options.trans_strength,
                stubborn=options.stubborn_transversalium,
            )
        if save and figures_wanted(options):
            from .plots import save_transversalium_plot

            submit_figure(
                save_transversalium_plot,
                output_path(basefich + "_transversalium_correction.png",
                            options),
                c,
            )
        if fuse:
            return image_process(
                frame, circle, options, hdr, basefich, save=save, gain=c
            )
    else:
        detrans = frame

    if save and options.save_fit and options.transversalium:
        save_fits(
            output_path(basefich + "_detransversaliumed.fits", options),
            detrans, hdr,
        )

    if options.fixed_width is not None or options.crop_width_square:
        detrans, circle = crop_width(detrans, circle, options)
    return image_process(detrans, circle, options, hdr, basefich, save=save)


def _warp_fixed(disk: torch.Tensor, phi: float, ratio: float, log=None):
    """Circularise one disk with a known (phi, ratio)."""
    return correct_image(disk, phi, ratio, np.array([-1.0, -1.0]), -1.0,
                         log=log)[0]


def process_scan(scan: ScanResult, options: Options,
                 timer: Optional[StageTimer] = None):
    """Geometric + photometric corrections and products for every shift.

    reference: Solex_recon.py:93-133 (solex_process).
    """
    check_supported(options)
    timer = timer or StageTimer()
    basefich0 = scan.basefich0
    log = RunLog(basefich0, options)
    if options.transversalium:
        log("Transversalium correction : " + str(options.trans_strength))
    else:
        log("Transversalium disabled")
    log("Mirror X : " + str(options.flip_x))
    log("Post-rotation : " + str(options.img_rotate) + " degrees")
    log(f"Protus adjustment : {options.delta_radius}")
    log(f"de-vignette : {options.de_vignette}")

    borders = [0, 0, 0, 0]
    circle: Circle = NO_CIRCLE
    results = []
    plots_on = figures_wanted(options)
    # Doppler sweeps warp every requested shift with the SAME correction
    # (Solex_recon.py:120-123): those warps run as one batched warp
    batched_warps = {}

    def batch_warp_pending(start_index: int, ratio: float, phi: float,
                           log=None) -> None:
        idxs = [j for j in range(start_index, len(scan.shifts))
                if scan.shifts[j] in scan.shift_requested]
        if len(idxs) < 2:
            return
        with timer.stage("warp"):
            stack = as_int16(scan.disk_list)[idxs].view(torch.uint16)
            warped, _, _ = correct_images_batched(stack, phi, ratio, log=log)
        for pos, j in enumerate(idxs):
            batched_warps[j] = warped[pos]

    for i, s in enumerate(scan.shifts):
        flag_requested = s in scan.shift_requested
        basefich = basefich0 + f"_shift={s}"
        frame_circularized = None
        if options.ratio_fixe is None and options.slant_fix is None:
            # first pass: full ellipse fit on the high-contrast disk.  Only
            # the fit is guarded: the warp (kernel B4) runs outside the try
            geo = None
            try:
                with timer.stage("ellipse fit"):
                    geo = ellipse_to_circle(scan.disk_list[i], log=log,
                                            need_image=False)
            except Exception as e:
                # reference asks for manual Y/X + tilt (README.md:110);
                # headless it degrades to an uncorrected geometry
                print(f"WARNING: ellipse fit failed ({e}); "
                      "proceeding without geometric correction")
                log(f"Ellipse fit FAILED: {e}; no geometric correction")
                options.ratio_fixe = 1.0
                options.slant_fix = 0.0
                if not flag_requested:
                    continue
                # a requested shift still yields its products, through the
                # identity geometry
                with timer.stage("warp"):
                    frame_circularized = _warp_fixed(scan.disk_list[i], 0.0,
                                                     1.0)
            else:
                circle = geo.circle
                borders = geo.borders
                options.ratio_fixe = geo.ratio
                options.slant_fix = math.degrees(geo.phi)
                # the hidden fit shift usually yields no product: its warp
                # runs only for a requested shift or for the fit's figure,
                # and once for both
                if flag_requested or plots_on:
                    with timer.stage("warp"):
                        geo.image = _warp_fixed(scan.disk_list[i], geo.phi,
                                                geo.ratio)
                    frame_circularized = geo.image
                if plots_on:
                    from .plots import save_ellipse_fit_plot

                    submit_figure(
                        save_ellipse_fit_plot,
                        output_path(basefich + "_ellipse_fit.png", options),
                        scan.disk_list[i], geo,
                    )
        else:
            ratio = options.ratio_fixe if options.ratio_fixe is not None else 1.0
            phi = (math.radians(options.slant_fix)
                   if options.slant_fix is not None else 0.0)
            if flag_requested:
                if i not in batched_warps:
                    batch_warp_pending(i, ratio, phi, log=log if i == 0 else None)
                if i in batched_warps:
                    frame_circularized = batched_warps.pop(i)
                else:
                    with timer.stage("warp"):
                        frame_circularized = _warp_fixed(
                            scan.disk_list[i], phi, ratio,
                            log=log if i == 0 else None)
                if options.de_vignette:
                    if circle == NO_CIRCLE:
                        print("WARNING: cannot de-vignette without ellipse fit")
                    else:
                        with timer.stage("de-vignette"):
                            frame_circularized = remove_vignette(
                                frame_circularized, circle)
        if not flag_requested:
            continue

        with timer.stage("products"):
            # stays float after de-vignette, like the reference (the cast
            # to uint16 happens at the product stage, solex_util.py:528)
            out = single_image_process(
                frame_circularized, scan.header, options, circle, borders,
                basefich, scan.backup_bounds,
            )
        results.append((s, out))
        log.complete()

    # join the overlapped product-file writes: on return every data file
    # exists (and worker errors surface here, attributed to this scan)
    with timer.stage("products"):
        write_barrier()
    return results


def process_file(file: str, options: Options, device: torch.device,
                 timer: Optional[StageTimer] = None):
    """Full single-file pipeline (read + process).  Like the reference it
    mutates ``options`` (shift bookkeeping, fitted ratio/slant)."""
    timer = timer or StageTimer()
    try:
        scan = read_scan(file, options, device, timer)
        return process_scan(scan, options, timer)
    finally:
        # process_scan already joined on success; this covers error paths,
        # so a failing scan never leaks queued writes into the next file
        write_barrier()
