"""End-to-end single-file pipeline: read -> reconstruct -> correct -> products.

Counterpart of solex_ser_recon_en_tpu/pipeline/run.py (read_scan on the
device feed, single_image_process on the fused-gain branch, process_scan,
process_file).  reference: Solex_recon.py:49-174.  Data flow for one scan:

  SER file -> native reader, copy threads -> pinned staging ring -> raw
  chunks resident on the device                 (io/feeder.py, io/native.py)
      device: int32 sum + max over frames       (pass A, ops/fused.py)
      host:   cubic line fit (float64)          (geometry/linefit.py)
      device: multi-shift recon, kernel B3      (pass B, ops/recon_cuda.py)
      device: 4x downscale + Canny; host: ellipse LSQ (geometry/correct.py)
      device: circularisation warp, kernel B4   (ops/warp_fast.py)
      device: transversalium row statistics     (ops/rowstats.py)
      device: gain multiply, CLAHE + stretch, kernel B5 (pipeline/products.py)
      host:   PNG encode (native, band by band as the image comes down)

Supported options are those of the ``-c`` (clahe-only) path: shifts
(``-w``), ``-t``, ``-x``, ``-m``, ``-p`` and the image rotation; the
other product modes raise NotImplementedError.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Options
from ..geometry.correct import (
    NO_CIRCLE,
    Circle,
    correct_image,
    correct_images_batched,
    ellipse_to_circle,
)
from ..geometry.linefit import fit_spectral_line
from ..io.feeder import raw_device_chunks
from ..io.ser import SerReader
from ..io.writers import barrier as write_barrier
from ..ops.dtypes import as_int16
from ..ops.fused import RawScanProcessor
from ..utils.device import synchronize
from ..utils.log import RunLog
from ..utils.timer import StageTimer
from .products import image_process
from .transversalium import transversalium_gain


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
    basefich0: str
    mean_img: np.ndarray = None
    linefit: object = None


def check_supported(options: Options) -> None:
    """Raise for options outside the ported ``-c`` path."""
    unsupported = {
        "clahe_only=False (full product set with figures)": not options.clahe_only,
        "protus_only": options.protus_only,
        "save_fit (-f)": options.save_fit,
        "flag_display (-d)": options.flag_display,
        "crop_width_square (-s)": options.crop_width_square,
        "fixed_width (-r)": options.fixed_width is not None,
        "stubborn_transversalium": options.stubborn_transversalium,
        "de_vignette": options.de_vignette,
        "mesh": options.mesh is not None,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            "solex_ser_recon_en_torch runs the -c path only; not ported: "
            + ", ".join(bad)
        )


def read_scan(file: str, options: Options, device: torch.device,
              timer: Optional[StageTimer] = None) -> ScanResult:
    """Read a SER scan and reconstruct the per-shift disks on ``device``.

    reference: Solex_recon.py:49-83 — prepends the hidden
    [ellipse_fit_shift, 0] shifts (deduplicated), computes the mean and
    the line fit, and runs the recon.
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

    with timer.stage("line fit"):
        lf = fit_spectral_line(mean_img, max_img)
    log(f"Vertical limits y1, y2 : {lf.y1} {lf.y2}")
    log("Spectral line polynomial fit: " + str(lf.poly))

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
    return ScanResult(
        disk_list=disk_list,
        shifts=shifts,
        shift_requested=requested,
        backup_bounds=(lf.y1, lf.y2),
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
    options: Options,
    circle: Circle,
    borders,
    basefich: str,
    backup_bounds: Tuple[int, int],
    save: bool = True,
):
    """Per-shift post-processing after circularisation: the transversalium
    gain fused into the products (reference: Solex_recon.py:136-174)."""
    gain = None
    if options.transversalium:
        tr_circle, tr_borders = _transversalium_geometry(
            circle, borders, backup_bounds, frame.shape[1]
        )
        gain, _, _, _ = transversalium_gain(
            frame, tr_circle, tr_borders, options.trans_strength
        )
    return image_process(frame, options, basefich, save=save, gain=gain)


def process_scan(scan: ScanResult, options: Options,
                 timer: Optional[StageTimer] = None):
    """Geometric + photometric corrections and products for every shift.

    reference: Solex_recon.py:93-133 (solex_process).
    """
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
            phi, ratio = 0.0, 1.0
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
            else:
                phi, ratio = geo.phi, geo.ratio
                circle = geo.circle
                borders = geo.borders
            options.ratio_fixe = ratio
            options.slant_fix = math.degrees(phi)
            if flag_requested:
                with timer.stage("warp"):
                    frame_circularized, _, _ = correct_image(
                        scan.disk_list[i], phi, ratio,
                        np.array([-1.0, -1.0]), -1.0,
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
                        frame_circularized, _, _ = correct_image(
                            scan.disk_list[i], phi, ratio,
                            np.array([-1.0, -1.0]), -1.0,
                            log=log if i == 0 else None,
                        )
        if not flag_requested:
            continue
        with timer.stage("products"):
            out = single_image_process(
                frame_circularized, options, circle, borders, basefich,
                scan.backup_bounds,
            )
        results.append((s, out))
        log.complete()

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
        write_barrier()
