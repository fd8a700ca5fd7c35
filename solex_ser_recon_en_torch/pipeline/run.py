"""End-to-end single-file pipeline: read -> reconstruct -> correct -> products.

Counterpart of solex_ser_recon_en_tpu/pipeline/run.py (read_scan with its
four feed policies, single_image_process, process_scan, process_file).
reference: Solex_recon.py:49-174.  Data flow for one scan on the
``device`` feed:

  SER or AVI file -> native reader (SER) or memmap planes (Y800 AVI),
  copy threads -> pinned staging ring -> raw chunks resident on the device
                                                (io/feeder.py, io/native.py)
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
``flag_display`` raises, and so does a run that wants figures where
matplotlib is absent.

Under a mesh (``Options.mesh``, or a prebuilt ``parallel/mesh.py:Mesh``
passed to ``read_scan``/``process_file``) the ``device`` and ``band``
feeds split every chunk's frames over the mesh's first row of frame
shards: pass A once a piece on its shard's device, the shards' sums and
maxima folded on the first device, kernel B3 once a shard, and the disks'
columns gathered on the first device, which is the run's ``device``;
``process_scan`` then runs there unchanged.  ``auto`` takes ``device``
under a mesh, as in the JAX package; the ``host`` feed does its work on
the host whatever the mesh.  The mesh's batch axis is the group read's
(pipeline/batch.py): one scan uses the first row.

The feeds (``Options.feed_mode``, ``--feed``):

- ``device``: the flow above.
- ``band``: pass A on the host (io/hostreduce.py: the native full sweep,
  or the fused sweep that also extracts a provisional band); only the
  recon's spectral band is uploaded, through the same pinned ring
  (io/feeder.py:band_device_chunks), and kernel B3 reconstructs from it
  (ops/fused.py:reconstruct_band); the small ops of the ellipse fit run
  on the CPU, the rest of the post-processing on the card.
- ``host``: pass A on the host (io/hostreduce.py:fast_passa, reading only
  the band's bytes, else the sweeps above), the float64 recon
  (``ser_recon_f64``), and the whole post-processing on the host (the
  host pipeline, utils/placement.py): native warp, row medians, CLAHE
  and LUT stretches.  No kernel runs.
- ``auto``: ``auto_feed``.

The JAX package's silent fallbacks for a remote link (``d2h_responsive``,
``FeedRateMonitor``/``FeedCollapse`` restarts) are not carried over
(ROADMAP A6); an error raises, and every decision is in the run log.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass, field
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
from ..io.feeder import (
    auto_chunk_frames,
    band_device_chunks,
    cached_probe_rate,
    note_small_scan,
    probe_transfer_rate,
    raw_device_chunks,
)
from ..io.fits import make_header
from ..io.hostreduce import (
    band_covers,
    fast_passa,
    host_mean_max,
    host_mean_max_band,
    host_mean_max_frames,
    host_reconstruct,
    host_reconstruct_frames,
    host_reconstruct_from_band,
    provisional_spectral_band,
    spectral_band,
)
from ..io.pagecache import pin
from ..io.video import _SerVideo, open_video
from ..io.writers import barrier as write_barrier
from ..io.writers import scan_writes, submit_figure
from ..ops.dtypes import as_int16
from ..ops.fused import RawScanProcessor, reconstruct_band
from ..parallel.mesh import Mesh, mesh_from_options, same_device
from ..utils.device import synchronize
from ..utils.log import RunLog
from ..utils.placement import set_host_pipeline, set_small_ops_on_host
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

    disk_list: torch.Tensor          # (S, ih, F) uint16 on the device (on
                                     # the CPU for the host feed)
    shifts: List[int]                # augmented shift list
    shift_requested: List[int]
    backup_bounds: Tuple[int, int]
    header: dict
    basefich0: str
    mean_img: np.ndarray = None
    linefit: object = None
    #: this scan's queued product writes (io/writers.py:scan_writes);
    #: process_scan joins them
    writes: list = field(default_factory=list)
    #: the feed policy's placement for THIS scan (utils/placement.py);
    #: process_scan re-asserts them on the thread that runs it
    small_ops_host: bool = False
    host_pipeline: bool = False
    #: the feed read_scan took
    feed: str = "device"


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
              timer: Optional[StageTimer] = None,
              mesh: Optional[Mesh] = None) -> ScanResult:
    """Read a SER or AVI scan and reconstruct the per-shift disks on
    ``device``.

    reference: Solex_recon.py:49-83 — prepends the hidden
    [ellipse_fit_shift, 0] shifts (deduplicated), computes the mean and
    the line fit, and runs the recon; saves ``_mean.fits`` / ``_raw.fits``
    (``-f``) and queues the spectral-line figure.  The scan is opened
    before its log is written: a file that cannot be read (a compressed
    AVI where cv2 is absent) leaves no file behind.  The writes it queues
    are the scan's (``ScanResult.writes``); if it fails, they are joined
    before its error propagates.

    ``mesh`` (default: built from ``Options.mesh`` on ``device``; its first
    device must be ``device``) shards the feed's frames; the disks come
    back gathered on ``device``.  A mesh larger than the visible cards
    raises before anything is written.
    """
    writes = []
    try:
        with scan_writes(writes):
            scan = _read_scan(file, options, device, timer, mesh)
    except BaseException:
        write_barrier(writes)
        raise
    scan.writes = writes
    return scan


#: the feed policies of read_scan (Options.feed_mode)
FEEDS = ("auto", "device", "band", "host")
#: scans above this many (normalised) bytes are rated with a fresh link
#: probe by the ``auto`` policy on the card; smaller ones consult the last
#: probe (JAX run.py:208-223)
AUTO_PROBE_BYTES = 256 * 1024**2
#: the ``auto`` policy takes the ``host`` feed below this link rate
AUTO_HOST_BELOW_BPS = 200e6
#: the fused band sweep of the ``band`` and ``host`` feeds: None decides
#: by the page-cache pin (taken when the scan could not be pinned and is
#: larger than 256 MB), True or False forces it (the JAX package's
#: SOLEX_FUSEDBAND / SOLEX_NO_FUSEDBAND)
FUSED_BAND = None


def auto_feed(vid, total_bytes: int, device: torch.device,
              mesh: Optional[Mesh] = None) -> Tuple[str, str]:
    """The ``auto`` feed policy: (feed, reason).

    On the card, the JAX package's rule for an accelerator (run.py:
    208-223): a SER over AUTO_PROBE_BYTES is rated by one probe a process
    (io/feeder.py:probe_transfer_rate) and goes ``host`` below
    AUTO_HOST_BELOW_BPS; a smaller SER consults the cached rate (and
    probes once a folder of small scans has fed more than a probe costs).
    Everything else is ``device``.  On the CPU ``auto`` is ``device``: the
    JAX package goes ``host`` there, but this package's CPU runs are its
    tests, which must drive the path the card runs (ROADMAP C).  Under a
    mesh it is ``device``, as in the JAX package (run.py:180-199): the
    mesh is there to shard the device feed.
    """
    if mesh is not None:
        return "device", "auto under a mesh"
    if device.type != "cuda":
        return "device", "auto on the CPU"
    if not isinstance(vid, _SerVideo):
        return "device", "auto, not a SER"
    if total_bytes > AUTO_PROBE_BYTES:
        rate = probe_transfer_rate(device)
    else:
        rate = cached_probe_rate()
        if rate is None and note_small_scan(total_bytes) > AUTO_PROBE_BYTES:
            rate = probe_transfer_rate(device)
    if rate is None:
        return "device", "auto, no link rate yet for a small scan"
    feed = "host" if rate < AUTO_HOST_BELOW_BPS else "device"
    return feed, f"auto, link {rate / 1e9:.3f} GB/s"


def _read_scan(file: str, options: Options, device: torch.device,
               timer: Optional[StageTimer],
               mesh: Optional[Mesh]) -> ScanResult:
    check_supported(options)
    if mesh is None:
        mesh = mesh_from_options(options.mesh, device)
    elif not same_device(mesh.first, device):
        raise ValueError(f"the mesh's first device {mesh.first} is not the "
                         f"run's device {device}")
    # the first row's frame shards split the device and band feeds
    shards = list(mesh.row(0)) if mesh is not None else None
    timer = timer or StageTimer()
    with timer.stage("open"):
        vid = open_video(file)
    basefich0 = os.path.splitext(file)[0]
    options.basefich0 = basefich0
    log = RunLog(basefich0, options)
    log.clear()
    log("Pixel shift : " + str(options.shift))
    requested = list(options.shift)
    options.shift_requested = requested
    shifts = list(dict.fromkeys([options.ellipse_fit_shift, 0] + requested))

    hdr = make_header(vid.iw, vid.ih)
    log(f"Width, Height : {vid.Width} {vid.Height}")
    log(f"Number of frames : {vid.frame_count}")

    is_ser = isinstance(vid, _SerVideo)
    total_bytes = vid.frame_count * vid.ih * vid.iw * 2
    keep_resident = total_bytes <= RESIDENT_CAP_BYTES

    # Feed policy: how much of the scan crosses to the card.
    #   device: every raw chunk (the resident two-pass path)
    #   band:   pass A on the host, only the recon's spectral band uploaded
    #   host:   pass A and a float64 recon on the host, and the whole
    #           post-processing there too (the host pipeline)
    feed, why = options.feed_mode, "requested"
    if feed not in FEEDS:
        raise ValueError(f"invalid feed mode {feed!r} (auto|device|band|host)")
    if feed == "auto":
        feed, why = auto_feed(vid, total_bytes, device, mesh)
    timer.note("feed", f"{feed} ({why})")
    log(f"Feed : {feed} ({why})")
    if mesh is not None:
        log(f"Mesh : {mesh.shape}, frame shards "
            f"{[str(d) for d in mesh.row(0)]}"
            + (" (not used by the host feed)" if feed == "host" else ""))
    small_ops_host = feed in ("band", "host")
    host_pipe = feed == "host"
    set_small_ops_on_host(small_ops_host)      # this (reading) thread
    set_host_pipeline(host_pipe)

    pinned = False
    if small_ops_host and is_ser:
        # the host feeds sweep the file at least twice: keep its pages
        # resident (io/pagecache.py; False when mlock is refused)
        pinned = pin(file)
        log(f"Page-cache pin : {pinned}")
    # the fused band sweep: worth it only where the page cache cannot be
    # trusted to keep the scan between the passes
    want_fused = (not pinned and total_bytes > 256 * 1024**2
                  if FUSED_BAND is None else FUSED_BAND)
    # the two-step pass A; -f wants the true full mean inline
    want_fast = feed == "host" and is_ser and not options.save_fit
    fast_lf = None           # verified LineFit of the banded fast pass A
    fused_band = None        # (band slab, x0, x1) of the fused sweep
    mem_frames = None        # the host feed's in-memory non-SER frames
    band_mode = False
    proc = None
    with timer.stage("mean/max"):
        if feed == "host" and not is_ser:
            mem_frames = vid.read_all()
            mean_img, max_img = host_mean_max_frames(mem_frames)
            passa = "in-memory host pass"
        elif small_ops_host and is_ser:
            band_mode = True
            r = vid._r
            passa = None
            if want_fast:
                miss = []
                fast = fast_passa(r, shifts, miss=miss)
                if fast is not None:
                    fast_lf, mean_img, max_img = fast[0], None, None
                    passa = (f"fast_passa (band [{fast[3]}, {fast[4]}) of "
                             f"{r.iw} columns)")
                else:
                    log(f"Fast pass A not taken: {miss[0]}")
            if passa is None and want_fused:
                x0p, x1p = provisional_spectral_band(r, shifts)
                band_bytes = ((x1p - x0p) * r.ih * r.frame_count
                              * r.header.dtype.itemsize)
                if band_bytes <= min(total_bytes // 3, 768 * 1024**2):
                    mean_img, max_img, slab = host_mean_max_band(r, x0p, x1p)
                    fused_band = (slab, x0p, x1p)
                    passa = f"fused band sweep (band [{x0p}, {x1p}))"
            if passa is None:
                mean_img, max_img = host_mean_max(r)
                passa = "full host sweep"
        else:
            raw_iter, rotate, upscale = raw_device_chunks(
                vid, options.frame_chunk, device, shards=shards)
            # the raw chunks' frame shape: stored, or (ih, iw) once decoded
            shape = (vid.Height, vid.Width) if rotate else (vid.ih, vid.iw)
            proc = RawScanProcessor(*shape, rotate, upscale, device, shards)
            # closing: an error between chunks must stop the feed's producer
            with contextlib.closing(raw_iter):
                for start, chunk, shard in raw_iter:
                    proc.accumulate(start, chunk, keep_resident, shard)
            mean_img, max_img = proc.mean_max()
            passa = "device" + (f", {len(shards)} frame shards"
                                if shards else "")
    timer.note("pass A", passa)
    log(f"Pass A : {passa}")

    if options.save_fit:
        save_fits(output_path(basefich0 + "_mean.fits", options), mean_img,
                  hdr)

    with timer.stage("line fit"):
        lf = fast_lf if fast_lf is not None else fit_spectral_line(
            mean_img, max_img)
    log(f"Vertical limits y1, y2 : {lf.y1} {lf.y2}")
    log("Spectral line polynomial fit: " + str(lf.poly))

    if figures_wanted(options):
        from . import plots

        if mean_img is None:
            # the banded fast pass A: the full mean exists nowhere; its
            # sweep runs on the figure lane
            submit_figure(
                plots.deferred_spectral_line_plot,
                output_path(basefich0 + "_spectral_line_data.png", options),
                file, lf,
            )
        else:
            submit_figure(
                plots.save_spectral_line_plot,
                output_path(basefich0 + "_spectral_line_data.png", options),
                mean_img, lf,
            )

    with timer.stage("recon"):
        if mem_frames is not None:
            disk_list = torch.from_numpy(host_reconstruct_frames(
                mem_frames, lf.floor, lf.frac, shifts))
            mem_frames = None
            passb = "host float64 recon of the frames in memory"
        elif host_pipe and band_mode:
            r = vid._r
            if fused_band is not None and band_covers(
                    fused_band[1], fused_band[2], lf.floor, lf.frac, shifts,
                    vid.iw):
                disks = host_reconstruct_from_band(
                    r, fused_band[0], fused_band[1], lf.floor, lf.frac,
                    shifts)
                passb = "host float64 recon from the band slab"
            else:
                if fused_band is not None:
                    log("Band slab does not cover the final fit's taps")
                disks = host_reconstruct(r, lf.floor, lf.frac, shifts)
                passb = "host float64 recon"
            disk_list = torch.from_numpy(disks)
        elif band_mode:
            r = vid._r
            x0, x1 = spectral_band(lf.floor, shifts, vid.iw)
            band_frame_bytes = ((x1 - x0) * vid.ih
                                * r.header.dtype.itemsize)
            chunk_n = auto_chunk_frames(band_frame_bytes,
                                        options.frame_chunk * 8)
            # serve the upload from the fused sweep's slab when it covers
            # the final band: the scan itself is not read again
            slab = None
            if fused_band is not None and (
                    fused_band[1] <= x0 and x1 <= fused_band[2]):
                b, bx0, _ = fused_band
                slab = (b[:, x0 - bx0:x1 - bx0, :] if r.flag_rotate
                        else b[:, :, x0 - bx0:x1 - bx0])
            band_iter, rotate, upscale = band_device_chunks(
                r, x0, x1, chunk_n, device, slab=slab, shards=shards)
            with contextlib.closing(band_iter):
                disk_list = reconstruct_band(
                    band_iter, lf.floor, lf.frac, shifts, vid.iw, x0, rotate,
                    upscale, device, vid.frame_count, shards)
            passb = (f"kernel B3 on the band [{x0}, {x1}) "
                     f"({'slab' if slab is not None else 'file'})"
                     + (f", once a frame shard of {len(shards)}"
                        if shards else ""))
        elif keep_resident:
            disk_list = proc.reconstruct(lf.floor, lf.frac, shifts)
            passb = "kernel B3 on the resident chunks" + (
                f", once a frame shard of {len(shards)}" if shards else "")
        else:
            raw_iter, _, _ = raw_device_chunks(vid, options.frame_chunk,
                                               device, shards=shards)
            with contextlib.closing(raw_iter):
                disk_list = proc.reconstruct_streaming(raw_iter, lf.floor,
                                                       lf.frac, shifts)
            passb = "kernel B3 on the streamed chunks"
        fused_band = None    # release the slab
        synchronize(device)
    timer.note("pass B", passb)
    log(f"Pass B : {passb}")

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
        small_ops_host=small_ops_host,
        host_pipeline=host_pipe,
        feed=feed,
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

    reference: Solex_recon.py:93-133 (solex_process).  On return, or on an
    error, the scan's product writes (its own and read_scan's) are joined:
    every data file exists, and a failed write is this scan's error.
    """
    check_supported(options)
    timer = timer or StageTimer()
    try:
        with scan_writes(scan.writes):
            return _process_shifts(scan, options, timer)
    finally:
        with timer.stage("products"):
            write_barrier(scan.writes)


def _process_shifts(scan: ScanResult, options: Options, timer: StageTimer):
    # may run on a pool thread (cli/main.py overlaps the scans): re-assert
    # this scan's placement on this thread
    set_small_ops_on_host(scan.small_ops_host)
    set_host_pipeline(scan.host_pipeline)
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
    return results


def process_file(file: str, options: Options, device: torch.device,
                 timer: Optional[StageTimer] = None,
                 mesh: Optional[Mesh] = None):
    """Full single-file pipeline (read + process).  Like the reference it
    mutates ``options`` (shift bookkeeping, fitted ratio/slant).  ``mesh``:
    as ``read_scan``'s."""
    timer = timer or StageTimer()
    try:
        scan = read_scan(file, options, device, timer, mesh)
        return process_scan(scan, options, timer)
    finally:
        # process_scan already joined on success; this covers error paths,
        # so a failing scan never leaks queued writes into the next file
        write_barrier()
