#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (solex_ser_recon_en_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure exits non-zero before the final result line:

1. device: CUDA present; the card's name and power limit (nvidia-smi).
2. build: the kernels of csrc/ compiled from the checkout (nvcc), and the
   native host library csrc/ser_io.cpp (g++), with the compiler's version.
3. scan: the benchmark scan of bench.py (SyntheticScan, seed 5, stored
   wide) written as SER to a temporary directory.
4. end to end: ``cli.main.main(["-cw0", scan])`` twice.  The first run
   goes through capture hooks (kernel inputs, stage results); the second,
   timed, runs with no hook.  Over the second run pass A's kernel
   (sum_max) must be launched once per chunk the feeder made, kernel B3
   (recon) exactly once (one launch over all resident chunks), B5
   (tile_hist) exactly twice (the CLAHE tiles, the CLAHE image's value
   histogram) and B4 (hresample) at least once, and the host library's
   ``ser_read``, ``box_blur_u16_exact`` and ``png_encode_stored_band``
   must have been called (``io.native.CALLS``); the feed's line gives its
   copy threads, ring depth, wall time, the uploads' device time and the
   host's copy rate; the line fit, mean/max,
   shift-0 disk, fitted ratio and the corrected disk are checked against
   the scan's ground truth, and ``_shift=0_clahe.png`` against the
   corrected disk.
   Then the feed (io/feeder.py): every chunk it yields on the card must
   equal the plain feed's chunk bit for bit; a ``-cw0`` run on the plain
   feed must give the same mean, max and disks as run 1 and the same
   ``_clahe.png`` bytes; ``bench_feed.measure`` prints the host's copy rate
   by thread count, one 96 MB pinned upload, the seconds of the feed by
   thread count and of the plain feed, and the feed of a scan dropped from
   the page cache with and without readahead (information).  The line
   fit's blurs and the PNG encode run through the host library on the
   inputs run 1 gave them, against their plain versions (bit-identical),
   with host-clock times and their bound at the host's measured copy rate.
5. kernels vs plain: each kernel against its plain PyTorch version on the
   inputs the main path gave it in the first run (B3 over the resident
   chunks, B4, B5 on the images; bit-identical), both timed with CUDA
   events (median of repeats), with its bound (bytes once over 3.35 TB/s
   or operations over peak, the larger) and, where one PyTorch call
   computes the same function, that call's time; B3 and B5 also with
   their device time queued behind a sleep kernel, its share of the bound
   and their launches in run 2.  Pass A's kernel runs over the raw chunks
   that run 1 kept resident, one launch a chunk into fresh accumulators,
   against torch's reductions chunk by chunk (bit-identical), with the
   launches' queued device time, read rate and share of their bound.  The
   rows of B1 and B6 and pass A's second row are taken
   after phase 6, on the normalised slab phase 6 left resident: B1 at
   S = 2, B6 at S = 2 and at the S = 7 sweep of the shoot-out (both
   bit-identical), pass A's kernel against the three-pass torch route
   (bit-identical; each route's peak device memory beside it).  B1, B6 and
   pass A also get their queued device time, read rate and share of their
   bound; B6's launch geometry from the kernel library must equal its
   Python mirror.  B6's mean and max must equal B1's, its
   disks lie within 1 LSB of B1's (the share of differing pixels is
   printed), and its shift-0 disk within 1 LSB of a float64 lerp.  B1's
   line also gives its read rate and share of its bound at S = 2 and 7,
   and the card's read-rate yardstick: one ``torch.amax`` over the slab
   viewed as int32, with its GB/s.
6. resident path: ``bench_device.device_attached_decomposition`` on the
   phase-3 scan (upload, normalise, pass A, host line fit, the fused step
   of kernel B1, the real process_scan), its stage times printed with the
   card's name.  The launch counts of pass A's kernel, B1, B4 and B5 over
   it must be > 0;
   B1's mean and max must equal phase 4's pass-A mean and max, and its
   shift-10/0 disks phase 4's B3 disks, bit for bit; its _clahe.png must
   not be empty.  Every B1 launch of the path must take the bulk copy path
   (``fused_cuda.FUSED_PATHS``), and the kernel library's launch geometry
   must equal the wrapper's (``fused_plan_cuda`` vs ``fused_plan``).
   Information lines, no pass/fail: B1 against the two-pass route (pass
   A's kernel + B3; the three-pass torch reductions + B3 beside it) at
   S = 2, 7, 21 on the same slab, and the peak device memory of the run.
7. shoot-out: ``bench_kernels.run`` at full size (2000 x 2048 x 300, S = 2
   and 7; the post-processing rows on a 2074 x 2100 image), every row
   printed with the card's name.  The launch counts of B1, B6, B3, B4 and
   B5 over it must be > 0 (its "torch step" rows run PyTorch's own
   kernels only); a row that raises stops the script.

8. product modes: the other modes of one scan on the phase-3 scan, each
   driven with the launch counts set to 0 before it and read after it,
   its wall and stage times printed with the card's name.
   ``protus_only`` with ``-f`` at shift 0 (the fullest single-shift set
   that needs no matplotlib), through the CLI's file handler:
   ``_protus.png``, ``_mean``, ``_raw``, ``_circular``,
   ``_detransversaliumed`` and ``_clahe.fits`` must exist and no other
   product, each FITS read back with its shape and NAXIS1; the protus PNG
   must be the stretch of the corrected disk with exactly the raster's
   pixels painted at the fitted circle; ``_clahe.fits`` stretched (on the
   CPU) must give phase 4's ``_clahe.png`` within 1 LSB.  A ``-c`` sweep
   ``-w -9:9:3`` through ``cli.main.main``: one B4 launch for the 7 disks,
   B5 twice an image, shift 0's ``_clahe.png`` byte-identical to phase
   4's; the same sweep with ``-f``: 29 FITS (the mean and 4 a shift) read
   back with their shapes, one ``fits_pack_u16`` call each, every
   ``_clahe.png`` byte-identical to the sweep's without ``-f``.
   ``-c -r 1001`` (odd width) and ``-c -s``: the crop identical to the
   same function on a CPU copy of its captured input, the ``_clahe.png``
   within one CLAHE level (its stretch slope + 1 LSB, on < 0.01% of
   pixels) of the plain versions on the CPU.  ``-c`` with
   ``stubborn_transversalium`` and with ``de_vignette`` through
   ``process_file``: ``correct_transversalium`` and ``remove_vignette`` on
   the card against the same functions on CPU copies of their captured
   inputs (stubborn within 1 LSB, its mean filters sum in float64;
   de-vignette within 3e-7 relative, its float-frame transversalium
   within 1 LSB, gains within 1e-6).  The default mode must be refused
   with exit code 2, an error naming matplotlib and no file, where
   matplotlib is absent (and must write its 8 files where it is there);
   the two stretches no mode can save there come from
   ``_products_body(want=(True, True))`` and are held to a float64 numpy
   stretch within 1 LSB.  B5 on the odd-width images and B4 on the sweep's
   stack are held to their plain versions and timed (two more entries of
   the ``kernels`` line, ``tile_hist_r1001`` and ``hresample_sweep``).
   Information: ``image_process`` with its writes for one PNG, four PNGs
   and four PNGs + FITS, and one FITS pull, pack and write.
9. session: the session driver (cli/main.py) on a folder of three
   symlinks to the phase-3 scan, its frames at 8 bits as a SER and as a
   Y800 AVI (written here in RIFF/AVIX segments of <= 1 GiB), all stored
   wide: ``cli.main.main(["-c", "--input-dir", dir, ...])`` with the
   launch counts set to 0 before it must return 0, write one
   ``_clahe.png`` a scan, the symlinks' byte-identical to phase 4's and
   the AVI's to the 8-bit SER's (whose mean, max and disks the AVI's must
   equal), and launch B3 and B5 once and twice a scan, B4 at least once a
   scan and pass A once a chunk (the u8 launches counted apart); its
   wall, each file's stages and the peak device memory are printed, and
   beside them the wall of one ``main`` call per file (information).
   Pass A's kernel and B3 on the AVI's u8 chunks against their plain
   versions (two more entries of the ``kernels`` line, ``sum_max_u8`` and
   ``recon_u8``).  A folder of four same-shape 200 x 1024 x 150 u16 scans
   and a straggler of 180 frames: the session reads every file through
   ``read_scan`` (B3 once each), every ``_clahe.png`` byte-identical to
   its file run alone; ``pipeline/batch.py:read_scans_batched``, which the
   driver does not call, is called directly on the same five files: it
   must take the four (B3 once each) and leave the straggler, and the
   four's products must equal the session's; its wall and the session's
   over the four are printed side by side; ``--num-processes 2`` with
   ``--process-id`` 0 and 1 over it must write disjoint shares that cover
   it; ``--profile=dir`` on one ``-c`` run must write one trace that names
   a kernel of the port.
10. feeds: phase 4's default run (``--feed auto``) must have taken the
   ``device`` feed (the probed link rate is printed).  ``-cw0 --feed
   device``, ``--feed band`` and ``--feed host`` run twice each through
   ``cli.main.main``, the launch counts and host-library calls set to 0
   before each run and read after it; each run-2 wall, its stages, which
   pass A and pass B ran, the page-cache pin's result and the calls are
   printed with the card's name, and each run's line fit must equal phase
   4's.  ``band``: pass A on the host (0 launches of pass A's kernel), B3
   at least once, B4 once, B5 twice; mean and max equal phase 4's, its
   disks phase 4's B3 disks bit for bit.  ``host``: the fast pass A
   (``fast_passa``), no launch of pass A, B3, B4 or B5, host disks within
   1 LSB of phase 4's on < 2% of pixels, and the native sweeps, recon,
   warp, row medians, CLAHE and LUTs called.  Each feed's ``_clahe.png``
   against phase 4's and its fitted geometry are printed (information).
   A 7-shift ``-cw-9:9:3 --feed host`` sweep: no launch, one
   ``warp_u16_u16_batch`` call, shift 0's ``_clahe.png`` byte-identical to
   ``--feed host -cw0``'s.  B3 on the band run's chunks against its plain
   version (bit-identical; the ``recon_band`` entry of the ``kernels``
   line), and the newly driven host entry points against their numpy
   twins on the host run's inputs (entries of ``host_entry_points``).
11. other entry points: ``cli.analyse.main`` (``shg-torch-analyse``) on
   the phase-3 scan with ``--dispersion 0.05 --goto --save``: one slab
   upload, pass A's kernel once, B3 twice (the ellipse fit's shift and
   the saved one), B4 once, B5 twice.  Then ``SpectralAnalyser`` directly:
   its load's stages, one upload, pass A once and B3 once; its mean, max
   and shift-0 disk equal phase 4's bit for bit; ``save(0)`` (B3 1, B4 1,
   B5 2) timed, its ``_clahe.png`` against phase 4's (within 15 LSB,
   ROADMAP C4).  Auto-dispersion on two atlas-rendered scans (iw 300,
   0.043 and 0.085 A/px) within 1%.  ``cli.clahe_tool.main``
   (``shg-torch-clahe``) in a working directory of its own on phase 4's
   ``_clahe.png`` and its 8-bit copy, tiles 1-4 with and without
   ``--stretch``: B5 once an image, the output within 1 LSB on < 0.1% of
   pixels of ``--device cpu``'s (the stretched one within its slope x 1
   LSB + 1).  B3 on the analyser's normalised slab and B5 on the 8-bit
   image at the tool's four grids against their plain versions (the
   ``recon_normalised`` and ``tile_hist_u8`` entries).  ``python -m
   solex_ser_recon_en_torch -cw0`` as a subprocess on phase 9's g0.ser:
   its ``_clahe.png`` equals the in-process run's.
12. the device mesh (parallel/mesh.py), after phase 4's resident chunks
   are freed: ``-cw0`` through ``process_file`` under
   ``make_mesh({"frame": 4}, [card] * 4)`` (each chunk's frames in four
   pieces): pass A once a piece, B3 exactly 4 (once a shard), B4 at least
   once, B5 exactly twice; mean, max and disks bit-identical to phase
   4's, ``_clahe.png`` byte-identical; its wall beside phase 4's run-2
   wall (information: the shards run one after another on one card).  The
   band feed under the same mesh: B3 4, no pass A launch, disks equal
   phase 10's.  ``shg-torch -cw0 --mesh frame=2`` exits 2 with nothing
   written on a one-card machine (on two cards or more: ``-cw0`` on a mesh
   of cuda:0 and cuda:1 gives phase 4's ``_clahe.png``, and every kernel
   on cuda:1 launched while cuda:0 is current equals its plain version).
   The group read under a (batch=2, frame=2) mesh of the card over phase
   9's four small scans: B3 once a piece (8), disks equal the unsharded
   group read's.  ``shard_scan_recon`` (both recons) and
   ``device_pipeline_step`` (u16 and float outputs) on the card against
   the CPU, within the CPU tests' tolerances.  ``initialize`` with world
   size 1 on ``nccl``, one ``all_reduce`` on the card,
   ``destroy_process_group``.  Pass A's kernel and B3 on the mesh run's
   pieces against their plain versions (the ``sum_max_shard`` and
   ``recon_shard`` entries).  The phase must take under 30 s.
13. ``-d`` and the GUI: ``cli.main.main(["-cdw0", scan])`` under a
   recording display (``utils/display.py:Recorder``) must launch pass A
   once a chunk (25), B3 once a chunk (25: the live view's pattern; phase
   4's run launches it once), B4 once and B5 twice; every ``disk`` canvas
   must be the first columns of phase 4's shift-0 disk, the last all of
   it, every ``image`` the last frame of its chunk read from the SER with
   numpy and oriented, the ``Sun images`` trio the run's own CLAHE,
   high-contrast and protus images (the first ``_clahe.png``'s pixels),
   and ``_clahe.png`` byte-identical to phase 4's; its wall is printed
   beside phase 4's run 2.  B3 once a chunk on the run's chunks against
   its plain version and against phase 4's one launch (the
   ``recon_live`` entry, with the live view's readbacks timed on the host
   clock).  ``-cd`` with no display backend and no display server must
   exit 2 naming the display, nothing written.  The GUI:
   ``gui.main_window.run_app()`` with no device, under the tests'
   FreeSimpleGUI stub (loaded by path), one OK in File input mode with
   ``-c`` on the bench scan and phase 9's ``g0.ser``: it must take
   ``cuda``, call the progress meter once a file and once when done,
   launch B3 once a scan, and write ``_clahe.png`` files equal to phase 4's
   and phase 9's.  The phase should take under 30 s.
14. golden: phase 4's ``-cw0`` results against the port's reference
   replica (``utils/cpu_reference.py``: the reference's hot loops in numpy,
   its OpenCV calls as numpy stand-ins, so it runs without cv2), with the
   host CPU's model printed beside the card.  Gated (every miss printed,
   then the script fails): pass A's mean and max equal ``cpu_mean_max``
   of the scan bit for bit; the line fit within 2 px of ``cpu_line_fit``
   on every row (the replica fits its blurred argmin once, ~0.8 px off the
   true line; both fits' distance from the true line is printed);
   ``cpu_recon`` with the port's fit at shifts [10, 0] within 1 LSB of
   B3's disks on < 2% of pixels; ``cpu_products`` of B3's shift-0 disk and
   the port's product core on the card (B5 exactly twice) on the same
   disk: the CLAHE stretches within 4 LSB; the high-contrast stretch's
   99.9999th percentile on the card equal to the float32 lerp of the
   disk's two order statistics (both packages' float32 index, ROADMAP
   C19) and the replica's stretch at that percentile within 4 LSB of the
   card's (the difference at numpy's own percentile is printed).  Then the
   replica's ``-c`` leg as bench.py pairs it, ``cpu_pipeline(scan, [0],
   clahe_only=True, transversalium=True)``: its wall (``cpu_reference_s``)
   and its ratio to phase 4's run 2, the replica's circle beside the
   port's fitted one, and its ``_clahe.png`` against phase 4's (max and
   mean difference; information: the two differ by design in the warp
   and in transversalium).

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and the one before that the
per-kernel JSON record (the host library's entry points have a JSON line
of their own before it, ``host_entry_points``): each entry's launches are those of the path whose
inputs its times were taken on, and pass A has three entries, ``sum_max``
(the -cw0 path's raw chunks), ``sum_max_resident`` (the slab) and
``sum_max_u8`` (the session's u8 chunks); B3 has ``recon``, ``recon_u8``,
``recon_band`` (the band feed's chunks) and ``recon_normalised`` (the
analyser's slab), B5 ``tile_hist``, ``tile_hist_r1001`` and
``tile_hist_u8`` (the CLAHE tool's 8-bit image); pass A and B3 also have
``sum_max_shard`` and ``recon_shard`` (phase 12's pieces), and B3
``recon_live`` (phase 13's once-a-chunk pattern under ``-d``).  The script
imports nothing of JAX, and prints the seconds phases 1-14 took.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# benchmark scan (bench.py:49-50, 79-87)
FRAMES, IH, IW = 2000, 2048, 300
SQUASH, SHEAR = 1.08, 0.02

REPLACES = {
    "recon": ("solex_ser_recon_en_torch/csrc/recon.cu",
              "solex_ser_recon_en_tpu/ops/pallas_recon.py:31"),
    "hresample": ("solex_ser_recon_en_torch/csrc/warp.cu",
                  "solex_ser_recon_en_tpu/ops/warp_fast.py:76"),
    "tile_hist": ("solex_ser_recon_en_torch/csrc/hist.cu",
                  "solex_ser_recon_en_tpu/ops/clahe.py:54"),
    "shg_fused": ("solex_ser_recon_en_torch/csrc/fused.cu",
                  "solex_ser_recon_en_tpu/ops/fused_pallas.py:81, :42"),
    "shg_fused_mxu": ("solex_ser_recon_en_torch/csrc/fused_mxu.cu",
                      "solex_ser_recon_en_tpu/ops/fused_pallas.py:137"),
    # pass A: no Pallas kernel on the TPU side, XLA's sum and max
    "sum_max": ("solex_ser_recon_en_torch/csrc/sum_max.cu",
                "solex_ser_recon_en_tpu/ops/fused.py:33-34 (an XLA "
                "reduction, not a Pallas kernel)"),
}
#: the kernels of each driven path: phase 4 (-cw0), phase 6 (resident) and
#: phase 7 (the shoot-out)
CW0_KERNELS = ("sum_max", "recon", "hresample", "tile_hist")
RESIDENT_KERNELS = ("sum_max", "shg_fused", "hresample", "tile_hist")
SHOOTOUT_KERNELS = ("shg_fused", "shg_fused_mxu", "recon", "hresample",
                    "tile_hist")
#: the host library's entry points the -cw0 path must go through
#: (csrc/ser_io.cpp, io/native.py): the feed, the line fit's blurs, the PNG
HOST_ENTRY_POINTS = ("ser_read", "box_blur_u16_exact",
                     "png_encode_stored_band")

#: H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): HBM bytes/s and
#: operations/s by type.  The data sheet lists no int32 rate; integer adds
#: and maxima are counted at the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int32": 67e12, "f64_tensor": 67e12}


def bound(nbytes: int, ops: dict):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the slowest type's operations
    over its peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tap_columns(ind_l, iw: int) -> int:
    """Distinct tap columns over all rows: what a two-tap recon must read
    of each frame (taps clipped to [0, iw-2] as the kernels do)."""
    import torch

    l = ind_l.long().clamp(0, iw - 2)
    cols = torch.cat([l, l + 1]).sort(dim=0).values
    return int(cols.shape[1] + (cols.diff(dim=0) != 0).sum().item())


def mxu_chunks(ind_l, iw: int) -> int:
    """The 4-column K chunks kernel B6 contracts per 8 frames, summed over
    rows and groups of 8 shifts (its window: csrc/fused_mxu.cu)."""
    l = ind_l.long()
    lo, hi = l.clamp(0, iw - 1), (l + 1).clamp(0, iw - 1)
    total = 0
    for g in range(0, l.shape[0], 8):
        a = lo[g:g + 8].min(dim=0).values
        b = hi[g:g + 8].max(dim=0).values
        total += int(((b - (a & ~3)) // 4 + 1).sum().item())
    return total


def float64_lerp(frames, floor, frac):
    """The shift-0 disk (ih, F) of a normalised u16 slab (a tensor on any
    device) by a float64 lerp of its frames, clipped and truncated
    (int32)."""
    import torch

    from solex_ser_recon_en_torch.ops.dtypes import as_int16, widen

    F, ih, iw = frames.shape
    dev = frames.device
    l = torch.from_numpy(np.clip(floor, 0, iw - 2)).long().to(dev)
    w = torch.from_numpy((1.0 - frac).astype(np.float32).astype(np.float64)
                         ).to(dev)
    ys = torch.arange(ih, device=dev)
    src = as_int16(frames)
    a = widen(src[:, ys, l].view(torch.uint16)).double()
    b = widen(src[:, ys, l + 1].view(torch.uint16)).double()
    return (a * w + b * (1.0 - w)).clamp(0, 65535).to(torch.int32).T


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` calls queued behind a
    sleep kernel, so that the host's launch time is hidden and the CUDA
    events bracket only the card's work."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def make_scan(path: str):
    from solex_ser_recon_en_torch.io.ser import write_ser
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan

    scan = SyntheticScan(
        ih=IH, iw=IW, frames=FRAMES, depth=16,
        line_poly=(150.0, 0.005, -2e-6, 1e-9),
        squash_y=SQUASH, shear=SHEAR,
        disk_radius=int(0.42 * FRAMES),
        trans_stripes=0.08, noise=0.002, seed=5,
    )
    full = scan.generate()                      # (F, ih, iw) normalised
    write_ser(path, np.rot90(full, k=-1, axes=(1, 2)))   # stored wide
    return scan, full


def write_y800_avi(path: str, frames, segment_bytes: int = 1 << 30) -> None:
    """(F, H, W) uint8 frames as an uncompressed grey-scale (Y800) AVI, one
    '00dc' chunk a plane, in a 'RIFF AVI ' segment and as many OpenDML
    'RIFF AVIX' segments as ``segment_bytes`` (at most 1 GiB each) asks
    for; written frame by frame (after tests/test_avi.py's
    _write_y800_avi_raw)."""
    import struct

    n, h, w = frames.shape
    plane = h * w
    step = 8 + plane + (plane & 1)          # chunk header, plane, padding

    def chunk(fourcc, data):
        return fourcc + struct.pack("<I", len(data)) + data + (
            b"\x00" if len(data) & 1 else b"")

    def lst(ltype, payload):
        return chunk(b"LIST", ltype + payload)

    avih = struct.pack("<14I", 33333, 0, 0, 0, n, 0, 1, 0, w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"Y800" + struct.pack("<I", 0)
            + struct.pack("<10I", 0, 0, 0, 1, 30, 0, n, 0, 0, 0))
    strf = struct.pack("<I2i2H2I2i2I", 40, w, h, 1, 8, 0x30303859,
                       plane, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    with open(path, "wb") as f:
        start, first = 0, True
        while start < n or first:
            head = 12 + (len(hdrl) if first else 0) + 12
            k = min(n - start, max(1, (segment_bytes - head) // step))
            movi = 4 + k * step
            riff = 4 + (len(hdrl) if first else 0) + 8 + movi
            f.write(b"RIFF" + struct.pack("<I", riff)
                    + (b"AVI " + hdrl if first else b"AVIX"))
            f.write(b"LIST" + struct.pack("<I", movi) + b"movi")
            for i in range(start, start + k):
                f.write(b"00dc" + struct.pack("<I", plane))
                f.write(np.ascontiguousarray(frames[i]).tobytes())
                if plane & 1:
                    f.write(b"\x00")
            start, first = start + k, False


def ground_truth_checks(scan, full, res, frame) -> dict:
    """The port's intermediate results against the synthetic truth."""
    import torch

    out = {}
    sr = res["scan"]
    lf = sr.linefit
    ys = np.arange(lf.y1, lf.y2)
    dev = float(np.max(np.abs(lf.curve[ys] - scan.line_center(ys))))
    out["line_fit_max_px"] = dev
    if dev > 1.0:
        fail(f"line fit off the true line by {dev:.3f} px")

    total = full.sum(axis=0, dtype=np.int64)
    mean_truth = (total.astype(np.float64) / full.shape[0]).astype(np.uint16)
    if not np.array_equal(sr.mean_img, mean_truth):
        fail("mean image differs from the exact frame mean")
    if not np.array_equal(res["max_img"], full.max(axis=0)):
        fail("max image differs from the exact frame max")

    zi = sr.shifts.index(0)
    disk = sr.disk_list[zi].cpu().numpy().astype(np.int64)
    ref = float64_lerp(torch.from_numpy(full), lf.floor, lf.frac).numpy()
    lsb = int(np.abs(disk - ref).max())
    out["disk_max_lsb_vs_float64"] = lsb
    if lsb > 1:
        fail(f"shift-0 disk differs from the float64 lerp by {lsb} LSB")
    corr = float(np.corrcoef(disk.ravel(), scan.disk_brightness().ravel())[0, 1])
    out["disk_corr_vs_truth"] = corr
    if corr < 0.98:
        fail(f"shift-0 disk correlates {corr:.4f} with the true disk")

    ratio = res["opts"].ratio_fixe
    out["ratio"] = ratio
    if res["opts"].slant_fix is None or abs(ratio - SQUASH) > SQUASH * (
            0.05 + abs(SHEAR)):
        fail(f"fitted Y/X ratio {ratio} vs injected {SQUASH}")
    img = frame.cpu().numpy().astype(np.float64)
    yy, xx = np.nonzero(img > 0.4 * img.max())
    round_ = (yy.max() - yy.min()) / (xx.max() - xx.min())
    out["corrected_extent_ratio"] = float(round_)
    if abs(round_ - 1.0) > 0.05:
        fail(f"corrected disk is not round: extent ratio {round_:.4f}")
    return out


#: numbers one phase measures for a later one (the host's best copy rate)
MEASURED = {}


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock milliseconds of ``fn()`` (after one warm call)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_phase(path, tmp, png, res, blur_args, args, calls, card,
               dev) -> list:
    """The feed against the plain feed (chunks, a whole -cw0 run, times)
    and the host library's blur and PNG encode against their plain
    versions on the main path's inputs; returns the entry points' records."""
    import torch

    from solex_ser_recon_en_torch import bench_feed
    from solex_ser_recon_en_torch.cli import main as cli_main
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.io import feeder
    from solex_ser_recon_en_torch.io import png as png_mod
    from solex_ser_recon_en_torch.io.ser import SerReader
    from solex_ser_recon_en_torch.ops import blur, fused
    from solex_ser_recon_en_torch.ops.dtypes import as_int16
    from solex_ser_recon_en_torch.pipeline import run as run_mod
    from solex_ser_recon_en_torch.utils.device import synchronize

    reader = SerReader(path)
    new, _, _ = feeder.raw_device_chunks(reader, Options().frame_chunk, dev)
    plain, _, _ = feeder.raw_device_chunks_plain(reader, Options().frame_chunk,
                                                 dev)
    n = 0
    for (s_new, c_new, _), (s_plain, c_plain, _) in zip(new, plain,
                                                         strict=True):
        if s_new != s_plain or c_new.dtype != c_plain.dtype or not \
                torch.equal(as_int16(c_new), as_int16(c_plain)):
            fail(f"the feed's chunk at frame {s_new} differs from the plain "
                 f"feed's at {s_plain}")
        n += c_new.shape[0]
    if n != reader.frame_count:
        fail(f"the feed gave {n} frames of {reader.frame_count}")
    print(f"feed: {feeder.FEED['chunks']} chunks, {n} frames, bit-identical "
          "to the plain feed's", flush=True)
    del reader, new, plain, c_new, c_plain

    # a whole -cw0 run on the plain feed against run 1 (the new feed)
    got = {}
    orig_read, orig_mm = cli_main.read_scan, fused.RawScanProcessor.mean_max
    orig_feed = run_mod.raw_device_chunks

    def read_scan(file, opts, dev, timer=None):
        got["scan"] = orig_read(file, opts, dev, timer)
        return got["scan"]

    def mean_max(self):
        out = orig_mm(self)
        got["max_img"] = out[1]
        return out

    out_plain = os.path.join(tmp, "out_plain_feed")
    cli_main.read_scan = read_scan
    fused.RawScanProcessor.mean_max = mean_max
    run_mod.raw_device_chunks = feeder.raw_device_chunks_plain
    t0 = time.perf_counter()
    rc = cli_main.main([*args[:2], "--output-dir", out_plain,
                        "--device", dev.type])
    synchronize(dev)
    wall_plain = time.perf_counter() - t0
    cli_main.read_scan, fused.RawScanProcessor.mean_max = orig_read, orig_mm
    run_mod.raw_device_chunks = orig_feed
    if rc != 0:
        fail("the -cw0 run on the plain feed failed")
    a, b = res["scan"], got["scan"]
    if not (np.array_equal(a.mean_img, b.mean_img)
            and np.array_equal(res["max_img"], got["max_img"])
            and torch.equal(as_int16(a.disk_list), as_int16(b.disk_list))):
        fail("mean, max or disks differ between the feed and the plain feed")
    with open(png, "rb") as f:
        png_bytes = f.read()
    with open(os.path.join(out_plain, os.path.basename(png)), "rb") as f:
        if f.read() != png_bytes:
            fail("_clahe.png differs between the feed and the plain feed")
    print(f"plain feed: -cw0 wall {wall_plain:.3f} s; mean, max, disks and "
          f"_clahe.png bytes equal the feed's [{card}]", flush=True)
    del got, a, b

    m = bench_feed.measure(path, dev)
    print(f"feed measurements: {json.dumps(m)} [{card}]", flush=True)
    best = max(m["staging_gbps"].values())
    MEASURED["copy_gbps"] = best
    scan_gb = m["scan_gb"]
    # the feed's bound: the larger of the uploads alone and the scan's bytes
    # over the host's best copy rate
    upload_ms = scan_gb * 1e3 / m["h2d_gbps"]
    copy_ms = scan_gb * 1e3 / best
    print(f"feed bound: the larger of the uploads alone ({upload_ms:.1f} ms "
          f"at {m['h2d_gbps']:.1f} GB/s) and the scan over the host's best "
          f"copy rate ({copy_ms:.1f} ms at {best:.2f} GB/s); feed "
          f"{1e3 * m['feed_s'][feeder.COPY_THREADS]:.1f} ms with "
          f"{feeder.COPY_THREADS} threads, plain feed "
          f"{1e3 * m['plain_feed_s']:.1f} ms [{card}]", flush=True)

    records = []
    rate = best * 1e6                       # bytes per millisecond
    # the line fit's blurs on the images run 1 gave them
    err, ms, pms, nbytes = 0, 0.0, 0.0, 0
    for img, kx, ky in blur_args:
        out = blur.box_blur_u16_host(img, kx, ky)
        err = max(err, int(np.abs(out.astype(np.int64) - blur.
                  box_blur_u16_host_plain(img, kx, ky)).max()))
        ms += host_ms(lambda: blur.box_blur_u16_host(img, kx, ky))
        pms += host_ms(lambda: blur.box_blur_u16_host_plain(img, kx, ky))
        nbytes += img.nbytes + out.nbytes
    records.append(dict(
        name="box_blur_u16_exact", replaces="numpy cumulative sums "
        "(ops/blur.py:box_blur_u16_host_plain)", calls=calls[
            "box_blur_u16_exact"], max_abs_err=err, ms=ms, plain_ms=pms,
        bound_ms=nbytes / rate,
        note=f"{[(i.shape, kx, ky) for i, kx, ky in blur_args]}"))

    # the PNG encode on the image run 2 wrote
    img = png_mod.read_png(png)
    p_new, p_plain = (os.path.join(tmp, n) for n in ("e_new.png",
                                                     "e_plain.png"))
    png_mod.write_png_streaming(p_new, img)
    png_mod.write_png_streaming_plain(p_plain, img)
    with open(p_new, "rb") as f, open(p_plain, "rb") as g:
        data = f.read()
        same = data == g.read() == png_bytes
    records.append(dict(
        name="png_encode_stored_band", replaces="numpy pack, struct and "
        "zlib framing (io/png.py:write_png_streaming_plain)",
        calls=calls["png_encode_stored_band"], max_abs_err=0 if same else 1,
        ms=host_ms(lambda: png_mod.write_png_streaming(p_new, img)),
        plain_ms=host_ms(lambda: png_mod.write_png_streaming_plain(p_plain,
                                                                   img)),
        bound_ms=(img.nbytes + len(data)) / rate,
        note=f"image {img.shape} {img.dtype}, file write included"))
    records.append(dict(
        name="ser_read", replaces="np.copyto from the memmap on the "
        "consumer's thread (io/feeder.py:raw_device_chunks_plain)",
        calls=calls["ser_read"], max_abs_err=0,
        ms=1e3 * m["feed_s"][feeder.COPY_THREADS],
        plain_ms=1e3 * m["plain_feed_s"],
        bound_ms=max(upload_ms, copy_ms),
        note="the whole feed of the scan, uploads included"))
    for r in records:
        print(f"host {r['name']}: {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms at "
              f"{best:.2f} GB/s, {r['calls']} calls in run 2, max_abs_err "
              f"{r['max_abs_err']} ({r['note']}) [{card}]", flush=True)
        if r["max_abs_err"] != 0:
            fail(f"host entry point {r['name']} differs from its plain "
                 "version")
    return records


def modes_phase(path, tmp, png4, card, dev, n_chunks) -> list:
    """Phase 8: the other product modes of one scan on the card (module
    docstring); returns the records of B4 and B5 on this phase's shapes."""
    import contextlib
    import importlib.util
    import io

    import torch

    from solex_ser_recon_en_torch.cli import main as cli_main
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.io import native, writers
    from solex_ser_recon_en_torch.io.fits import read_fits
    from solex_ser_recon_en_torch.io.png import read_png
    from solex_ser_recon_en_torch.ops import clahe, cuda_build, warp_fast
    from solex_ser_recon_en_torch.ops.clahe import (
        image_tile_histograms_plain,
        percentile_from_hist,
        tile_keys,
        value_histogram,
    )
    from solex_ser_recon_en_torch.ops.dtypes import as_int16, widen
    from solex_ser_recon_en_torch.pipeline import products
    from solex_ser_recon_en_torch.pipeline import run as run_mod
    from solex_ser_recon_en_torch.pipeline import transversalium, vignette
    from solex_ser_recon_en_torch.utils.timer import StageTimer

    timers = []

    class RecordingTimer(StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    caps = {}
    originals = {
        (run_mod, "image_process"): run_mod.image_process,
        (run_mod, "crop_width"): run_mod.crop_width,
        (run_mod, "correct_transversalium"): run_mod.correct_transversalium,
        (run_mod, "remove_vignette"): run_mod.remove_vignette,
        (warp_fast, "hresample"): warp_fast.hresample,
        (clahe, "image_tile_histograms"): clahe.image_tile_histograms,
        (cli_main, "StageTimer"): cli_main.StageTimer,
    }

    def image_process(frame, circle, *a, **k):
        caps["image_process"] = (frame, circle)
        return originals[(run_mod, "image_process")](frame, circle, *a, **k)

    def crop_width(img, circle, options):
        out = originals[(run_mod, "crop_width")](img, circle, options)
        caps["crop_width"] = (img, circle, out)
        return out

    def correct_transversalium(img, circle, borders, **k):
        out = originals[(run_mod, "correct_transversalium")](
            img, circle, borders, **k)
        caps["correct_transversalium"] = (img, circle, borders, k, out)
        return out

    def remove_vignette(frame, circle):
        out = originals[(run_mod, "remove_vignette")](frame, circle)
        caps["remove_vignette"] = (frame, circle, out)
        return out

    def hresample(*a):
        caps["hresample"] = a
        return originals[(warp_fast, "hresample")](*a)

    def image_tile_histograms(img, ty, tx, hs):
        if img.is_cuda:          # not the CPU comparisons of this phase
            caps.setdefault("tile_hist", {})[(tuple(img.shape), ty, tx)] = (
                img, ty, tx, hs)
        return originals[(clahe, "image_tile_histograms")](img, ty, tx, hs)

    hooks = {"image_process": image_process, "crop_width": crop_width,
             "correct_transversalium": correct_transversalium,
             "remove_vignette": remove_vignette, "hresample": hresample,
             "image_tile_histograms": image_tile_histograms,
             "StageTimer": RecordingTimer}
    for (obj, name) in originals:
        setattr(obj, name, hooks[name])

    def drive(tag, fn, expect):
        """One mode: counts to 0, run, counts read; ``expect`` maps a
        kernel to the launches the mode must make."""
        caps.clear()
        timers.clear()
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0
        for k in native.CALLS:
            native.CALLS[k] = 0
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        stages = {k: round(v * 1e3, 1) for k, v in timers[-1].times.items()
                  } if timers else {}
        print(f"mode {tag}: wall {wall:.3f} s, stages (ms) {stages}, "
              f"launches {launches}, fits_pack_u16 "
              f"{native.CALLS['fits_pack_u16']}, png bands "
              f"{native.CALLS['png_encode_stored_band']} [{card}]",
              flush=True)
        for name, n in expect.items():
            if launches[name] != n:
                fail(f"mode {tag}: kernel {name} was launched "
                     f"{launches[name]} times, not {n}")
        return launches

    def cli(tag, flags, out_dir, expect):
        def run():
            rc = cli_main.main([*flags, path, "--output-dir", out_dir])
            if rc != 0:
                fail(f"mode {tag}: the CLI returned {rc}")
        return drive(tag, run, expect)

    def names(d):
        return sorted(os.listdir(d))

    def stretch_levels(cl1):
        """(dark, bright) of the CLAHE image's stretch, as _products_body
        takes them."""
        dark = percentile_from_hist(value_histogram(cl1, 65536), cl1.numel(),
                                    10.0)
        return dark, torch.maximum(widen(cl1).max().to(torch.float32),
                                   dark + 1.0)

    def lsb(a, b):
        d = np.abs(np.asarray(a).astype(np.int64)
                   - np.asarray(b).astype(np.int64))
        return int(d.max()), float((d > 0).mean())

    base = {"sum_max": n_chunks, "recon": 1, "hresample": 1}
    try:
        # protus_only with -f at shift 0 (protus_only has no CLI letter: the
        # CLI's file handler with the options a GUI caller would set)
        out_p = os.path.join(tmp, "out_protus")
        os.makedirs(out_p)

        def protus_run():
            opts = Options(shift=[0], protus_only=True, save_fit=True,
                           disk_display=True, output_dir=out_p)
            run_mod.check_supported(opts)
            if cli_main.handle_files([path], opts, dev) != 1:
                fail("mode protus_only -f: the file was not processed")
            writers.figure_barrier()

        drive("protus_only -f", protus_run, {**base, "tile_hist": 2})
        frame, circle = caps["image_process"]
        h, w = frame.shape
        want = {"scan_mean.fits": ((IH, IW), IW),
                "scan_shift=0_raw.fits": ((IH, FRAMES), FRAMES),
                "scan_shift=0_circular.fits": ((h, w), w),
                "scan_shift=0_detransversaliumed.fits": ((h, w), w),
                "scan_shift=0_clahe.fits": ((h, w), w)}
        if names(out_p) != sorted([*want, "scan_log.txt",
                                   "scan_shift=0_protus.png"]):
            fail(f"mode protus_only -f wrote {names(out_p)}")
        fits = {}
        for name, (shape, naxis1) in want.items():
            data, hdr = read_fits(os.path.join(out_p, name))
            if data.shape != shape or hdr["NAXIS1"] != naxis1 or \
                    data.dtype != np.uint16 or hdr["NAXIS2"] != shape[0]:
                fail(f"{name}: shape {data.shape} {data.dtype}, header {hdr}")
            fits[name] = data
        detrans = torch.from_numpy(
            fits["scan_shift=0_detransversaliumed.fits"].copy())
        if not torch.equal(as_int16(detrans), as_int16(frame.cpu())):
            fail("_detransversaliumed.fits is not the frame the products saw")
        # the protus disc: the port's raster at the fitted circle, painted
        # on the stretch of the corrected disk, and nothing else
        x0, y0, r = int(circle[0]), int(circle[1]), int(circle[2])
        stretch = products._products_body(frame, (False, True))[3].cpu().numpy()
        yy, xx = np.ogrid[:h, :w]
        disc = (xx - x0) ** 2 + (yy - y0) ** 2 <= r * r
        got = read_png(os.path.join(out_p, "scan_shift=0_protus.png"))
        if not (np.array_equal(got, np.where(disc, 80, stretch))
                and disc.sum() > 3 * r * r and (stretch[disc] != 80).any()):
            fail("the protus disc does not cover exactly the raster's pixels")
        # _clahe.fits holds the image whose stretch is phase 4's _clahe.png
        cl1 = torch.from_numpy(fits["scan_shift=0_clahe.fits"].copy())
        dark, bright = stretch_levels(cl1)
        mx, frac = lsb(products._stretch(cl1, dark, bright).numpy(),
                       read_png(png4))
        print(f"protus_only -f: files {names(out_p)}; disc of {int(disc.sum())}"
              f" pixels at ({x0}, {y0}), r {r}; stretch of _clahe.fits vs "
              f"phase 4's _clahe.png: max {mx} LSB on {100 * frac:.4f}% "
              f"(stretched on the CPU)", flush=True)
        if mx > 1:
            fail(f"_clahe.fits stretched differs from _clahe.png by {mx} LSB")

        # a -c Doppler sweep: one batched warp, then each shift's products
        sweep = [s for s in range(-9, 10, 3)]
        out_w = os.path.join(tmp, "out_sweep")
        l_sweep = cli("-c sweep", ["-cw-9:9:3"], out_w,
                      {**base, "tile_hist": 2 * len(sweep)})
        sweep_args = caps["hresample"]
        stages_w = dict(timers[-1].times)
        pngs = [f"scan_shift={s}_clahe.png" for s in sweep]
        if names(out_w) != sorted([*pngs, "scan_log.txt"]):
            fail(f"the sweep wrote {names(out_w)}")
        with open(os.path.join(out_w, "scan_shift=0_clahe.png"), "rb") as f, \
                open(png4, "rb") as g:
            if f.read() != g.read():
                fail("the sweep's shift-0 _clahe.png differs from phase 4's")
        print(f"sweep: {len(sweep)} _clahe.png, shift 0 byte-identical to "
              f"phase 4's; products {1e3 * stages_w['products']:.1f} ms; warp "
              f"{1e3 * stages_w['warp']:.1f} ms in one B4 launch over "
              f"{tuple(sweep_args[0].shape)} [{card}]", flush=True)
        # the same sweep with -f: 4 FITS a shift and the mean, each pulled
        # and packed on a writer thread
        out_f = os.path.join(tmp, "out_sweep_f")
        cli("-cf sweep", ["-cfw-9:9:3"], out_f,
            {**base, "tile_hist": 2 * len(sweep)})
        kinds = ("raw", "circular", "detransversaliumed", "clahe")
        fits_names = ["scan_mean.fits"] + [
            f"scan_shift={s}_{k}.fits" for s in sweep for k in kinds]
        if names(out_f) != sorted([*pngs, *fits_names, "scan_log.txt"]):
            fail(f"the -f sweep wrote {names(out_f)}")
        if native.CALLS["fits_pack_u16"] != len(fits_names):
            fail(f"the -f sweep packed {native.CALLS['fits_pack_u16']} FITS, "
                 f"not {len(fits_names)}")
        h, w = read_png(os.path.join(out_f, pngs[0])).shape
        for name in fits_names[1:]:
            data, hdr = read_fits(os.path.join(out_f, name))
            shape = (IH, FRAMES) if name.endswith("_raw.fits") else (h, w)
            if data.shape != shape or data.dtype != np.uint16 or \
                    hdr["NAXIS1"] != shape[1]:
                fail(f"{name}: shape {data.shape} {data.dtype}, header {hdr}")
        for name in pngs:
            with open(os.path.join(out_f, name), "rb") as f, \
                    open(os.path.join(out_w, name), "rb") as g:
                if f.read() != g.read():
                    fail(f"{name} differs between the sweep with and "
                         "without -f")
        print(f"sweep -f: {len(fits_names)} FITS read back, every _clahe.png "
              f"byte-identical to the sweep's without -f; products "
              f"{1e3 * timers[-1].times['products']:.1f} ms against "
              f"{1e3 * stages_w['products']:.1f} ms without [{card}]",
              flush=True)

        # the crops: -r 1001 (odd width) and -s, each against the same
        # functions on CPU copies of the captured inputs
        records = []
        reps = 20
        for tag, flag, width in (("-c -r 1001", "-cr1001", 1001),
                                 ("-c -s", "-cs", IH)):
            out_c = os.path.join(tmp, "out" + flag)
            l_crop = cli(tag, [flag], out_c, {**base, "tile_hist": 2})
            img, circ, (cropped, circ2) = caps["crop_width"]
            opts = Options(fixed_width=1001 if width == 1001 else None,
                           crop_width_square=width != 1001)
            ref, ref_circ = products.crop_width(img.cpu(), circ, opts)
            if tuple(cropped.shape) != (IH, width) or circ2 != ref_circ or \
                    not torch.equal(as_int16(cropped.cpu()), as_int16(ref)):
                fail(f"mode {tag}: crop_width on the card differs from the "
                     "CPU's")
            # CLAHE's blend weights come from x / tile_width, which
            # PyTorch computes on the card as x * (1 / tile_width): one ulp
            # of a weight can turn a rounding tie, i.e. one CLAHE level,
            # which the stretch multiplies by its slope
            cl1_cpu, cc_cpu, _, _ = products._products_body(ref,
                                                            (False, False))
            dark, bright = stretch_levels(cl1_cpu)
            slope = 65535.0 / float(bright - dark)
            got = read_png(os.path.join(out_c, "scan_shift=0_clahe.png"))
            mx, frac = lsb(got, cc_cpu.numpy())
            print(f"mode {tag}: crop identical to the CPU's, _clahe.png "
                  f"{got.shape} vs the plain versions on the CPU: max {mx} "
                  f"LSB on {100 * frac:.4f}% (one CLAHE level is "
                  f"{slope:.2f} LSB after the stretch)", flush=True)
            if got.shape != (IH, width) or mx > math.ceil(slope) + 1 or \
                    frac > 1e-4:
                fail(f"mode {tag}: _clahe.png differs from the CPU's by "
                     f"{mx} LSB on {100 * frac:.4f}%")
            if width == 1001:
                hist_odd = sorted(caps["tile_hist"].items())
                l_r1001 = l_crop

        # B5 on the odd-width image (tiles reach into the reflected padding)
        hist = originals[(clahe, "image_tile_histograms")]
        err, ms, pms, lms, nbytes, nvals = 0, 0.0, 0.0, 0.0, 0, 0
        for _, a in hist_odd:
            err = max(err, (hist(*a) - image_tile_histograms_plain(*a)
                            ).abs().max().item())
            ms += cuda_ms(lambda: hist(*a), reps)
            pms += cuda_ms(lambda: image_tile_histograms_plain(*a), reps)
            keys = tile_keys(*a)
            T = a[1] * a[2]
            lms += cuda_ms(lambda: torch.bincount(keys, minlength=T * a[3]),
                           reps)
            nbytes += a[0].nbytes + T * a[3] * 4
            nvals += keys.numel()
        records.append(dict(
            name="tile_hist_r1001", kernel="tile_hist",
            launches=l_r1001["tile_hist"], err=err,
            ms=ms, plain_ms=pms, library_ms=lms,
            bound=bound(nbytes, {"int32": nvals}),
            note=f"images {[k for k, _ in hist_odd]} of the -c -r 1001 mode"))
        # B4 on the sweep's stack: one launch for 7 disks
        a = sweep_args
        hres = originals[(warp_fast, "hresample")]
        out = hres(*a)
        records.append(dict(
            name="hresample_sweep", kernel="hresample",
            launches=l_sweep["hresample"],
            err=(out - warp_fast.hresample_plain(*a)).abs().max().item(),
            ms=cuda_ms(lambda: hres(*a), reps),
            plain_ms=cuda_ms(lambda: warp_fast.hresample_plain(*a), reps),
            library_ms=None,
            bound=bound(sum(t.nbytes for t in a) + out.nbytes,
                        {"f32": 4 * out.numel()}),
            note=f"V {tuple(a[0].shape)} -> {tuple(out.shape)}, the 7-shift "
                 f"sweep's one launch"))
        del out, a, sweep_args

        # stubborn transversalium and de-vignette through process_file
        def lib_mode(tag, kw):
            out_l = os.path.join(tmp, "out_" + tag)
            os.makedirs(out_l)
            drive(tag, lambda: run_mod.process_file(
                path, Options(shift=[0], clahe_only=True, output_dir=out_l,
                              **kw), dev, RecordingTimer()),
                {**base, "tile_hist": 2})
            if names(out_l) != ["scan_log.txt", "scan_shift=0_clahe.png"]:
                fail(f"mode {tag} wrote {names(out_l)}")

        lib_mode("stubborn", dict(stubborn_transversalium=True))
        img, circ, borders, kw, (out, c) = caps["correct_transversalium"]
        t0 = time.perf_counter()
        ref, c_ref = transversalium.correct_transversalium(
            img.cpu(), circ, borders, **kw)
        cpu_s = time.perf_counter() - t0
        mx, frac = lsb(out.cpu().numpy(), ref.numpy())
        gain_err = float(np.abs(c / c_ref - 1).max())
        print(f"stubborn: the card's image vs the same function on the CPU "
              f"({cpu_s:.2f} s there): max {mx} LSB on {100 * frac:.3f}%, "
              f"gains within {gain_err:.2e} relative", flush=True)
        if mx > 1 or gain_err > 1e-6 or not kw["stubborn"]:
            fail(f"stubborn transversalium differs from the CPU's by {mx} "
                 f"LSB, gains {gain_err:.2e}")

        lib_mode("de-vignette", dict(de_vignette=True))
        frame, circ, out = caps["remove_vignette"]
        ref = vignette.remove_vignette(frame.cpu(), circ)
        if out.dtype != torch.float64 or out is frame:
            fail("remove_vignette did not correct the frame in float64")
        rel = ((out.cpu() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
        img, circ, borders, kw, (out, c) = caps["correct_transversalium"]
        ref, c_ref = transversalium.correct_transversalium(
            img.cpu(), circ, borders, **kw)
        mx, frac = lsb(out.cpu().numpy(), ref.numpy())
        gain_err = float(np.abs(c / c_ref - 1).max())
        print(f"de-vignette: float64 frame within {rel:.2e} relative of the "
              f"CPU's; its transversalium (a float frame): max {mx} LSB on "
              f"{100 * frac:.4f}%, gains within {gain_err:.2e}", flush=True)
        if rel > 3e-7 or mx > 1 or gain_err > 1e-6 or \
                not img.dtype.is_floating_point:
            fail("de-vignette or its transversalium differs from the CPU's")

        # the default mode: figures need matplotlib
        out_d = os.path.join(tmp, "out_default")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli_main.main([path, "--output-dir", out_d])
        if importlib.util.find_spec("matplotlib") is None:
            if rc != 2 or "matplotlib" not in text.getvalue() or \
                    "protus_only" not in text.getvalue() or names(out_d):
                fail(f"the default mode without matplotlib returned {rc}, "
                     f"wrote {names(out_d)}: {text.getvalue()}")
            print("default mode: refused with exit code 2, no file written: "
                  + text.getvalue().strip(), flush=True)
        elif rc != 0 or len(names(out_d)) != 8:
            fail(f"the default mode returned {rc}, wrote {names(out_d)}")

        # the two stretches no mode could save here, against float64 numpy
        frame, circle = caps["image_process"]       # the de-vignette run's
        frame = products.to_u16(frame) if frame.dtype != torch.uint16 else \
            frame
        f64 = widen(frame).cpu().numpy().astype(np.float64)
        top = max(float(np.percentile(f64, 99.9999)), 1.0)
        _, _, hc, pr = products._products_body(frame, (True, True))

        def stretch64(lo, hi):
            return np.clip(65535.0 * (f64 - lo) / (hi - lo), 0, 65535
                           ).astype(np.uint16)

        for tag, got, ref in (
                ("high_contrast", hc, stretch64(top * 0.25, top)),
                ("protus stretch", pr, stretch64(0.0, max(top * 0.18, 1.0)))):
            mx, frac = lsb(got.cpu().numpy(), ref)
            print(f"{tag} vs a float64 numpy stretch: max {mx} LSB on "
                  f"{100 * frac:.4f}%", flush=True)
            if mx > 1:
                fail(f"{tag} differs from the float64 stretch by {mx} LSB")

        # what the four PNGs of the default set, and -f, cost in products
        hdr = {"NAXIS1": frame.shape[1]}
        for tag, kw in (("-c (1 PNG)", dict(clahe_only=True)),
                        ("default (4 PNGs)", dict()),
                        ("default -f (4 PNGs, 1 FITS)", dict(save_fit=True))):
            def one():
                products.image_process(
                    frame, circle, Options(**kw), hdr,
                    os.path.join(tmp, "ip_shift=0"))
                writers.barrier()
            print(f"image_process + writes, {tag}: {host_ms(one, 3):.1f} ms "
                  f"[{card}]", flush=True)
        fits_img = products.to_host(frame)
        from solex_ser_recon_en_torch.io.fits import (
            write_fits,
            write_fits_plain,
        )
        fpath = os.path.join(tmp, "one.fits")
        print(f"one {fits_img.shape} u16 FITS: pinned pull "
              f"{host_ms(lambda: products.to_host(frame), 5):.2f} ms, "
              f"write_fits {host_ms(lambda: write_fits(fpath, fits_img, hdr), 5):.2f}"
              f" ms, write_fits_plain "
              f"{host_ms(lambda: write_fits_plain(fpath, fits_img, hdr), 5):.2f}"
              f" ms [{card}]", flush=True)
    finally:
        for (obj, name), fn in originals.items():
            setattr(obj, name, fn)
    return records


def session_phase(path, tmp, png4, card, dev, frames8) -> list:
    """Phase 9: the session driver on the card (module docstring); returns
    the records of pass A's kernel and B3 on the AVI's u8 chunks."""
    import contextlib
    import io

    import torch

    from solex_ser_recon_en_torch.cli import main as cli_main
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.io import feeder, native
    from solex_ser_recon_en_torch.io.ser import write_ser
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
    from solex_ser_recon_en_torch.ops import cuda_build, fused, fused_cuda
    from solex_ser_recon_en_torch.ops.dtypes import as_int16, widen
    from solex_ser_recon_en_torch.ops.recon import recon_chunks_plain
    from solex_ser_recon_en_torch.parallel.distributed import assign_files
    from solex_ser_recon_en_torch.pipeline.batch import read_scans_batched
    from solex_ser_recon_en_torch.pipeline.run import process_scan
    from solex_ser_recon_en_torch.utils.timer import StageTimer

    def zero_counts():
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0
        for k in native.CALLS:
            native.CALLS[k] = 0

    def pngs(d):
        out = {}
        for name in sorted(os.listdir(d)):
            if name.endswith("_clahe.png"):
                with open(os.path.join(d, name), "rb") as f:
                    out[name] = f.read()
        return out

    def quiet_main(argv):
        """cli.main with its per-file lines kept out of this output."""
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli_main.main(argv)
        if rc != 0:
            print(text.getvalue()[-4000:], flush=True)
            fail(f"session: cli.main({argv}) returned {rc}")
        return text.getvalue()

    # the folder: three names of the phase-3 scan, its frames at 8 bits as
    # a SER and as a Y800 AVI in RIFF/AVIX segments of <= 1 GiB
    folder = os.path.join(tmp, "session")
    os.makedirs(folder)
    links = [f"s{i}.ser" for i in (1, 2, 3)]
    for name in links:
        os.symlink(path, os.path.join(folder, name))
    t0 = time.perf_counter()
    write_ser(os.path.join(folder, "e8.ser"), frames8)
    t_ser = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_y800_avi(os.path.join(folder, "v8.avi"), frames8)
    t_avi = time.perf_counter() - t0
    print(f"session folder: 3 symlinks, e8.ser and v8.avi "
          f"{tuple(frames8.shape)} u8 ({os.path.getsize(os.path.join(folder, 'v8.avi')) / 1e9:.3f}"
          f" GB in {1 + (frames8.nbytes >> 30)} RIFF segments), written in "
          f"{t_ser:.1f} + {t_avi:.1f} s", flush=True)

    timers = {}

    class RecordingTimer(StageTimer):
        def __init__(self):
            super().__init__()
            timers[len(timers)] = self

    caps = {"u8_sum_max": 0, "u8_recon": 0, "scans": {}, "max": {}}
    orig = {"sum_max": fused.sum_max, "recon_chunks": fused.recon_chunks,
            "read_scan": cli_main.read_scan, "StageTimer": cli_main.StageTimer,
            "mean_max": fused.RawScanProcessor.mean_max}

    def sum_max(frames, total, mx):
        if frames.dtype == torch.uint8:
            caps["u8_sum_max"] += 1
        return orig["sum_max"](frames, total, mx)

    def recon_chunks(chunks, ind_l, left_w, rotate, upscale, out=None,
                     frame_offset=0):
        if chunks[0].dtype == torch.uint8:
            caps["u8_recon"] += 1
            if caps["file"].endswith(".avi"):   # the last of the folder
                caps["recon_u8"] = (list(chunks), ind_l, left_w, rotate,
                                    upscale)
        return orig["recon_chunks"](chunks, ind_l, left_w, rotate, upscale,
                                    out, frame_offset)

    def read_scan(file, opts, device, timer=None):
        caps["file"] = file
        sr = orig["read_scan"](file, opts, device, timer)
        caps["scans"][os.path.basename(file)] = sr
        caps["max"][os.path.basename(file)] = caps.pop("last_max", None)
        return sr

    def mean_max(self):
        got = orig["mean_max"](self)
        caps["last_max"] = got[1]
        return got

    out_f = os.path.join(tmp, "session_out")
    files = sorted(os.listdir(folder))
    try:
        fused.sum_max, fused.recon_chunks = sum_max, recon_chunks
        cli_main.read_scan, cli_main.StageTimer = read_scan, RecordingTimer
        fused.RawScanProcessor.mean_max = mean_max
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        held_r = torch.cuda.memory_reserved()
        zero_counts()
        t0 = time.perf_counter()
        quiet_main(["-c", "--input-dir", folder, "--output-dir", out_f])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        feed_last = dict(feeder.FEED)
        peak = torch.cuda.max_memory_allocated() - held
        reserved = torch.cuda.max_memory_reserved() - held_r
    finally:
        fused.sum_max, fused.recon_chunks = orig["sum_max"], orig[
            "recon_chunks"]
        cli_main.read_scan, cli_main.StageTimer = orig["read_scan"], orig[
            "StageTimer"]
        fused.RawScanProcessor.mean_max = orig["mean_max"]
    stages = {files[k]: {s: round(v * 1e3, 1) for s, v in t.times.items()}
              for k, t in timers.items()}
    print(f"session: {len(files)} scans in {wall:.3f} s (read of scan N+1 "
          f"beside the post-processing of scan N); peak device memory "
          f"{peak / 1e9:.3f} GB allocated, {reserved / 1e9:.3f} GB reserved "
          f"by the caching allocator (above the {held / 1e9:.3f} and "
          f"{held_r / 1e9:.3f} GB held before the run); launches "
          f"{launches}, of them u8: "
          f"pass A {caps['u8_sum_max']}, B3 {caps['u8_recon']} [{card}]",
          flush=True)
    print("session stages (ms): " + json.dumps(stages), flush=True)
    chunks16 = -(-FRAMES // feeder.auto_chunk_frames(IH * IW * 2, 512))
    chunks8 = -(-frames8.shape[0] // feeder.auto_chunk_frames(
        frames8[0].nbytes, 512))
    expect = {"sum_max": 3 * chunks16 + 2 * chunks8, "recon": len(files),
              "tile_hist": 2 * len(files)}
    for name, n in expect.items():
        if launches[name] != n:
            fail(f"session: kernel {name} was launched {launches[name]} "
                 f"times, not {n}")
    if launches["hresample"] < len(files) or caps["u8_recon"] != 2 or \
            caps["u8_sum_max"] != 2 * chunks8:
        fail(f"session: B4 {launches['hresample']} launches, u8 B3 "
             f"{caps['u8_recon']}, u8 pass A {caps['u8_sum_max']}")
    got = pngs(out_f)
    if sorted(got) != sorted(f[:-4] + "_shift=0_clahe.png" for f in files):
        fail(f"session wrote {sorted(got)}")
    with open(png4, "rb") as f:
        ref = f.read()
    for name in links:
        if got[name[:-4] + "_shift=0_clahe.png"] != ref:
            fail(f"session: {name}'s _clahe.png differs from phase 4's")
    if got["v8_shift=0_clahe.png"] != got["e8_shift=0_clahe.png"]:
        fail("session: the AVI's _clahe.png differs from the 8-bit SER's")
    a, b = caps["scans"]["v8.avi"], caps["scans"]["e8.ser"]
    if not (np.array_equal(a.mean_img, b.mean_img)
            and np.array_equal(caps["max"]["v8.avi"], caps["max"]["e8.ser"])
            and torch.equal(as_int16(a.disk_list), as_int16(b.disk_list))):
        fail("session: the AVI's mean, max or disks differ from the 8-bit "
             "SER's")
    print("session: the symlinks' _clahe.png equal phase 4's; the AVI's "
          "mean, max, disks and _clahe.png equal the 8-bit SER's", flush=True)
    del a, b, caps["scans"]

    print(f"session: the AVI's feed (the last scan, read beside s3.ser's "
          f"post-processing): {feed_last['chunks']} chunks, wall "
          f"{1e3 * feed_last['wall_s']:.1f} ms, copy threads busy "
          f"{1e3 * feed_last['copy_thread_s']:.1f} ms, filling "
          f"{1e3 * feed_last['fill_s']:.1f} ms, consumer waited "
          f"{1e3 * feed_last['consumer_wait_s']:.1f} ms for filled buffers "
          f"and {1e3 * feed_last['upload_wait_s']:.1f} ms for uploads "
          f"[{card}]", flush=True)

    # the same files, one main call each (the serial wall and each file's
    # stages with nothing beside it, information)
    out_s = os.path.join(tmp, "serial_out")
    timers.clear()
    t0 = time.perf_counter()
    try:
        cli_main.StageTimer = RecordingTimer
        for name in files:
            quiet_main(["-c", os.path.join(folder, name), "--output-dir",
                        out_s])
        torch.cuda.synchronize()
    finally:
        cli_main.StageTimer = orig["StageTimer"]
    wall_s = time.perf_counter() - t0
    print("serial stages (ms): " + json.dumps(
        {files[k]: {s: round(v * 1e3, 1) for s, v in t.times.items()}
         for k, t in timers.items()}), flush=True)
    if pngs(out_s) != got:
        fail("session: the per-file runs' _clahe.png differ from the "
             "session's")
    print(f"session: overlapped {wall:.3f} s, one main call per file "
          f"{wall_s:.3f} s, the same _clahe.png bytes [{card}]", flush=True)

    # the u8 rows of the kernels line: the AVI's raw chunks
    reps = 20
    records = []
    chunks, ind_l, left_w, rotate, upscale = caps.pop("recon_u8")
    hw = chunks[0].shape[1:]

    def pass_a(step):
        total = torch.zeros(hw, dtype=torch.int32, device=dev)
        mx = torch.zeros_like(total)
        for c in chunks:
            step(c, total, mx)
        return total, mx

    err = max((widen(x) - widen(y)).abs().max().item() for x, y in zip(
        pass_a(fused_cuda.sum_max), pass_a(fused_cuda.sum_max_plain)))
    acc_s = torch.zeros(hw, dtype=torch.int32, device=dev)
    acc_m = torch.zeros_like(acc_s)
    dms = device_ms(lambda: [fused_cuda.sum_max(c, acc_s, acc_m)
                             for c in chunks], reps)
    raw_bytes = sum(c.nbytes for c in chunks)
    bA = bound(raw_bytes + len(chunks) * 4 * acc_s.nbytes,
               {"int32": 2 * raw_bytes})
    records.append(dict(
        name="sum_max_u8", kernel="sum_max", launches=caps["u8_sum_max"],
        err=err, ms=cuda_ms(lambda: pass_a(fused_cuda.sum_max), reps),
        plain_ms=cuda_ms(lambda: pass_a(fused_cuda.sum_max_plain), reps),
        library_ms=None, bound=bA,
        note=f"{len(chunks)} launches, one a u8 chunk {tuple(chunks[0].shape)}"
             f" of the Y800 AVI (the last {chunks[-1].shape[0]} frames); "
             f"device {dms:.4f} ms, {raw_bytes / dms / 1e9:.3f} TB/s, "
             f"{100 * bA[0] / dms:.1f}% of bound; launches: the session's "
             f"u8 chunks (AVI and 8-bit SER)"))
    del acc_s, acc_m
    a = (chunks, ind_l, left_w, rotate, upscale)
    out = orig["recon_chunks"](*a)
    err = (widen(out) - widen(recon_chunks_plain(*a))).abs().max().item()
    n = sum(c.shape[0] for c in chunks)
    S, ih = ind_l.shape
    iw = chunks[0].shape[1] if rotate else chunks[0].shape[2]
    b3 = bound(tap_columns(ind_l, iw) * n + S * ih * n * 2 + ind_l.nbytes
               + left_w.nbytes, {"f32": 3 * S * ih * n})
    dms = device_ms(lambda: orig["recon_chunks"](*a), reps)
    records.append(dict(
        name="recon_u8", kernel="recon", launches=caps["u8_recon"], err=err,
        ms=cuda_ms(lambda: orig["recon_chunks"](*a), reps),
        plain_ms=cuda_ms(lambda: recon_chunks_plain(*a), reps),
        library_ms=None, bound=b3,
        note=f"1 launch over {len(chunks)} u8 chunks of "
             f"{tuple(chunks[0].shape)} (the Y800 AVI); device {dms:.4f} ms, "
             f"{100 * b3[0] / dms:.1f}% of bound; launches: the session's u8 "
             f"scans (AVI and 8-bit SER)"))
    del chunks, a, out

    # a group of small same-shape scans and a straggler
    small = os.path.join(tmp, "small")
    os.makedirs(small)
    kw = dict(ih=1024, iw=150, depth=16, line_poly=(75.0, 0.005, 0.0, 0.0),
              squash_y=SQUASH, noise=0.002)
    t0 = time.perf_counter()
    for i in range(4):
        SyntheticScan(frames=200, seed=20 + i, **kw).write(
            os.path.join(small, f"g{i}.ser"), transpose_to_wide=True)
    SyntheticScan(frames=180, seed=30, **kw).write(
        os.path.join(small, "x.ser"), transpose_to_wide=True)
    members = [os.path.join(small, f"g{i}.ser") for i in range(4)]
    straggler = os.path.join(small, "x.ser")
    sizes = sorted(os.path.getsize(f) / 1e6 for f in members)
    print(f"small-scan group: 4 scans of 200 x 1024 x 150 u16 "
          f"({sizes[0]:.1f} MB each) and one of 180 frames, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    per_file = []

    def read_scan_small(file, *a, **k):
        per_file.append(file)
        return orig["read_scan"](file, *a, **k)

    out_g = os.path.join(tmp, "small_out")
    try:
        cli_main.read_scan = read_scan_small
        zero_counts()
        t0 = time.perf_counter()
        quiet_main(["-c", "--input-dir", small, "--output-dir", out_g])
        torch.cuda.synchronize()
        wall_g = time.perf_counter() - t0
        launches_g = dict(cuda_build.LAUNCHES)
    finally:
        cli_main.read_scan = orig["read_scan"]
    if per_file != members + [straggler] or launches_g["recon"] != 5:
        fail(f"small-scan session: read per file {per_file}, B3 launches "
             f"{launches_g['recon']}")
    out_a = os.path.join(tmp, "small_alone")
    t0 = time.perf_counter()
    for f in members + [straggler]:
        quiet_main(["-c", f, "--output-dir", out_a])
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    got_g = pngs(out_g)
    if got_g != pngs(out_a) or len(got_g) != 5:
        fail("small-scan session: the session's _clahe.png differ from the "
             "files run alone")
    print(f"small-scan session: 5 scans through read_scan (B3 "
          f"{launches_g['recon']}) in {wall_g:.3f} s, one main call per file "
          f"{wall_a:.3f} s; every _clahe.png equal to its file run alone "
          f"[{card}]", flush=True)

    # the group read of pipeline/batch.py, called directly (the driver
    # does not call it), against the session's overlapped read of the four
    def quiet(fn, *a):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*a)

    def opts_in(d):
        os.makedirs(d, exist_ok=True)
        return Options(shift=[0], clahe_only=True, output_dir=d)

    out_m = os.path.join(tmp, "small_members")
    t0 = time.perf_counter()
    quiet(cli_main.handle_files, members, opts_in(out_m), dev)
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    out_b = os.path.join(tmp, "small_batched")
    opts_b = opts_in(out_b)
    zero_counts()
    t0 = time.perf_counter()
    tasks_b = [(f, opts_b.copy()) for f in members + [straggler]]
    got_b = quiet(read_scans_batched, tasks_b, {}, dev)
    for f, o in tasks_b:
        if f in got_b:
            quiet(process_scan, got_b[f], o)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = cuda_build.LAUNCHES["recon"]
    if sorted(got_b) != members or launches_b != 4:
        fail(f"read_scans_batched took {sorted(got_b)}, B3 launches "
             f"{launches_b}")
    if pngs(out_b) != {k: v for k, v in got_g.items()
                       if not k.startswith("x_")}:
        fail("read_scans_batched: the members' _clahe.png differ from the "
             "session's")
    print(f"read_scans_batched (called directly): the 4 same-shape scans "
          f"(B3 once each: {launches_b}), the straggler left out; read and "
          f"post-processed in {wall_b:.3f} s against {wall_m:.3f} s for the "
          f"session's overlapped per-file read of the same 4; every "
          f"_clahe.png equal [{card}]", flush=True)

    # --num-processes 2: disjoint shares that cover the folder
    shares = []
    for pid in (0, 1):
        out_p = os.path.join(tmp, f"share{pid}")
        quiet_main(["-c", "--input-dir", small, "--num-processes", "2",
                    "--process-id", str(pid), "--output-dir", out_p])
        shares.append(set(pngs(out_p)))
    every = {f[:-4] + "_shift=0_clahe.png" for f in os.listdir(small)}
    mine = [assign_files(sorted(members + [straggler]), 2, p) for p in (0, 1)]
    if shares[0] & shares[1] or shares[0] | shares[1] != every:
        fail(f"--num-processes 2: shares {shares}")
    print(f"--num-processes 2: process 0 wrote {sorted(shares[0])}, process "
          f"1 {sorted(shares[1])}: disjoint, every file once "
          f"({[len(m) for m in mine]} by assign_files)", flush=True)

    # --profile on one -c run of the bench scan
    prof = os.path.join(tmp, "profile")
    said = quiet_main([f"--profile={prof}", "-c", path, "--output-dir",
                       os.path.join(tmp, "profile_out")])
    traces = os.listdir(prof)
    if len(traces) != 1:
        fail(f"--profile wrote {traces}")
    with open(os.path.join(prof, traces[0])) as f:
        text = f.read()
    names = [k for k in ("recon_chunks_kernel", "sum_max_kernel",
                         "hist_kernel", "hresample_kernel") if k in text]
    if not names or "profiler trace written to" not in said:
        fail(f"--profile: the trace {traces[0]} names none of the port's "
             "kernels")
    print(f"--profile: {traces[0]} ({len(text) / 1e6:.1f} MB) names "
          f"{names}", flush=True)
    return records


def small_ops_diff(disk, dev, card) -> None:
    """The ellipse fit's small ops (geometry/edges.py) on the card and on
    the CPU, stage by stage, for one disk (the fit shift's): the blurs, the
    flood threshold, Canny's intermediates, the edge points and the
    ellipses (information: the band and host feeds run them on the CPU)."""
    import torch

    from solex_ser_recon_en_torch.geometry import edges
    from solex_ser_recon_en_torch.geometry.correct import downscale_mean
    from solex_ser_recon_en_torch.geometry.ellipse import two_step
    from solex_ser_recon_en_torch.ops import canny as canny_mod

    cpu = torch.device("cpu")
    small = downscale_mean(disk, 4)
    out = {}
    for role, d in (("card", dev), ("cpu", cpu)):
        o = out[role] = {}
        o["blur5"] = edges._blur(small, 5, 5, d)
        o["thresh"], o["blurred"] = edges.flood_threshold(small, d)
        o["flooded"] = edges.get_flood_image(small, d)
        f = torch.from_numpy(out["card"]["flooded"]).to(d)
        k = canny_mod._gaussian_kernel_1d(2.0)
        sm = canny_mod._conv1d(canny_mod._conv1d(f, k, 0), k, 1)
        gy, gx = canny_mod._sobel(sm)
        o["sm"], o["mag"] = sm.cpu().numpy(), torch.hypot(gy, gx).cpu().numpy()
        o["ang"] = torch.atan2(gy, gx).cpu().numpy()
        X, raw = edges.get_edge_list(small, d)
        o["X"], o["raw"] = X, raw
        c, h, phi, ratio, _, _ = two_step(X * 4)
        o["ellipse"] = (tuple(float(v) for v in c), float(h), float(phi),
                        float(ratio))
    a, b = out["card"], out["cpu"]

    def pts(x):
        return {tuple(p) for p in x.astype(int)}

    print(f"small ops, card vs CPU, on the fit disk's {small.shape} "
          f"downscale: 5x5 blur max diff "
          f"{float(np.abs(a['blur5'] - b['blur5']).max())}, flood blur max "
          f"diff {float(np.abs(a['blurred'] - b['blurred']).max())}, "
          f"threshold {a['thresh']!r} vs {b['thresh']!r}, flooded pixels "
          f"differing {int((a['flooded'] != b['flooded']).sum())}; on the "
          f"card's flooded image: Gaussian max diff "
          f"{float(np.abs(a['sm'] - b['sm']).max())}, gradient magnitude "
          f"max diff {float(np.abs(a['mag'] - b['mag']).max())} "
          f"({int((a['mag'] != b['mag']).sum())} px), angle max diff "
          f"{float(np.abs(a['ang'] - b['ang']).max())} "
          f"({int((a['ang'] != b['ang']).sum())} px); raw edge points "
          f"{len(a['raw'])} vs {len(b['raw'])} ({len(pts(a['raw']) ^ pts(b['raw']))}"
          f" differ), kept {len(a['X'])} vs {len(b['X'])} "
          f"({len(pts(a['X']) ^ pts(b['X']))} differ); ellipse (center, "
          f"height, phi, ratio) {a['ellipse']} vs {b['ellipse']} [{card}]",
          flush=True)


def feeds_phase(path, tmp, png4, card, dev, res, wall2):
    """Phase 10: the band and host feeds on the phase-3 scan (module
    docstring); returns (the records of B3 on the band chunks, the host
    library's records of the newly driven entry points)."""
    import torch

    from solex_ser_recon_en_torch.cli import main as cli_main
    from solex_ser_recon_en_torch.geometry import correct
    from solex_ser_recon_en_torch.io import feeder, native, pagecache
    from solex_ser_recon_en_torch.io import hostreduce as hr
    from solex_ser_recon_en_torch.io.png import read_png
    from solex_ser_recon_en_torch.io.ser import SerReader
    from solex_ser_recon_en_torch.ops import cuda_build, fused
    from solex_ser_recon_en_torch.ops.dtypes import as_int16, widen
    from solex_ser_recon_en_torch.ops.recon import recon_chunks_plain
    from solex_ser_recon_en_torch.ops.warp import (
        warp_host_u16,
        warp_host_u16_plain,
    )
    from solex_ser_recon_en_torch.pipeline import products
    from solex_ser_recon_en_torch.pipeline import run as run_mod
    from solex_ser_recon_en_torch.pipeline import transversalium

    scan4 = res["scan"]
    rate = feeder.cached_probe_rate()
    print(f"feeds: phase 4's auto run took the {scan4.feed} feed; the "
          f"probed link rate {rate / 1e9:.3f} GB/s [{card}]", flush=True)
    if scan4.feed != "device":
        fail(f"phase 4's auto run took the {scan4.feed} feed, not device")

    def zero_counts():
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0
        for k in native.CALLS:
            native.CALLS[k] = 0

    got = {"capture": False, "band": [], "host": {}}
    names = ("read_scan", "host_mean_max", "host_mean_max_band",
             "transversalium_gain", "image_process")
    mods = {"read_scan": cli_main, "recon_chunks": fused}
    mods.update({n: run_mod for n in names[1:]})
    orig = {n: getattr(m, n) for n, m in mods.items()}

    def read_scan(file, opts, device, timer=None):
        got["timer"], got["opts"] = timer, opts
        got["scan"] = orig["read_scan"](file, opts, device, timer)
        return got["scan"]

    def host_mean_max(r):
        got["mean_max"] = orig["host_mean_max"](r)
        return got["mean_max"]

    def host_mean_max_band(r, x0, x1):
        out = orig["host_mean_max_band"](r, x0, x1)
        got["mean_max"] = out[:2]
        return out

    def recon_chunks(chunks, ind_l, left_w, rotate, upscale, out=None,
                     frame_offset=0):
        if got["capture"]:
            got["band"].append((list(chunks), ind_l, left_w, rotate,
                                upscale))
        return orig["recon_chunks"](chunks, ind_l, left_w, rotate, upscale,
                                    out, frame_offset)

    def transversalium_gain(img, circle, borders, strength):
        if got["capture"]:
            got["host"]["rows"] = (img.clone(), circle, borders)
        return orig["transversalium_gain"](img, circle, borders, strength)

    def image_process(frame, *a, **k):
        if got["capture"]:
            got["host"]["core"] = (frame.clone(), k.get("gain"))
        return orig["image_process"](frame, *a, **k)

    hooks = dict(read_scan=read_scan, host_mean_max=host_mean_max,
                 host_mean_max_band=host_mean_max_band,
                 recon_chunks=recon_chunks,
                 transversalium_gain=transversalium_gain,
                 image_process=image_process)
    runs = {}
    for n, m in mods.items():
        setattr(m, n, hooks[n])
    try:
        for feed in ("device", "band", "host"):
            out = os.path.join(tmp, f"feed_{feed}")
            for k in (1, 2):
                got["capture"] = k == 1 and feed in ("band", "host")
                got.pop("mean_max", None)
                zero_counts()
                t0 = time.perf_counter()
                rc = cli_main.main(["-cw0", path, "--feed", feed,
                                    "--output-dir", out])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if rc != 0:
                    fail(f"-cw0 --feed {feed} (run {k}) failed")
                timer = got["timer"]
                runs[feed, k] = dict(
                    wall=wall, launches=dict(cuda_build.LAUNCHES),
                    calls={n: c for n, c in native.CALLS.items() if c},
                    times=dict(timer.times), notes=dict(timer.notes),
                    scan=got["scan"], opts=got["opts"],
                    mean_max=got.get("mean_max"))
            with open(os.path.join(out, "scan_log.txt")) as f:
                runs[feed, 2]["log"] = [
                    line for line in f.read().splitlines()
                    if line.startswith(("Feed :", "Page-cache pin :",
                                        "Pass A :", "Pass B :",
                                        "Fast pass A not taken",
                                        "Band slab does not cover"))]
        got["capture"] = False
        # the 7-shift host sweep: the shifts' warps in one batched call
        zero_counts()
        out_sweep = os.path.join(tmp, "feed_host_sweep")
        t0 = time.perf_counter()
        rc = cli_main.main(["-cw-9:9:3", path, "--feed", "host",
                            "--output-dir", out_sweep])
        wall_sweep = time.perf_counter() - t0
        sweep = dict(launches=dict(cuda_build.LAUNCHES),
                     calls={n: c for n, c in native.CALLS.items() if c},
                     times=dict(got["timer"].times))
    finally:
        for n, m in mods.items():
            setattr(m, n, orig[n])
        pagecache.clear()
    if rc != 0:
        fail("-cw-9:9:3 --feed host failed")

    def png_of(feed):
        return os.path.join(tmp, f"feed_{feed}", "scan_shift=0_clahe.png")

    with open(png4, "rb") as f:
        png4_bytes = f.read()
    cc4 = read_png(png4)
    for feed in ("device", "band", "host"):
        r2 = runs[feed, 2]
        stages = ", ".join(f"{n} {1e3 * v:.1f}" for n, v in
                           r2["times"].items())
        print(f"feeds: --feed {feed} run 1 {runs[feed, 1]['wall']:.3f} s, run "
              f"2 {r2['wall']:.3f} s (phase 4's device run 2 {wall2:.3f} s); "
              f"run 2 stages (ms): {stages}; {r2['notes']}; launches "
              f"{ {k: v for k, v in r2['launches'].items() if v} }; host "
              f"library calls {r2['calls']}; log {r2['log']} [{card}]",
              flush=True)
        if r2["scan"].feed != feed:
            fail(f"--feed {feed} took the {r2['scan'].feed} feed")
        if not np.array_equal(r2["scan"].linefit.poly, scan4.linefit.poly):
            fail(f"--feed {feed}: the line fit differs from phase 4's")
        cc = read_png(png_of(feed))
        with open(png_of(feed), "rb") as f:
            same = f.read() == png4_bytes
        mx = int(np.abs(cc.astype(np.int64) - cc4.astype(np.int64)).max()) \
            if cc.shape == cc4.shape else None
        o, o4 = r2["opts"], res["opts"]
        print(f"feeds: --feed {feed} _clahe.png {'equals' if same else 'differs from'}"
              f" phase 4's (max {mx} LSB, shape {cc.shape} vs {cc4.shape}); "
              f"Y/X {o.ratio_fixe!r} vs {o4.ratio_fixe!r}, tilt "
              f"{o.slant_fix!r} vs {o4.slant_fix!r}", flush=True)

    # band: host pass A, B3 on the band, the post on the card
    b2 = runs["band", 2]
    la = b2["launches"]
    if la["sum_max"] != 0 or la["recon"] < 1 or la["hresample"] != 1 \
            or la["tile_hist"] != 2:
        fail(f"--feed band launched {la}: want pass A 0, B3 >= 1, B4 1, B5 2")
    if "sweep" not in b2["notes"]["pass A"]:
        fail(f"--feed band ran pass A as {b2['notes']['pass A']}")
    mean_b, max_b = b2["mean_max"]
    if not (np.array_equal(mean_b, scan4.mean_img)
            and np.array_equal(max_b, res["max_img"])):
        fail("--feed band: mean or max differs from phase 4's")
    if not torch.equal(as_int16(b2["scan"].disk_list),
                       as_int16(scan4.disk_list)):
        fail("--feed band: the disks differ from phase 4's B3 disks")
    print("feeds: --feed band mean, max, line fit and disks equal phase 4's",
          flush=True)

    # host: fast pass A, the float64 recon, the post on the host, no launch
    h2 = runs["host", 2]
    la = h2["launches"]
    if any(la[k] for k in ("sum_max", "recon", "hresample", "tile_hist")):
        fail(f"--feed host launched {la}: want none of pass A, B3, B4, B5")
    if not h2["notes"]["pass A"].startswith("fast_passa"):
        fail(f"--feed host ran pass A as {h2['notes']['pass A']}")
    for name in ("ser_sample_stats", "ser_band_stats", "ser_recon_f64",
                 "warp_u16_u16", "clahe_u16", "gain_hist_u16", "lut_u16",
                 "row_medstats_sorted_f32", "mask_interval_f32"):
        if not h2["calls"].get(name):
            fail(f"--feed host did not call {name}")
    dh = h2["scan"].disk_list
    if dh.device.type != "cpu":
        fail("--feed host: the disks are not host tensors")
    d = (widen(dh) - widen(scan4.disk_list).cpu()).abs()
    frac = (d > 0).double().mean().item()
    print(f"feeds: --feed host disks against phase 4's B3 disks: max "
          f"{d.max().item()} LSB on {100 * frac:.4f}% of pixels", flush=True)
    if d.max().item() > 1 or frac >= 0.02:
        fail("--feed host: disks beyond 1 LSB on 2% of pixels of phase 4's")
    ls = sweep["launches"]
    print(f"feeds: -cw-9:9:3 --feed host {wall_sweep:.3f} s, stages "
          f"{ {n: round(1e3 * v, 1) for n, v in sweep['times'].items()} } ms, "
          f"host library calls {sweep['calls']} [{card}]", flush=True)
    if any(ls[k] for k in ("sum_max", "recon", "hresample", "tile_hist")):
        fail(f"the host sweep launched {ls}")
    if sweep["calls"].get("warp_u16_u16_batch") != 1:
        fail("the host sweep did not warp its 7 shifts in one "
             "warp_u16_u16_batch call")
    with open(png_of("host"), "rb") as f, open(os.path.join(
            out_sweep, "scan_shift=0_clahe.png"), "rb") as g:
        if f.read() != g.read():
            fail("the host sweep's shift 0 differs from --feed host -cw0")

    small_ops_diff(scan4.disk_list[0], dev, card)

    # kernel B3 on the band run's chunks against its plain version
    reps = 20
    rc_args = got["band"]

    def max_abs_err(x, y):
        return (widen(x) - widen(y)).abs().max().item()

    err = max(max_abs_err(orig["recon_chunks"](*a), recon_chunks_plain(*a))
              for a in rc_args)
    ms = cuda_ms(lambda: [orig["recon_chunks"](*a) for a in rc_args], reps)
    dms = device_ms(lambda: [orig["recon_chunks"](*a) for a in rc_args],
                    reps)
    pms = cuda_ms(lambda: [recon_chunks_plain(*a) for a in rc_args], reps)
    nbytes, flops = 0, 0
    for chunks, ind_l, left_w, rotate, _ in rc_args:
        raw = chunks[0]
        n = sum(c.shape[0] for c in chunks)
        S, ih = ind_l.shape
        bw = raw.shape[1] if rotate else raw.shape[2]
        nbytes += (tap_columns(ind_l, bw) * n * raw.element_size()
                   + S * ih * n * 2 + ind_l.nbytes + left_w.nbytes)
        flops += 3 * S * ih * n
    b3 = bound(nbytes, {"f32": flops})
    records = [dict(
        name="recon_band", kernel="recon", launches=b2["launches"]["recon"],
        err=err, ms=ms, plain_ms=pms, library_ms=None, bound=b3,
        note=f"{len(rc_args)} launch over {len(rc_args[0][0])} band chunks "
             f"of {tuple(rc_args[0][0][0].shape)}; device {dms:.4f} ms, "
             f"{100 * b3[0] / dms:.1f}% of bound")]
    del rc_args, got["band"]

    # the host library's newly driven entry points, on the host run's
    # inputs, against their numpy twins (host clock, medians)
    rate = MEASURED["copy_gbps"] * 1e6          # bytes per millisecond
    r = SerReader(path)
    lf = scan4.linefit
    shifts = scan4.shifts
    hrec = []

    def once(fn):
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out

    def row(name, replaces, calls, fn, twin, nbytes, note, reps=3,
            same=None):
        ms = host_ms(fn, reps)
        pms, want = once(twin)
        out = fn()
        eq = same(out, want) if same else all(
            np.array_equal(a, b) for a, b in zip(out, want))
        hrec.append(dict(name=name, replaces=replaces, calls=calls,
                         max_abs_err=0 if eq else 1, ms=ms, plain_ms=pms,
                         bound_ms=nbytes / rate, note=note))

    def twin(fn, *a):
        def run():
            hr.NATIVE = False
            try:
                return fn(*a)
            finally:
                hr.NATIVE = True
        return run

    scan_bytes = r.frame_count * r.header.frame_bytes
    h1 = runs["host", 2]["calls"]
    b1 = runs["band", 2]["calls"]
    row("ser_mean_max", "numpy sum and max of each 256-frame memmap slice "
        "(io/hostreduce.py with NATIVE False)", b1.get("ser_mean_max", 0),
        lambda: hr.host_mean_max(r), twin(hr.host_mean_max, r), scan_bytes,
        "the full host sweep of the scan (the band feed's pass A)", reps=2)
    step = max(1, r.frame_count // 64)
    x0, x1 = hr.spectral_band(lf.floor, shifts, r.iw, margin=18)
    rect = hr._band_rect(r, x0, x1)

    def numpy_fast():
        raw = r.raw_frames()
        sub = raw[::step]
        band = raw[:, rect[0]:rect[1], rect[2]:rect[3]]
        return (sub.sum(axis=0, dtype=np.uint64), sub.max(axis=0),
                band.sum(axis=0, dtype=np.uint64), band.max(axis=0))

    def native_fast():
        with native.NativeSerReader(path) as nr:
            s, m, _ = nr.sample_stats(step)
            return (s, m) + nr.band_stats(*rect)

    band_bytes = r.frame_count * (rect[1] - rect[0]) * (rect[3] - rect[2]) * 2
    row("ser_sample_stats + ser_band_stats", "numpy sums and maxima of the "
        "frame subsample and of the band", h1.get("ser_band_stats", 0),
        native_fast, numpy_fast, band_bytes + scan_bytes // step,
        f"fast pass A's two sweeps: every {step}th frame, then the band "
        f"[{x0}, {x1}) of every frame ({band_bytes / 1e9:.3f} GB)", reps=2)
    row("ser_mean_max_band", "numpy sums, maxima and band copy of each "
        "memmap slice", b1.get("ser_mean_max_band", 0),
        lambda: hr.host_mean_max_band(r, x0, x1),
        twin(hr.host_mean_max_band, r, x0, x1), scan_bytes + band_bytes,
        "the fused band sweep (the band and host feeds when the scan is "
        "not pinned)", reps=1)
    nd = len(shifts) * r.ih * r.frame_count
    row("ser_recon_f64", "numpy np.take pair and float64 lerp a chunk "
        "(io/hostreduce.py with NATIVE False)", h1.get("ser_recon_f64", 0),
        lambda: (hr.host_reconstruct(r, lf.floor, lf.frac, shifts),),
        lambda: (twin(hr.host_reconstruct, r, lf.floor, lf.frac, shifts)(),),
        nd * 2 * 2 + nd * 2,
        f"the host feed's pass B, S = {len(shifts)}: two taps a disk pixel "
        "from the page cache", reps=2)
    o = runs["host", 2]["opts"]
    disk = dh[1].numpy()
    _, _, mat3, _, _, oh, ow = correct._correction_mat3(
        disk.shape, math.radians(o.slant_fix), o.ratio_fixe)
    cval = float(disk[0, 0]) / 65536.0
    row("warp_u16_u16", "the numpy float32 four-term warp "
        "(ops/warp.py:warp_host_u16_plain)", h1.get("warp_u16_u16", 0),
        lambda: (warp_host_u16(disk, mat3, oh, ow, cval),),
        lambda: (warp_host_u16_plain(disk, mat3, oh, ow, cval),),
        disk.nbytes + oh * ow * 2, f"{disk.shape} -> ({oh}, {ow})")
    stack = [disk] * 7
    row("warp_u16_u16_batch", "7 calls of warp_u16_u16 (one a shift)",
        sweep["calls"].get("warp_u16_u16_batch", 0),
        lambda: (native.warp_u16_batch(stack, mat3, oh, ow, [cval] * 7,
                                       None),),
        lambda: (np.stack([warp_host_u16(s, mat3, oh, ow, cval)
                           for s in stack]),),
        7 * (disk.nbytes + oh * ow * 2), "the 7 shifts of the host sweep")
    img, circle, borders = got["host"]["rows"]
    img = img.numpy()
    h, w = img.shape

    def rows_twin():
        y1b, y2b = transversalium._row_band(circle, borders)
        a, b = max(y1b, 0), min(y2b, h)
        valid = transversalium._strip_mask_host(h, w, circle, borders, a, b)
        mean_r = np.zeros(h)
        mean_r[a + 1:b] = transversalium._row_stats_host(img[a:b],
                                                         valid)[1:]
        return (mean_r,)

    row("row_medstats_sorted_f32 + mask_interval_f32", "numpy masked row "
        "sorts (pipeline/transversalium.py:_row_stats_host)",
        h1.get("row_medstats_sorted_f32", 0),
        lambda: (transversalium._mean_r_host(img, circle, borders),),
        rows_twin, img.nbytes * 3, f"the corrected disk {img.shape}'s "
        "correction band")
    frame, gain = got["host"]["core"]
    f16 = frame.numpy()
    want = (False, False)

    def core_plain():
        g = torch.as_tensor(np.asarray(gain), dtype=torch.float32)
        out = products._products_core_gained(frame, g, want)
        return tuple(t.numpy() for t in out[:2])

    def core_host():
        return products._products_core_gained_host(f16, gain, want)[:2]

    def within_cv2(a, b):
        """The row-gained image equal, CLAHE within 1 LSB (ROADMAP C3:
        float32 ties in the LUT blend round either way)."""
        return np.array_equal(a[0], b[0]) and int(np.abs(
            a[1].astype(np.int64) - b[1]).max()) <= 1

    row("gain_hist_u16 + clahe_u16 + lut_u16", "the port's plain torch "
        "product core on the CPU (pipeline/products.py:_products_core_gained)",
        h1.get("clahe_u16", 0), core_host, core_plain, f16.nbytes * 5,
        f"the -c product core of {f16.shape}: row gain and CLAHE with its "
        "histogram (the gained image equal, CLAHE within 1 LSB)",
        same=within_cv2)
    lut = np.arange(65536, dtype=np.uint16)[::-1].copy()
    row("hist_u16", "np.bincount", h1.get("hist_u16", 0),
        lambda: (native.hist_u16(f16),),
        lambda: (np.bincount(f16.ravel(), minlength=65536),), f16.nbytes,
        f"{f16.shape}")
    row("lut_u16", "a numpy gather lut[img]", h1.get("lut_u16", 0),
        lambda: (native.lut_u16(f16, lut),), lambda: (lut[f16],),
        2 * f16.nbytes, f"{f16.shape}")
    for rr in hrec:
        print(f"host {rr['name']}: {rr['ms']:.3f} ms, numpy/plain "
              f"{rr['plain_ms']:.3f} ms, bound {rr['bound_ms']:.3f} ms at "
              f"{MEASURED['copy_gbps']:.2f} GB/s, {rr['calls']} calls in "
              f"the run, max_abs_err {rr['max_abs_err']} ({rr['note']}; "
              f"before: {rr['replaces']}) [{card}]", flush=True)
        if rr["max_abs_err"] != 0:
            fail(f"host entry point {rr['name']} differs from its twin")
    return records, hrec


def analyser_phase(path, tmp, png4, card, dev, res) -> list:
    """Phase 11: the other entry points on the card, the spectral analyser,
    the CLAHE tool and ``python -m`` (module docstring); returns the
    records of B3 on the analyser's normalised slab and of B5 on the
    tool's 8-bit images."""
    import contextlib
    import io

    import torch

    from solex_ser_recon_en_torch import analyser
    from solex_ser_recon_en_torch.analyser.atlas import load_atlas
    from solex_ser_recon_en_torch.cli import analyse, clahe_tool
    from solex_ser_recon_en_torch.cli import main as cli_main
    from solex_ser_recon_en_torch.io.png import read_png, write_png_streaming
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
    from solex_ser_recon_en_torch.ops import cuda_build
    from solex_ser_recon_en_torch.ops.clahe import (
        image_tile_histograms,
        image_tile_histograms_plain,
        tile_keys,
    )
    from solex_ser_recon_en_torch.ops.dtypes import as_int16, widen
    from solex_ser_recon_en_torch.ops.recon import (
        build_shift_indices,
        recon_chunks_plain,
    )
    from solex_ser_recon_en_torch.ops.recon_cuda import recon_chunks

    t_phase = time.perf_counter()
    reps = 20
    sr = res["scan"]
    disk4 = sr.disk_list[sr.shifts.index(0)]

    def zero_counts():
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0

    def expect(launches, want, what):
        got = {k: launches[k] for k in want}
        if got != want:
            fail(f"{what}: launches {launches}, not {want}")

    def max_abs_err(x, y):
        return (widen(x) - widen(y)).abs().max().item()

    # (a) shg-torch-analyse on the bench scan, then the analyser directly
    made = []

    class Counted(analyser.SpectralAnalyser):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    base = os.path.join(tmp, "analyse")
    goto = 6562.808 - 0.25
    analyse.SpectralAnalyser = Counted
    try:
        zero_counts()
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = analyse.main([path, "--dispersion", "0.05", "--goto",
                               str(goto), "--save", base])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        analyse.SpectralAnalyser = analyser.SpectralAnalyser
    launches = dict(cuda_build.LAUNCHES)
    said = text.getvalue()
    if rc != 0 or len(made) != 1:
        print(said[-2000:], flush=True)
        fail(f"shg-torch-analyse returned {rc}")
    an = made.pop()
    print(f"analyser CLI: {wall:.3f} s, --goto {goto} -> "
          f"{[ln for ln in said.splitlines() if 'GOTO' in ln]}; uploads "
          f"{an.transfer_count}; launches {launches} [{card}]", flush=True)
    if an.transfer_count != 1:
        fail(f"the analyser CLI uploaded the slab {an.transfer_count} times")
    expect(launches, {"sum_max": 1, "recon": 2, "hresample": 1,
                      "tile_hist": 2}, "the analyser CLI")
    if not all(os.path.exists(base + s) for s in ("_clahe.png",
                                                  "_protus.png")):
        fail("the analyser CLI wrote no products")
    del an

    zero_counts()
    t0 = time.perf_counter()
    an = analyser.SpectralAnalyser(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    print(f"analyser load: {load_s:.3f} s, mode {an._recon_mode}, uploads "
          f"{an.transfer_count}; stages (ms) "
          + json.dumps({k: round(1e3 * v, 1) for k, v in
                        an.timer.times.items()}) + f"; launches {launches} "
          f"[{card}]", flush=True)
    if an.transfer_count != 1 or an._recon_mode != "device":
        fail(f"the analyser's load: mode {an._recon_mode}, "
             f"{an.transfer_count} uploads")
    expect(launches, {"sum_max": 1, "recon": 1, "hresample": 0,
                      "tile_hist": 0}, "the analyser's load")
    if not (np.array_equal(an.mean_img, sr.mean_img)
            and np.array_equal(an.max_img, res["max_img"])):
        fail("the analyser's mean or max differs from phase 4's")
    disk = an._recon_at(0)
    if not torch.equal(as_int16(disk), as_int16(disk4)):
        fail("the analyser's shift-0 disk differs from phase 4's B3 disk")
    zero_counts()
    t0 = time.perf_counter()
    an.save(0, base + "0")
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    expect(dict(cuda_build.LAUNCHES), {"recon": 1, "hresample": 1,
                                       "tile_hist": 2}, "the analyser's save")
    mine, theirs = read_png(base + "0_clahe.png"), read_png(png4)
    if mine.shape != theirs.shape:
        fail(f"save(0): _clahe.png {mine.shape}, phase 4's {theirs.shape}")
    d = np.abs(mine.astype(np.int64) - theirs.astype(np.int64))
    print(f"analyser: mean, max and the shift-0 disk equal phase 4's bit for "
          f"bit; save(0) {save_s:.3f} s, its _clahe.png against phase 4's: "
          f"max {d.max()} LSB on {100 * (d > 0).mean():.4f}% of pixels "
          f"(bound 15 LSB, ROADMAP C4) [{card}]", flush=True)
    if d.max() > 15:
        fail(f"save(0)'s _clahe.png is {d.max()} LSB from phase 4's")

    # (d) B3 on the normalised slab, as the analyser launched it
    lf = an.linefit
    ind_l, left_w = build_shift_indices(lf.floor, lf.frac, [0], an.iw)
    a = ([an._device_frames()], torch.from_numpy(ind_l).to(dev),
         torch.from_numpy(left_w).to(dev), False, False)
    err = max_abs_err(recon_chunks(*a), recon_chunks_plain(*a))
    ms = cuda_ms(lambda: recon_chunks(*a), reps)
    dms = device_ms(lambda: recon_chunks(*a), reps)
    pms = cuda_ms(lambda: recon_chunks_plain(*a), reps)
    F = a[0][0].shape[0]
    b3 = bound(tap_columns(a[1], an.iw) * F * 2 + an.ih * F * 2
               + a[1].nbytes + a[2].nbytes, {"f32": 3 * an.ih * F})
    records = [dict(
        name="recon_normalised", kernel="recon", launches=2, err=err, ms=ms,
        plain_ms=pms, library_ms=None, bound=b3,
        note=f"1 launch over the normalised slab {tuple(a[0][0].shape)} as "
             f"one chunk, rotate=False, S=1; device {dms:.4f} ms, "
             f"{100 * b3[0] / dms:.1f}% of bound; launches: the analyser "
             f"CLI's (its fit and one saved shift)")]
    del a, an, disk
    torch.cuda.empty_cache()

    # (b) auto-dispersion on atlas-rendered scans
    atlas = load_atlas()
    w, inten = atlas.wavelengths, atlas.intensity
    for true_disp in (0.043, 0.085):
        p = os.path.join(tmp, f"atlas_{int(true_disp * 1000)}.ser")
        SyntheticScan(ih=360, iw=IW, frames=220, depth=16,
                      line_poly=(150.0, 0.0, 0.0, 0.0), disk_radius=100.0,
                      noise=0.002, seed=4,
                      spectrum_fn=lambda dpx, d=true_disp: np.interp(
                          dpx * d + 6562.808, w, inten)).write(p)
        t0 = time.perf_counter()
        an = analyser.SpectralAnalyser(p, atlas=atlas, device=dev)
        got = an.find_dispersion(6562.808)
        rel = abs(got - true_disp) / true_disp
        print(f"auto-dispersion: true {true_disp} A/px, found {got} "
              f"({100 * rel:.3f}%), iw {IW}, {time.perf_counter() - t0:.3f} s "
              f"with the load [{card}]", flush=True)
        if rel >= 0.01:
            fail(f"auto-dispersion found {got} for {true_disp} A/px")
        del an

    # (c) shg-torch-clahe on phase 4's _clahe.png and its 8-bit copy
    work = os.path.join(tmp, "clahe_tool")
    os.makedirs(work)
    u16 = os.path.join(work, "u16.png")
    u8 = os.path.join(work, "u8.png")
    img16 = read_png(png4)
    write_png_streaming(u16, img16)
    write_png_streaming(u8, (img16 >> 8).astype(np.uint8))
    here = os.getcwd()
    os.chdir(work)
    walls, worst = [], {}
    try:
        for tile in (1, 2, 3, 4):
            for stretch in (False, True):
                argv = [u16, u8, "--tile", str(tile)] + (
                    ["--stretch", "--lo", "5", "--hi", "99"] if stretch
                    else [])
                # the tool keeps --stretch in its config: start afresh
                if os.path.exists(clahe_tool.CONFIG_NAME):
                    os.remove(clahe_tool.CONFIG_NAME)
                zero_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = clahe_tool.main(argv)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                n = cuda_build.LAUNCHES["tile_hist"]
                if rc != 0 or n != 2:
                    fail(f"shg-torch-clahe {argv[2:]}: rc {rc}, B5 {n}")
                opts = clahe_tool.read_ini()
                for src in (u16, u8):
                    card_out = read_png(src[:-4] + "_clahe.png")
                    cpu_out = clahe_tool.apply_clahe(src, opts, False, "cpu")
                    d = np.abs(card_out.astype(np.int64)
                               - cpu_out.astype(np.int64))
                    key = (os.path.basename(src), stretch)
                    m, frac = int(d.max()), float((d > 0).mean())
                    if stretch:
                        x = read_png(src)
                        top = 65535 if x.dtype == np.uint16 else 255
                        slope = top * 0.8 / (np.percentile(x, 99)
                                             - np.percentile(x, 5))
                        ok = m <= slope + 1
                    else:
                        ok = m <= 1 and frac < 0.001
                    worst[key] = max(worst.get(key, (0, 0.0)), (m, frac))
                    if not ok:
                        fail(f"shg-torch-clahe {key} tile {tile}: card vs "
                             f"cpu {m} LSB on {100 * frac:.4f}%")
    finally:
        os.chdir(here)
    print(f"CLAHE tool: 8 runs of 2 images ({img16.shape[0]} x "
          f"{img16.shape[1]} u16 and its u8 copy), "
          f"tiles 1-4, with and without --stretch: B5 2 launches a run; wall "
          f"a run {min(walls):.3f}-{max(walls):.3f} s; card vs --device cpu "
          f"(max LSB, share): " + "; ".join(
              f"{k[0]}{' stretch' if k[1] else ''} {v[0]} on "
              f"{100 * v[1]:.4f}%" for k, v in sorted(worst.items()))
          + f" [{card}]", flush=True)

    # (d) B5 on the tool's 8-bit image, the four grids the tool ran
    img8 = torch.from_numpy((img16 >> 8).astype(np.uint8)).to(dev)
    grids = [(img8, g, g, 256) for g in (1, 2, 3, 4)]
    err = max(max_abs_err(image_tile_histograms(*g),
                          image_tile_histograms_plain(*g)) for g in grids)
    ms = cuda_ms(lambda: [image_tile_histograms(*g) for g in grids], reps)
    dms = device_ms(lambda: [image_tile_histograms(*g) for g in grids], reps)
    pms = cuda_ms(lambda: [image_tile_histograms_plain(*g) for g in grids],
                  reps)
    keys = [tile_keys(*g) for g in grids]
    lms = cuda_ms(lambda: [torch.bincount(k, minlength=g[1] * g[2] * 256)
                           for k, g in zip(keys, grids)], reps)
    b5 = bound(sum(img8.nbytes + g[1] * g[2] * 256 * 4 for g in grids),
               {"int32": sum(k.numel() for k in keys)})
    records.append(dict(
        name="tile_hist_u8", kernel="tile_hist", launches=8, err=err, ms=ms,
        plain_ms=pms, library_ms=lms, bound=b5,
        note=f"4 calls on the {tuple(img8.shape)} u8 image, 256 bins, tiles "
             f"1x1 to 4x4; device {dms:.4f} ms, {100 * b5[0] / dms:.1f}% of "
             f"bound; launches: the tool's runs on the u8 image"))
    del img8, grids, keys

    # (e) python -m solex_ser_recon_en_torch on phase 9's small scan
    small = os.path.join(tmp, "small", "g0.ser")
    out_in, out_sub = os.path.join(tmp, "m_in"), os.path.join(tmp, "m_sub")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main.main(["-cw0", small, "--output-dir", out_in])
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    sub = subprocess.run([sys.executable, "-m", "solex_ser_recon_en_torch",
                          "-cw0", small, "--output-dir", out_sub], cwd=tmp,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    sub_s = time.perf_counter() - t0
    if rc != 0 or sub.returncode != 0:
        print(sub.stdout[-2000:] + sub.stderr[-2000:], flush=True)
        fail(f"-cw0 on g0.ser: cli.main rc {rc}, python -m rc "
             f"{sub.returncode}")
    name = "g0_shift=0_clahe.png"
    with open(os.path.join(out_in, name), "rb") as f, \
            open(os.path.join(out_sub, name), "rb") as g:
        if f.read() != g.read():
            fail("python -m solex_ser_recon_en_torch's _clahe.png differs "
                 "from cli.main's")
    print(f"python -m solex_ser_recon_en_torch -cw0 (g0.ser): rc 0 in "
          f"{sub_s:.1f} s; _clahe.png equal to the in-process run's",
          flush=True)
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return records


def mesh_phase(path, tmp, png4, card, dev, res, wall2) -> list:
    """Phase 12: the device mesh (parallel/mesh.py) on the phase-3 scan
    (module docstring); returns the records of pass A's kernel and B3 on
    the mesh run's pieces (``sum_max_shard``, ``recon_shard``)."""
    import contextlib
    import io
    import socket

    import torch
    import torch.distributed as dist

    from solex_ser_recon_en_torch.cli import main as cli_main
    from solex_ser_recon_en_torch.cli.flags import parse_cli
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.ops import cuda_build, fused, fused_cuda
    from solex_ser_recon_en_torch.ops.dtypes import as_int16, widen
    from solex_ser_recon_en_torch.ops.recon import (
        build_shift_indices,
        recon_chunks_plain,
    )
    from solex_ser_recon_en_torch.parallel.distributed import initialize
    from solex_ser_recon_en_torch.parallel.mesh import (
        device_pipeline_step,
        make_mesh,
        shard_scan_recon,
    )
    from solex_ser_recon_en_torch.pipeline import run as run_mod
    from solex_ser_recon_en_torch.pipeline.batch import read_scans_batched

    t_phase = time.perf_counter()
    reps = 10
    torch.cuda.synchronize()
    print(f"mesh: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated "
          f"before the phase loads its scan [{card}]", flush=True)

    def zero_counts():
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0

    def same(a, b):
        return a.shape == b.shape and torch.equal(as_int16(a).cpu(),
                                                  as_int16(b).cpu())

    def cw0_options(out):
        opts = Options()
        parse_cli(opts, ["-cw0", path, "--output-dir", out])
        return opts

    # (1) -cw0 through process_file under a 4-shard frame mesh on the card
    mesh4 = make_mesh({"frame": 4}, devices=[dev] * 4)
    got = {}
    orig = {"read_scan": run_mod.read_scan,
            "mean_max": fused.RawScanProcessor.mean_max,
            "recon_chunks": fused.recon_chunks, "sum_max": fused.sum_max}
    pieces, groups = [], []

    def read_scan(file, opts, d, timer=None, mesh=None):
        got["scan"] = orig["read_scan"](file, opts, d, timer, mesh)
        return got["scan"]

    def mean_max(self):
        got["mean_max"] = orig["mean_max"](self)
        return got["mean_max"]

    def sum_max(frames, total, mx):
        pieces.append((frames, total))
        return orig["sum_max"](frames, total, mx)

    def recon_chunks(chunks, ind_l, left_w, rotate, upscale, out=None,
                     frame_offset=0):
        groups.append((list(chunks), ind_l, left_w, rotate, upscale))
        return orig["recon_chunks"](chunks, ind_l, left_w, rotate, upscale,
                                    out, frame_offset)

    out12 = os.path.join(tmp, "mesh_out")
    opts = cw0_options(out12)
    run_mod.read_scan, fused.RawScanProcessor.mean_max = read_scan, mean_max
    fused.recon_chunks, fused.sum_max = recon_chunks, sum_max
    try:
        zero_counts()
        t0 = time.perf_counter()
        run_mod.process_file(path, opts, dev, mesh=mesh4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
    finally:
        run_mod.read_scan = orig["read_scan"]
        fused.RawScanProcessor.mean_max = orig["mean_max"]
        fused.recon_chunks, fused.sum_max = (orig["recon_chunks"],
                                             orig["sum_max"])
    sr4, sr = res["scan"], got["scan"]
    print(f"mesh: -cw0 through process_file on a 4-shard frame mesh of the "
          f"one card: wall {wall:.3f} s (phase 4's run 2 {wall2:.3f} s; "
          f"information only: the shards run one after another); launches "
          f"{launches} [{card}]", flush=True)
    if len(pieces) != launches["sum_max"] or launches["recon"] != 4 or \
            launches["hresample"] < 1 or launches["tile_hist"] != 2:
        fail(f"mesh: launches {launches} for {len(pieces)} pieces: pass A "
             "must run once a piece, B3 4 times, B4 at least once, B5 twice")
    if len({p.data_ptr() for _, p in pieces}) != 4:
        fail("mesh: pass A did not keep one accumulator pair a shard")
    if not np.array_equal(got["mean_max"][0], sr4.mean_img) or \
            not np.array_equal(got["mean_max"][1], res["max_img"]):
        fail("mesh: mean or max differs from phase 4's")
    zi = sr.shifts.index(0)
    if sr.shifts != sr4.shifts or not same(sr.disk_list[zi],
                                           sr4.disk_list[zi]):
        fail("mesh: the shift-0 disk differs from phase 4's")
    with open(os.path.join(out12, "scan_shift=0_clahe.png"), "rb") as f:
        mine = f.read()
    with open(png4, "rb") as f:
        if mine != f.read():
            fail("mesh: _clahe.png differs from phase 4's")
    n_pieces = len(pieces)
    print(f"mesh: {n_pieces} pieces ({sorted({p.shape[0] for p, _ in pieces})}"
          f" frames), B3 once a shard over {[len(g[0]) for g in groups]} "
          "pieces; mean, max and every disk equal phase 4's bit for bit, "
          "_clahe.png byte-identical", flush=True)

    # the kernel entries on the pieces' shapes
    def max_abs_err(x, y):
        return (widen(x) - widen(y)).abs().max().item()

    err = max(max_abs_err(orig["recon_chunks"](*g), recon_chunks_plain(*g))
              for g in groups)
    ms = cuda_ms(lambda: [orig["recon_chunks"](*g) for g in groups], reps)
    dms = device_ms(lambda: [orig["recon_chunks"](*g) for g in groups],
                    reps)
    pms = cuda_ms(lambda: [recon_chunks_plain(*g) for g in groups], reps)
    nbytes, flops = 0, 0
    for chunks, ind_l, left_w, rotate, _ in groups:
        n = sum(c.shape[0] for c in chunks)
        S, ih = ind_l.shape
        iw = chunks[0].shape[1] if rotate else chunks[0].shape[2]
        nbytes += (tap_columns(ind_l, iw) * n * chunks[0].element_size()
                   + S * ih * n * 2 + ind_l.nbytes + left_w.nbytes)
        flops += 3 * S * ih * n
    b3 = bound(nbytes, {"f32": flops})
    records = [dict(
        name="recon_shard", kernel="recon", launches=launches["recon"],
        err=err, ms=ms, plain_ms=pms, library_ms=None, bound=b3,
        note=f"4 launches, one a shard, over {[len(g[0]) for g in groups]} "
             f"pieces of {sorted({tuple(c.shape) for g in groups for c in g[0]})}"
             f"; device {dms:.4f} ms, {100 * b3[0] / dms:.1f}% of bound")]

    hw = pieces[0][0].shape[1:]
    accs = list(dict.fromkeys(t.data_ptr() for _, t in pieces))
    owner = [accs.index(t.data_ptr()) for _, t in pieces]
    chunks_a = [p for p, _ in pieces]

    def pass_a(step):
        acc = [(torch.zeros(hw, dtype=torch.int32, device=dev),
                torch.zeros(hw, dtype=torch.int32, device=dev))
               for _ in accs]
        for c, k in zip(chunks_a, owner):
            step(c, *acc[k])
        return [x for pair in acc for x in pair]

    err = max(max_abs_err(x, y) for x, y in zip(
        pass_a(orig["sum_max"]), pass_a(fused_cuda.sum_max_plain)))
    ms = cuda_ms(lambda: pass_a(orig["sum_max"]), reps)
    pms = cuda_ms(lambda: pass_a(fused_cuda.sum_max_plain), reps)
    acc_s = torch.zeros(hw, dtype=torch.int32, device=dev)
    acc_m = torch.zeros_like(acc_s)
    dms = device_ms(lambda: [orig["sum_max"](c, acc_s, acc_m)
                             for c in chunks_a], reps)
    raw_bytes = sum(c.nbytes for c in chunks_a)
    bA = bound(raw_bytes + len(chunks_a) * 4 * acc_s.nbytes,
               {"int32": 2 * raw_bytes // chunks_a[0].element_size()})
    records.append(dict(
        name="sum_max_shard", kernel="sum_max", launches=launches["sum_max"],
        err=err, ms=ms, plain_ms=pms, library_ms=None, bound=bA,
        note=f"{len(chunks_a)} launches, one a piece of "
             f"{sorted({tuple(c.shape) for c in chunks_a})} into its "
             f"shard's accumulators; device {dms:.4f} ms, "
             f"{raw_bytes / dms / 1e9:.3f} TB/s, {100 * bA[0] / dms:.1f}% "
             "of bound"))
    del pieces, groups, chunks_a, acc_s, acc_m, got, sr
    torch.cuda.empty_cache()

    # (2) the band feed under the same mesh: its disks equal phase 10's
    # band disks, which phase 10 holds equal to phase 4's bit for bit
    opts = cw0_options(os.path.join(tmp, "mesh_band"))
    opts.feed_mode = "band"
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        band = run_mod.read_scan(path, opts, dev, mesh=mesh4)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    if cuda_build.LAUNCHES["recon"] != 4 or cuda_build.LAUNCHES["sum_max"]:
        fail(f"mesh: band feed launches {dict(cuda_build.LAUNCHES)}: B3 must "
             "run once a shard, pass A's kernel never")
    if band.shifts != sr4.shifts or not same(band.disk_list, sr4.disk_list):
        fail("mesh: the band feed's disks under the mesh differ from phase "
             "10's band disks (= phase 4's)")
    print(f"mesh: --feed band under the mesh: B3 4, disks equal phase 10's "
          f"band disks; read_scan {wall_b:.3f} s [{card}]", flush=True)
    del band
    torch.cuda.empty_cache()

    # (3) the CLI and a mesh the machine cannot hold; on a machine with two
    # cards, the mesh on distinct cards and each kernel on cuda:1
    n_cards = torch.cuda.device_count()
    out_cli = os.path.join(tmp, "mesh_cli")
    if n_cards < 2:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli_main.main(["-cw0", path, "--mesh", "frame=2",
                                "--output-dir", out_cli])
        said = text.getvalue()
        if rc != 2 or "needs 2 devices" not in said or (
                os.path.isdir(out_cli) and os.listdir(out_cli)):
            fail(f"mesh: shg-torch --mesh frame=2 on {n_cards} card: rc {rc}"
                 f", said {said[-500:]!r}")
        print(f"mesh: shg-torch -cw0 --mesh frame=2 on {n_cards} card exits 2"
              f" with nothing written: {said.strip().splitlines()[-1]}",
              flush=True)
    else:
        two_card_checks(path, tmp, png4, card)

    # (4) the group read under a (batch=2, frame=2) mesh of the one card,
    # over phase 9's four small scans
    small = os.path.join(tmp, "small")
    members = [os.path.join(small, f"g{i}.ser") for i in range(4)]

    def group(name, mesh=None):
        d = os.path.join(tmp, name)
        os.makedirs(d, exist_ok=True)
        tasks = [(f, Options(shift=[0], clahe_only=True, output_dir=d))
                 for f in members]
        with contextlib.redirect_stdout(io.StringIO()):
            return read_scans_batched(tasks, {}, dev, mesh=mesh)

    plain = group("mesh_group_plain")
    zero_counts()
    t0 = time.perf_counter()
    sharded = group("mesh_group", make_mesh({"batch": 2, "frame": 2},
                                            devices=[dev] * 4))
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t0
    if sorted(sharded) != members or cuda_build.LAUNCHES["recon"] != 8:
        fail(f"mesh: the group read took {sorted(sharded)}, B3 launches "
             f"{cuda_build.LAUNCHES['recon']} (4 members x 2 frame shards)")
    for f in members:
        if not same(plain[f].disk_list, sharded[f].disk_list):
            fail(f"mesh: the group read's disks of {f} differ under the mesh")
    print(f"mesh: the group read under a (batch=2, frame=2) mesh: B3 once a "
          f"piece (8), disks equal the unsharded group read's; {wall_g:.3f} s"
          f" [{card}]", flush=True)
    del plain, sharded

    # (5) the library functions on the card against their CPU results
    rng = np.random.default_rng(42)
    F, ih, iw = 64, 32, 24
    frames = rng.integers(0, 65536, size=(F, ih, iw), dtype=np.uint16)
    curve = 10.0 + 0.03 * np.arange(ih)
    floor = np.floor(curve).astype(np.int64)
    ind_l, left_w = build_shift_indices(floor, curve - floor, [0, 2, -1], iw)
    cpu = torch.device("cpu")

    def lsb(a, b):
        d = (widen(a.cpu()) - widen(b.cpu())).abs()
        return d.max().item(), (d > 0).float().mean().item()

    for kernel in ("onehot", "gather"):
        a = shard_scan_recon(frames, ind_l, left_w,
                             make_mesh({"frame": 8}, [dev] * 8), kernel)
        b = shard_scan_recon(frames, ind_l, left_w,
                             make_mesh({"frame": 8}, [cpu] * 8), kernel)
        mx, frac = lsb(a, b)
        if a.device.type != dev.type or mx > 1 or frac >= 0.005:
            fail(f"mesh: shard_scan_recon ({kernel}) on the card against the "
                 f"CPU: {mx} LSB on {frac:.4%}")
        print(f"mesh: shard_scan_recon ({kernel}, 8 shards) on the card "
              f"against the CPU: max {mx} LSB on {frac:.4%}", flush=True)
    B, F, ih, iw = 2, 16, 32, 16
    frames = rng.integers(0, 65536, size=(B, F, ih, iw), dtype=np.uint16)
    curve = iw / 2 + 0.01 * np.arange(ih)
    floor = np.floor(curve).astype(np.int64)
    ind_l, left_w = build_shift_indices(floor, curve - floor, [0, 1], iw)
    ind_b = np.ascontiguousarray(np.broadcast_to(ind_l, (B,) + ind_l.shape))
    w_b = np.ascontiguousarray(np.broadcast_to(left_w, (B,) + left_w.shape))
    mats = np.stack([np.array([[1.0, 0.0, 0.0], [0.02, 1.05, -0.4],
                               [0.0, 0.0, 1.0]], np.float32)] * B)
    gains = np.stack([np.ones(ih, np.float32),
                      np.linspace(0.9, 1.1, ih, dtype=np.float32)])
    for out_u16 in (True, False):
        a = device_pipeline_step(frames, ind_b, w_b, mats, gains,
                                 mesh=make_mesh({"batch": 2, "frame": 4},
                                                [dev] * 8), out_u16=out_u16)
        b = device_pipeline_step(frames, ind_b, w_b, mats, gains,
                                 mesh=make_mesh({"batch": 2, "frame": 4},
                                                [cpu] * 8), out_u16=out_u16)
        for k in ("mean", "max"):
            if not same(a[k], b[k]):
                fail(f"mesh: device_pipeline_step {k} differs on the card")
        if out_u16:
            stats = {k: lsb(a[k], b[k]) for k in ("raw", "circular")}
            if any(m > 1 or f >= 0.005 for m, f in stats.values()):
                fail(f"mesh: device_pipeline_step on the card: {stats}")
        else:
            d = (a["circular"].cpu() - b["circular"]).abs().max().item()
            stats = {"circular_float_max_abs": d}
            if d > 65536 * (2e-7 + 3e-5):
                fail(f"mesh: device_pipeline_step's float circular output "
                     f"on the card is {d} from the CPU's")
        print(f"mesh: device_pipeline_step ((2, 4) mesh, out_u16={out_u16}) "
              f"on the card against the CPU: mean, max equal; {stats}",
              flush=True)

    # (6) initialize: a one-process nccl group on the card, one all_reduce
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    initialize(f"127.0.0.1:{port}", 1, 0, device=dev)
    try:
        x = torch.ones(4, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if backend != "nccl" or x.tolist() != [1.0] * 4:
        fail(f"mesh: initialize gave backend {backend}, all_reduce "
             f"{x.tolist()}")
    print(f"mesh: initialize (world size 1, {backend}) and one all_reduce on "
          f"the card in {time.perf_counter() - t0:.2f} s", flush=True)

    took = time.perf_counter() - t_phase
    print(f"phase 12 took {took:.1f} s [{card}]", flush=True)
    if took >= 30:
        fail(f"phase 12 took {took:.1f} s, not under 30 s")
    return records


def display_gui_phase(path, tmp, png4, card, dev, res, wall2,
                      n_chunks) -> list:
    """Phase 13: ``-d``'s live view and product display, and the GUI's
    file mode, on the card (module docstring); returns the record of B3's
    once-a-chunk pattern under ``-d`` (``recon_live``)."""
    import contextlib
    import importlib.util
    import io

    import torch

    from solex_ser_recon_en_torch.cli import main as cli_main
    from solex_ser_recon_en_torch.io.png import read_png
    from solex_ser_recon_en_torch.io.ser import SerReader
    from solex_ser_recon_en_torch.ops import cuda_build, fused
    from solex_ser_recon_en_torch.ops.dtypes import as_int16, widen
    from solex_ser_recon_en_torch.ops.recon import recon_chunks_plain
    from solex_ser_recon_en_torch.pipeline import products
    from solex_ser_recon_en_torch.pipeline import run as run_mod
    from solex_ser_recon_en_torch.pipeline.products import to_host
    from solex_ser_recon_en_torch.utils import display

    t_phase = time.perf_counter()
    reps = 10

    def zero_counts():
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0

    def read(p):
        with open(p, "rb") as f:
            return f.read()

    # (1) -cdw0 through cli.main under a recording display; the hooks only
    # keep references: B3's launches, the product core's and the protus
    # disc's outputs
    caps = {"recon": [], "core": [], "disc": []}
    targets = {"recon_chunks": fused, "_products_core_gained": products,
               "protus_disc": products}
    orig = {name: getattr(obj, name) for name, obj in targets.items()}

    def recon_chunks(chunks, *a):
        caps["recon"].append((list(chunks),) + a)
        return orig["recon_chunks"](chunks, *a)

    def core(*a):
        out = orig["_products_core_gained"](*a)
        caps["core"].append(out)
        return out

    def disc(*a):
        out = orig["protus_disc"](*a)
        caps["disc"].append(out)
        return out

    hooks = {"recon_chunks": recon_chunks, "_products_core_gained": core,
             "protus_disc": disc}
    spent = {"hook": 0.0, "recorder": 0.0, "trio": 0.0}
    in_hook = [False]

    class TimedRecorder(display.Recorder):
        """The recorder, with the host time of its copies: those made
        inside the live view's hook, and the others (the trio's)."""

        def show(self, name, img, wait_ms):
            t = time.perf_counter()
            super().show(name, img, wait_ms)
            spent["recorder" if in_hook[0] else "trio"] += (
                time.perf_counter() - t)

    live_view = run_mod._live_view

    def timed_live_view(*a):
        """pipeline/run.py:_live_view whose hook's host time is summed."""
        hook = live_view(*a)

        def timed(*b):
            t = time.perf_counter()
            in_hook[0] = True
            try:
                hook(*b)
            finally:
                in_hook[0] = False
            spent["hook"] += time.perf_counter() - t
        return timed

    def run(flags, out):
        """One quiet cli.main run: (rc, wall s, its stage lines, output)."""
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = cli_main.main([flags, path, "--output-dir",
                                os.path.join(tmp, out)])
        torch.cuda.synchronize()
        said = text.getvalue()
        stages = said.split("done:", 1)[-1].strip().replace("\n", ";")
        return rc, time.perf_counter() - t0, stages, said

    # -cw0 and -cdw0 in turns (-cw0, -cdw0 checked, -cdw0, -cw0): the
    # checked run's hooks only keep references and sum host times
    rec = TimedRecorder()
    out_d = os.path.join(tmp, "out_display")
    walls = {}
    try:
        walls["-cw0 a"] = run("-cw0", "out_cw0_a")
        for name, obj in targets.items():
            setattr(obj, name, hooks[name])
        run_mod._live_view = timed_live_view
        display.BACKEND = rec
        zero_counts()
        walls["-cdw0 a"] = run("-cdw0", "out_display")
        launches = dict(cuda_build.LAUNCHES)
        for name, obj in targets.items():
            setattr(obj, name, orig[name])
        run_mod._live_view = live_view
        display.BACKEND = display.Recorder()
        walls["-cdw0 b"] = run("-cdw0", "out_display_b")
        display.BACKEND = None
        walls["-cw0 b"] = run("-cw0", "out_cw0_b")
    finally:
        display.BACKEND = None
        run_mod._live_view = live_view
        for name, obj in targets.items():
            setattr(obj, name, orig[name])
    for key, (rc, wall, stages, said) in walls.items():
        if rc != 0:
            print(said[-4000:], flush=True)
            fail(f"display: {key.split()[0]} returned {rc}")
        print(f"display: {key} wall {wall:.3f} s; stages {stages} [{card}]",
              flush=True)
    print(f"display: -cdw0 walls {walls['-cdw0 a'][1]:.3f}, "
          f"{walls['-cdw0 b'][1]:.3f} s beside -cw0's "
          f"{walls['-cw0 a'][1]:.3f}, {walls['-cw0 b'][1]:.3f} s in turns "
          f"and phase 4's run 2 {wall2:.3f} s; in the checked -cdw0 run the "
          f"live view's hook took {1e3 * spent['hook']:.1f} ms on the host, "
          f"{1e3 * spent['recorder']:.1f} ms of it the recorder's copies; "
          f"the recorder's copies of the trio {1e3 * spent['trio']:.1f} ms "
          f"[{card}]", flush=True)
    print(f"display: launches of the checked -cdw0 run: {launches}",
          flush=True)
    want = {"sum_max": n_chunks, "recon": n_chunks, "hresample": 1,
            "tile_hist": 2}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"display: -cdw0 launched {launches}, not {want} (B3 once a "
             "chunk under -d)")

    # every disk canvas is phase 4's shift-0 disk so far, the last all of it
    sc = res["scan"]
    disk0 = sc.disk_list[sc.shifts.index(0)].cpu().numpy()
    canvases = rec.images("disk")
    ends = [c.shape[1] for c in canvases]
    if len(canvases) != n_chunks or ends[-1] != disk0.shape[1]:
        fail(f"display: {len(canvases)} disk canvases ending at "
             f"{ends[-1:]} columns, not {n_chunks} ending at "
             f"{disk0.shape[1]}")
    for c in canvases:
        if not np.array_equal(c, disk0[:, :c.shape[1]]):
            fail(f"display: the disk canvas of {c.shape[1]} columns differs "
                 "from phase 4's shift-0 disk")
    # every image is its chunk's last frame, oriented, read from the SER
    raw = SerReader(path).raw_frames()
    images = rec.images("image")
    if len(images) != n_chunks:
        fail(f"display: {len(images)} slit frames shown, not {n_chunks}")
    for img, end in zip(images, ends):
        if not np.array_equal(img, np.rot90(raw[end - 1])):
            fail(f"display: the slit frame shown at frame {end - 1} is not "
                 "the SER's, oriented")
    del raw
    # the trio: the run's own CLAHE, high-contrast and protus images
    (trio,) = rec.images(display.PRODUCTS_WINDOW)
    _, _, cc, hc, protus = caps["core"][-1]
    if caps["disc"]:
        protus = caps["disc"][-1]
    own = np.concatenate([to_host(x) for x in (cc, hc, protus)], axis=1)
    png_d = os.path.join(out_d, "scan_shift=0_clahe.png")
    if not np.array_equal(trio, own):
        fail("display: the Sun images trio is not the run's own products")
    w = trio.shape[1] // 3
    if not np.array_equal(trio[:, :w], read_png(png_d)):
        fail("display: the trio's CLAHE image is not _clahe.png's pixels")
    if read(png_d) != read(png4):
        fail("display: -cdw0's _clahe.png differs from phase 4's")
    print(f"display: {len(canvases)} disk canvases equal phase 4's shift-0 "
          f"disk so far, {len(images)} slit frames equal the SER's, the trio "
          f"{trio.shape} the run's own products, _clahe.png equal to phase "
          f"4's", flush=True)

    # recon_live: B3 once a chunk, on the run's own chunks and taps, against
    # its plain version; device time queued behind a sleep kernel, and the
    # host-clock time of the launches with the live view's readbacks
    calls = caps["recon"]
    if len(calls) != n_chunks or any(len(c[0]) != 1 for c in calls):
        fail(f"display: B3 calls {[len(c[0]) for c in calls]}")
    _, ind_l, left_w, rotate, upscale, disks, _ = calls[0]
    starts = [c[6] for c in calls]
    chunks = [c[0][0] for c in calls]
    zi = sc.shifts.index(0)
    out_k = torch.empty_like(disks)
    out_p = torch.empty_like(disks)

    def live(out, step):
        for start, c in zip(starts, chunks):
            step([c], ind_l, left_w, rotate, upscale, out, start)

    live(out_k, orig["recon_chunks"])
    live(out_p, recon_chunks_plain)
    err = (widen(out_k) - widen(out_p)).abs().max().item()
    if not torch.equal(as_int16(out_k), as_int16(disks)):
        fail("display: B3 once a chunk differs from the -cdw0 run's disks")
    if not torch.equal(as_int16(out_k), as_int16(sc.disk_list)):
        fail("display: B3 once a chunk differs from phase 4's one launch")
    ms = cuda_ms(lambda: live(out_k, orig["recon_chunks"]), reps)
    dms = device_ms(lambda: live(out_k, orig["recon_chunks"]), reps)
    pms = cuda_ms(lambda: live(out_p, recon_chunks_plain), reps)

    def with_readbacks():
        for start, c in zip(starts, chunks):
            orig["recon_chunks"]([c], ind_l, left_w, rotate, upscale, out_k,
                                 start)
            to_host(out_k[zi, :, start:start + c.shape[0]])
            to_host(fused.last_frame(c, rotate))

    back = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with_readbacks()
        back.append(1e3 * (time.perf_counter() - t0))
    back_ms = statistics.median(back)
    S, ih = ind_l.shape
    iw = chunks[0].shape[1] if rotate else chunks[0].shape[2]
    nbytes = sum(tap_columns(ind_l, iw) * c.shape[0] * c.element_size()
                 + S * ih * c.shape[0] * 2 + ind_l.nbytes + left_w.nbytes
                 for c in chunks)
    F = sum(c.shape[0] for c in chunks)
    bl = bound(nbytes, {"f32": 3 * S * ih * F})
    record = dict(
        name="recon_live", kernel="recon", launches=launches["recon"],
        err=err, ms=ms, plain_ms=pms, library_ms=None, bound=bl,
        note=f"{len(chunks)} launches, one a chunk of "
             f"{tuple(chunks[0].shape)} (-d's live view); device {dms:.4f} "
             f"ms, {100 * bl[0] / dms:.1f}% of bound; with the live view's "
             f"{len(chunks)} readbacks (the chunk's shift-0 columns and its "
             f"slit frame) {back_ms:.3f} ms on the host clock; equal to the "
             f"one launch of phase 4")
    del out_k, out_p, chunks, calls, caps
    print(f"recon_live: {n_chunks} launches {ms:.4f} ms (device {dms:.4f} "
          f"ms), with readbacks {back_ms:.3f} ms, plain {pms:.4f} ms, bound "
          f"{bl[0]:.4f} ms [{card}]", flush=True)

    # (2) -cd with no display backend: exit 2 naming the display, nothing
    # written
    out_n = os.path.join(tmp, "out_no_display")
    saved = {k: os.environ.pop(k) for k in ("DISPLAY", "WAYLAND_DISPLAY")
             if k in os.environ}
    try:
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = cli_main.main(["-cdw0", path, "--output-dir", out_n])
    finally:
        os.environ.update(saved)
    said = text.getvalue()
    if rc != 2 or "DISPLAY" not in said or (
            os.path.isdir(out_n) and os.listdir(out_n)):
        fail(f"display: -cd without a display returned {rc} ({said!r})")
    print(f"display: -cd without a display exits 2: {said.strip()}",
          flush=True)

    # (3) the GUI on the card: run_app() with no device, under the tests'
    # FreeSimpleGUI stub, one OK in File input mode with -c on the bench
    # scan and phase 9's g0.ser
    spec = importlib.util.spec_from_file_location(
        "FreeSimpleGUI", os.path.join(ROOT, "tests", "stub_freesimplegui.py"))
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)
    from solex_ser_recon_en_torch.gui import main_window

    g0 = os.path.join(tmp, "small", "g0.ser")
    out_g = os.path.join(tmp, "out_gui")
    os.makedirs(out_g)
    devices = []
    handle = cli_main.handle_files

    def handle_files(files, options, device, meter=None):
        devices.append(device)
        return handle(files, options, device, meter=meter)

    stub.script([("OK", {"-FILE-": f"{path};{g0}", "_pixel_offset": "0",
                         "Save clahe.png only": True, "output_dir": out_g})])
    cwd = os.getcwd()
    sys.modules["FreeSimpleGUI"] = stub
    try:
        os.chdir(tmp)                      # the app's SHG_config.txt
        cli_main.handle_files = handle_files
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = main_window.run_app()
        torch.cuda.synchronize()
        wall_g = time.perf_counter() - t0
        launches_g = dict(cuda_build.LAUNCHES)
    finally:
        cli_main.handle_files = handle
        os.chdir(cwd)
        del sys.modules["FreeSimpleGUI"]
    meter = [c[1:3] for c in stub.METER_CALLS]
    if rc != 0 or [d.type for d in devices] != ["cuda"]:
        print(text.getvalue()[-4000:], flush=True)
        fail(f"gui: run_app returned {rc} on {devices}")
    if meter != [(0, 2), (1, 2), (2, 2)]:
        fail(f"gui: the progress meter was called {meter}")
    if (launches_g["recon"] != 2 or launches_g["tile_hist"] != 4
            or launches_g["hresample"] < 2
            or launches_g["sum_max"] < n_chunks + 1):
        fail(f"gui: launches {launches_g}")
    for got, ref in ((os.path.join(out_g, "scan_shift=0_clahe.png"), png4),
                     (os.path.join(out_g, "g0_shift=0_clahe.png"),
                      os.path.join(tmp, "small_out", "g0_shift=0_clahe.png"))):
        if read(got) != read(ref):
            fail(f"gui: {os.path.basename(got)} differs from {ref}")
    print(f"gui: run_app() took {devices[0]}, {wall_g:.3f} s for the two "
          f"files; meter calls {meter}; launches {launches_g}; both "
          f"_clahe.png equal phases 4 and 9 [{card}]", flush=True)
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return [record]


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (its model name, or where
    that is missing or "unknown" the vendor, family, model numbers and
    clock, or an ARM part), its architecture and core count."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                      # the first processor only
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name")
    if name in (None, "", "unknown"):     # a virtualised host may hide it
        name = " ".join(f"{k} {fields[k]}" for k in (
            "vendor_id", "cpu family", "model", "cpu MHz", "CPU implementer",
            "CPU part", "Hardware") if k in fields) or "unknown"
    return f"{name} ({platform.machine()}), {os.cpu_count()} cores"


def golden_phase(path, tmp, png4, card, res, wall2, scan) -> None:
    """Phase 14: phase 4's ``-cw0`` results against the port's reference
    replica (utils/cpu_reference.py, numpy with no cv2) on the same scan,
    then the replica's ``-c`` leg timed (module docstring).  Every gate is
    checked and printed before the phase fails on any miss."""
    import torch

    from solex_ser_recon_en_torch.io.png import read_png
    from solex_ser_recon_en_torch.ops import cuda_build
    from solex_ser_recon_en_torch.ops.clahe import (
        percentile_from_hist,
        percentile_taps,
        value_histogram,
    )
    from solex_ser_recon_en_torch.ops.dtypes import widen
    from solex_ser_recon_en_torch.pipeline.products import _products_body
    from solex_ser_recon_en_torch.utils import cpu_reference as ref

    t_phase = time.perf_counter()
    cpu = host_cpu()
    print(f"golden: host CPU {cpu} [{card}]", flush=True)
    sr = res["scan"]
    misses = []

    def lsb(a, b):
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        return int(d.max()), float((d > 0).mean()), float(d.mean())

    t0 = time.perf_counter()
    mean_r, max_r = ref.cpu_mean_max(path)
    mm_s = time.perf_counter() - t0
    mean_eq = np.array_equal(mean_r, sr.mean_img)
    max_eq = np.array_equal(max_r, res["max_img"])
    print(f"golden: cpu_mean_max {mm_s:.3f} s; pass A's mean "
          f"{'equals' if mean_eq else 'DIFFERS from'} it, max "
          f"{'equals' if max_eq else 'DIFFERS from'} it", flush=True)
    if not (mean_eq and max_eq):
        misses.append("pass A's mean or max differs from cpu_mean_max")

    t0 = time.perf_counter()
    fit_r = ref.cpu_line_fit(mean_r, max_r)
    fit_s = time.perf_counter() - t0
    lf = sr.linefit
    curve = lf.floor.astype(np.float64) + lf.frac
    dfit = np.abs(curve - fit_r.sum(axis=1))
    ys = np.arange(lf.y1, lf.y2)
    truth = scan.line_center(ys)
    print(f"golden: cpu_line_fit {fit_s:.3f} s; the port's fit against it: "
          f"largest difference of floor + frac {dfit.max():.6f} px (row "
          f"{int(dfit.argmax())}), {dfit[ys].max():.6f} px on the fitted "
          f"rows [{lf.y1}, {lf.y2}), mean {dfit.mean():.6f} px; off the true "
          f"line on those rows: the port {np.abs(curve[ys] - truth).max():.6f}"
          f" px, the replica {np.abs(fit_r.sum(axis=1)[ys] - truth).max():.6f}"
          f" px", flush=True)
    # 2 px, not 1: the replica fits its blurred argmin once (no rejection
    # rounds, no refit on the sharp argmin) and sits ~0.8 px off the true
    # line on scans of the bench scan's proportions (ROADMAP C20)
    if dfit.max() > 2.0:
        misses.append(f"line fit {dfit.max():.4f} px from cpu_line_fit")

    fit_port = np.stack([lf.floor.astype(np.float64), lf.frac], axis=1)
    t0 = time.perf_counter()
    disks_r = ref.cpu_recon(path, fit_port, [10, 0])
    recon_s = time.perf_counter() - t0
    disks_p = [sr.disk_list[sr.shifts.index(s)].cpu().numpy()
               for s in (10, 0)]
    for s, a, b in zip((10, 0), disks_p, disks_r):
        mx, frac, _ = lsb(a, b)
        print(f"golden: B3's shift-{s} disk against cpu_recon with the "
              f"port's fit: max {mx} LSB on {100 * frac:.4f}% of pixels",
              flush=True)
        if mx > 1 or frac >= 0.02:
            misses.append(f"shift-{s} disk beyond 1 LSB on 2% of pixels")
    print(f"golden: cpu_recon (2 shifts) {recon_s:.3f} s", flush=True)

    disk0 = disks_p[1]
    t0 = time.perf_counter()
    cc_r, hc_r = ref.cpu_products(disk0)
    prod_s = time.perf_counter() - t0
    img = sr.disk_list[sr.shifts.index(0)]
    for k in cuda_build.LAUNCHES:
        cuda_build.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    _, cc, hc, _ = _products_body(img)
    torch.cuda.synchronize()
    core_ms = 1e3 * (time.perf_counter() - t0)
    n_b5 = cuda_build.LAUNCHES["tile_hist"]
    cc, hc = widen(cc).cpu().numpy(), widen(hc).cpu().numpy()
    d_cc, d_hc = lsb(cc, cc_r), lsb(hc, hc_r)
    # the high-contrast stretch's 99.9999th percentile: numpy's index
    # q (n - 1) in float64, the packages' in float32 (jnp.percentile;
    # ops/clahe.py:percentile_taps), so on 4.1 M pixels its lerp weight
    # between the two top order statistics moves (ROADMAP C19); the
    # replica's stretch at the port's percentile isolates the rest
    low, high, low_w, high_w = percentile_taps(99.9999, disk0.size)
    stats = np.partition(disk0.ravel(), [low, high])[[low, high]]
    bright32 = np.float32(stats[0]) * low_w + np.float32(stats[1]) * high_w
    bright_p = float(percentile_from_hist(value_histogram(img, 65536),
                                          disk0.size, 99.9999))
    bright_r = float(np.percentile(disk0, 99.9999))
    hc_at_p = (65535.0 * (disk0 - bright_p * 0.25)
               / max(bright_p * 0.75, 1)).clip(0, 65535).astype(np.uint16)
    d_hc_p = lsb(hc, hc_at_p)
    print(f"golden: the product core on the card ({n_b5} B5 launches, "
          f"{core_ms:.2f} ms host clock) against cpu_products ({prod_s:.3f} "
          f"s) on B3's shift-0 disk {tuple(disk0.shape)}: CLAHE stretch max "
          f"{d_cc[0]} LSB on {100 * d_cc[1]:.4f}%, high contrast max "
          f"{d_hc[0]} LSB on {100 * d_hc[1]:.4f}%; its 99.9999th percentile "
          f"{bright_p!r} on the card (the float32 lerp of order statistics "
          f"{low}, {high} = {stats.tolist()} at {float(high_w)!r}: "
          f"{float(bright32)!r}), np.percentile {bright_r!r} (weight "
          f"{0.999999 * (disk0.size - 1) - low!r}); at the card's percentile "
          f"the replica's stretch is max {d_hc_p[0]} LSB on "
          f"{100 * d_hc_p[1]:.4f}% from the card's [{card}]", flush=True)
    if n_b5 != 2:
        misses.append(f"the product core launched B5 {n_b5} times, not 2")
    if d_cc[0] > 4:
        misses.append(f"CLAHE stretch {d_cc[0]} LSB from cpu_products")
    if bright_p != float(bright32) or d_hc_p[0] > 4:
        misses.append(f"high contrast {d_hc_p[0]} LSB from cpu_products' "
                      f"stretch at the card's percentile {bright_p!r} "
                      f"(float32 lerp of the order statistics "
                      f"{float(bright32)!r})")

    # the replica's -c leg as bench.py pairs it with -cw0, its circle kept
    captured = {}
    ellipse_warp = ref.cpu_ellipse_warp

    def keep_circle(*a, **k):
        out = ellipse_warp(*a, **k)
        captured["circle"] = out[1]
        return out

    out_dir = os.path.join(tmp, "golden")
    os.makedirs(out_dir)
    ref.cpu_ellipse_warp = keep_circle
    try:
        cpu_reference_s = ref.cpu_pipeline(path, [0], clahe_only=True,
                                           transversalium=True,
                                           save_dir=out_dir)
    finally:
        ref.cpu_ellipse_warp = ellipse_warp
    names = sorted(os.listdir(out_dir))
    if names != ["scan_shift=0_clahe.png"]:
        misses.append(f"the replica's -c leg wrote {names}")
    mine = read_png(os.path.join(out_dir, "scan_shift=0_clahe.png"))
    theirs = read_png(png4)
    h = min(mine.shape[0], theirs.shape[0])
    w = min(mine.shape[1], theirs.shape[1])
    mx, frac, mean = lsb(mine[:h, :w], theirs[:h, :w])
    rc, pc = captured.get("circle"), res["circle"]
    print(f"golden: cpu_reference_s {cpu_reference_s:.3f} s (the replica's "
          f"-c leg), {cpu_reference_s / wall2:.2f}x phase 4's run 2 "
          f"{wall2:.3f} s; circle (x, y, r): replica "
          f"{None if rc is None else tuple(round(float(v), 3) for v in rc)},"
          f" port {tuple(round(float(v), 3) for v in pc)}; its _clahe.png "
          f"{mine.shape} against phase 4's {theirs.shape} on the common "
          f"{h} x {w}: max {mx} LSB, mean {mean:.3f} LSB, {100 * frac:.2f}% "
          f"differ (the warp and transversalium differ by design) "
          f"[{card}; host CPU {cpu}]", flush=True)
    print("golden: " + json.dumps({
        "cpu_reference_s": cpu_reference_s, "vs_phase4_run2": cpu_reference_s
        / wall2, "cpu_mean_max_s": mm_s, "cpu_line_fit_s": fit_s,
        "cpu_recon_s": recon_s, "cpu_products_s": prod_s,
        "line_fit_max_px": float(dfit.max()), "host_cpu": cpu,
        "card": card}), flush=True)
    took = time.perf_counter() - t_phase
    print(f"phase 14 took {took:.1f} s [{card}]", flush=True)
    if misses:
        fail("golden: " + "; ".join(misses))


def two_card_checks(path, tmp, png4, card) -> None:
    """Phase 12 on a machine with two cards or more: ``-cw0`` under a mesh
    of cuda:0 and cuda:1 gives phase 4's ``_clahe.png``, and each kernel,
    for tensors on cuda:1 launched while cuda:0 is current, equals its
    plain version."""
    import torch

    from solex_ser_recon_en_torch.cli.flags import parse_cli
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.geometry.ellipse import (
        get_correction_matrix,
    )
    from solex_ser_recon_en_torch.ops import clahe, cuda_build, fused_cuda
    from solex_ser_recon_en_torch.ops import warp_fast
    from solex_ser_recon_en_torch.ops.dtypes import as_int16
    from solex_ser_recon_en_torch.ops.recon import recon_chunks_plain
    from solex_ser_recon_en_torch.ops.recon_cuda import recon_chunks
    from solex_ser_recon_en_torch.parallel.mesh import mesh_from_options
    from solex_ser_recon_en_torch.pipeline import run as run_mod

    card0, card1 = torch.device("cuda", 0), torch.device("cuda", 1)
    out = os.path.join(tmp, "mesh_two_cards")
    opts = Options()
    parse_cli(opts, ["-cw0", path, "--output-dir", out])
    mesh = mesh_from_options({"frame": 2}, card0)
    run_mod.process_file(path, opts, card0, mesh=mesh)
    with open(os.path.join(out, "scan_shift=0_clahe.png"), "rb") as f, \
            open(png4, "rb") as g:
        if f.read() != g.read():
            fail("mesh on cuda:0 and cuda:1: _clahe.png differs from phase 4's")
    rng = np.random.default_rng(3)
    torch.cuda.set_device(card0)

    def u16(shape):
        a = rng.integers(0, 65536, shape).astype(np.uint16).view(np.int16)
        return torch.from_numpy(a).to(card1).view(torch.uint16)

    raw = u16((70, 24, 64))
    ind_l = torch.from_numpy(rng.integers(0, 22, (2, 64)).astype(
        np.int32)).to(card1)
    left_w = torch.from_numpy(rng.random(64).astype(np.float32)).to(card1)
    frames = u16((40, 48, 300))
    ind_b = torch.from_numpy(rng.integers(0, 298, (2, 48)).astype(
        np.int32)).to(card1)
    w_b = torch.from_numpy(rng.random(48).astype(np.float32)).to(card1)
    img = u16((301, 257))
    mat, _ = get_correction_matrix(0.15, 0.93)
    m3 = np.eye(3)
    m3[:2, :2] = mat
    f01 = (as_int16(u16((2, 300, 257))).to(torch.int32) & 0xFFFF).to(
        torch.float32) / 65536.0
    w_args = warp_fast.warp_inputs(f01, m3, 310, 270, f01[:, 0, 0])

    def pass_a(fn):
        total = torch.zeros((24, 64), dtype=torch.int32, device=card1)
        mx = torch.zeros_like(total)
        fn(raw, total, mx)
        return total, mx

    cases = [
        ("recon", lambda: recon_chunks([raw], ind_l, left_w, True, False),
         lambda: recon_chunks_plain([raw], ind_l, left_w, True, False)),
        ("hresample", lambda: warp_fast.hresample(*w_args),
         lambda: warp_fast.hresample_plain(*w_args)),
        ("tile_hist", lambda: clahe._launch_hist(img, 2, 2, 65536),
         lambda: clahe.image_tile_histograms_plain(img, 2, 2, 65536)),
        ("shg_fused", lambda: fused_cuda.shg_fused(frames, ind_b, w_b),
         lambda: fused_cuda.shg_fused_plain(frames, ind_b, w_b)),
        ("shg_fused_mxu", lambda: fused_cuda.shg_fused_mxu(frames, ind_b, w_b),
         lambda: fused_cuda.shg_fused_mxu_plain(frames, ind_b, w_b)),
        ("sum_max", lambda: pass_a(fused_cuda.sum_max),
         lambda: pass_a(fused_cuda.sum_max_plain)),
    ]
    for name, kernel, plain in cases:
        before = cuda_build.LAUNCHES[name]
        got, want = kernel(), plain()
        torch.cuda.synchronize(card1)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if cuda_build.LAUNCHES[name] != before + 1 or \
                torch.cuda.current_device() != 0:
            fail(f"{name} on cuda:1 did not launch once from cuda:0")
        for a, b in zip(got, want):
            if a.device != card1 or not torch.equal(as_int16(a), as_int16(b)):
                fail(f"{name} on cuda:1, launched from cuda:0, differs from "
                     "its plain version")
    print(f"mesh: -cw0 on a mesh of cuda:0 and cuda:1 gives phase 4's "
          f"_clahe.png; every kernel on cuda:1 launched from cuda:0 equals "
          f"its plain version [{card}]", flush=True)


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "solex_ser_recon_en_torch")):
        fail("solex_ser_recon_en_torch not found beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    from solex_ser_recon_en_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {cuda_build.build_seconds:.2f} s) -> "
          f"{os.path.relpath(cuda_build.library_path(), ROOT)}", flush=True)
    log = (cuda_build.build_dir() / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if any(k in line for k in ("registers", "spill",
                                       "Compiling entry")):
                print("  ptxas:", line.strip().split("ptxas info    : ")[-1])

    from solex_ser_recon_en_torch.io import native

    t0 = time.perf_counter()
    native.get_lib()
    print(f"host library: {time.perf_counter() - t0:.2f} s "
          f"({native.CXX} {native.build_seconds:.2f} s, "
          f"{native.compiler_version()}, {' '.join(native.CXX_FLAGS)}) -> "
          f"{os.path.relpath(native.library_path(), ROOT)}; "
          f"os.cpu_count() {os.cpu_count()}", flush=True)

    # 3. scan
    tmp = tempfile.mkdtemp(prefix="solex_smoke_")
    try:
        path = os.path.join(tmp, "scan.ser")
        t0 = time.perf_counter()
        scan, full = make_scan(path)
        print(f"scan: {FRAMES} x {IH} x {IW} u16, "
              f"{os.path.getsize(path) / 1e9:.3f} GB, generated in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # 4. end to end through the CLI entry point: run 1 with capture
        # hooks, run 2 timed with none
        from solex_ser_recon_en_torch.cli import main as cli_main
        from solex_ser_recon_en_torch.geometry import linefit
        from solex_ser_recon_en_torch.io import feeder
        from solex_ser_recon_en_torch.ops import clahe, fused, warp_fast
        from solex_ser_recon_en_torch.pipeline import run as run_mod

        res = {}
        caps = {"recon": [], "hresample": [], "tile_hist": {}, "blur": []}
        targets = {"read_scan": cli_main, "mean_max": fused.RawScanProcessor,
                   "single_image_process": run_mod, "recon_chunks": fused,
                   "hresample": warp_fast, "image_tile_histograms": clahe,
                   "box_blur_u16_host": linefit}
        orig = {name: getattr(obj, name) for name, obj in targets.items()}

        def box_blur_u16_host(img, kx, ky):
            caps["blur"].append((img.copy(), kx, ky))
            return orig["box_blur_u16_host"](img, kx, ky)

        def read_scan(file, opts, dev, timer=None):
            res["opts"] = opts
            res["scan"] = orig["read_scan"](file, opts, dev, timer)
            return res["scan"]

        def mean_max(self):
            out = orig["mean_max"](self)
            res["max_img"] = out[1]
            return out

        def single_image_process(frame, *a, **k):
            res["frame"] = frame
            res["circle"] = a[2] if len(a) > 2 else k["circle"]
            return orig["single_image_process"](frame, *a, **k)

        def recon_chunks(chunks, ind_l, left_w, rotate, upscale, out=None,
                         frame_offset=0):
            caps["recon"].append((list(chunks), ind_l, left_w, rotate,
                                  upscale))
            return orig["recon_chunks"](chunks, ind_l, left_w, rotate,
                                        upscale, out, frame_offset)

        def hresample(*a):
            caps["hresample"] = [t.clone() for t in a]
            return orig["hresample"](*a)

        def image_tile_histograms(img, ty, tx, hs):
            caps["tile_hist"][(tuple(img.shape), ty, tx)] = (img.clone(), ty,
                                                            tx, hs)
            return orig["image_tile_histograms"](img, ty, tx, hs)

        hooks = {"read_scan": read_scan, "mean_max": mean_max,
                 "single_image_process": single_image_process,
                 "recon_chunks": recon_chunks, "hresample": hresample,
                 "image_tile_histograms": image_tile_histograms,
                 "box_blur_u16_host": box_blur_u16_host}
        for name, obj in targets.items():
            setattr(obj, name, hooks[name])

        outdir = os.path.join(tmp, "out")
        args = ["-cw0", path, "--output-dir", outdir]
        t0 = time.perf_counter()
        rc = cli_main.main(args)
        wall1 = time.perf_counter() - t0
        for name, obj in targets.items():
            setattr(obj, name, orig[name])
        if rc != 0:
            fail("first end-to-end run failed")
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0
        for k in native.CALLS:
            native.CALLS[k] = 0
        t0 = time.perf_counter()
        rc = cli_main.main(args)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        calls = dict(native.CALLS)
        feed2 = dict(feeder.FEED)
        if rc != 0:
            fail("second end-to-end run failed")
        print(f"end to end: run 1 {wall1:.3f} s, run 2 {wall2:.3f} s "
              f"[{card}]", flush=True)
        print(f"launches in run 2: {launches}", flush=True)
        for name in CW0_KERNELS:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched by the -cw0 path")
        # pass A: one launch per chunk of the feeder; B3: one launch over
        # all resident chunks; B5: the CLAHE tiles and the CLAHE image's
        # value histogram
        n_chunks = len(caps["recon"][0][0])
        for name, n in (("sum_max", n_chunks), ("recon", 1),
                        ("tile_hist", 2)):
            if launches[name] != n:
                fail(f"kernel {name} was launched {launches[name]} times "
                     f"by the -cw0 path, not {n}")

        print(f"host library calls in run 2: {calls}", flush=True)
        for name in HOST_ENTRY_POINTS:
            if calls[name] <= 0:
                fail(f"host entry point {name} was not called by the -cw0 "
                     "path")
        print(f"feed in run 2: {feed2['threads']} copy threads, ring of "
              f"{feed2['depth']}, {feed2['chunks']} chunks, wall "
              f"{1e3 * feed2['wall_s']:.1f} ms, uploads "
              f"{feed2['h2d_ms']:.1f} ms on the card, host copies "
              f"{feed2['bytes'] / feed2['fill_s'] / 1e9:.2f} GB/s while "
              f"filling ({1e3 * feed2['fill_s']:.1f} ms; copy threads busy "
              f"{1e3 * feed2['copy_thread_s']:.1f} ms in all); producer "
              f"waited {1e3 * feed2['producer_wait_s']:.1f} ms for a free "
              f"buffer, consumer {1e3 * feed2['consumer_wait_s']:.1f} ms for "
              f"a filled one and {1e3 * feed2['upload_wait_s']:.1f} ms for "
              f"uploads (closing the reader, inside the last wait, "
              f"{1e3 * feed2['close_s']:.1f} ms); the rest of the wall, its "
              f"own CUDA calls and the caller's work between chunks, "
              f"{1e3 * (feed2['wall_s'] - feed2['consumer_wait_s'] - feed2['upload_wait_s']):.1f}"
              f" ms [{card}]", flush=True)

        png = os.path.join(outdir, "scan_shift=0_clahe.png")
        if not os.path.exists(png):
            fail(f"{png} missing")
        from solex_ser_recon_en_torch.io.png import read_png

        png4 = png
        cc = read_png(png)
        frame = res["frame"]
        if cc.shape != tuple(frame.shape):
            fail(f"clahe png shape {cc.shape} != corrected disk "
                 f"{tuple(frame.shape)}")
        if cc.max() == 0:
            fail("clahe png is empty")
        truth = ground_truth_checks(scan, full, res, frame)
        print("ground truth: " + json.dumps(truth), flush=True)
        del full

        host_records = host_phase(path, tmp, png, res, caps["blur"], args,
                                  calls, card, torch.device("cuda"))

        # 5. kernels vs plain versions on the main path's inputs
        from solex_ser_recon_en_torch.ops.clahe import (
            image_tile_histograms_plain,
            tile_keys,
        )
        from solex_ser_recon_en_torch.ops.dtypes import widen
        from solex_ser_recon_en_torch.ops.recon import recon_chunks_plain

        reps = 20
        records = []

        def max_abs_err(x, y):
            if not x.dtype.is_floating_point:
                x, y = widen(x), widen(y)
            return (x - y).abs().max().item()

        rc_args = caps["recon"]
        err = max(max_abs_err(orig["recon_chunks"](*a), recon_chunks_plain(*a))
                  for a in rc_args)
        ms = cuda_ms(lambda: [orig["recon_chunks"](*a) for a in rc_args],
                     reps)
        dms = device_ms(lambda: [orig["recon_chunks"](*a) for a in rc_args],
                        reps)
        pms = cuda_ms(lambda: [recon_chunks_plain(*a) for a in rc_args], reps)
        nbytes, flops = 0, 0
        for chunks, ind_l, left_w, rotate, _ in rc_args:
            raw = chunks[0]
            n = sum(c.shape[0] for c in chunks)
            S, ih = ind_l.shape
            iw = raw.shape[1] if rotate else raw.shape[2]
            nbytes += (tap_columns(ind_l, iw) * n * raw.element_size()
                       + S * ih * n * 2 + ind_l.nbytes + left_w.nbytes)
            flops += 3 * S * ih * n
        b3 = bound(nbytes, {"f32": flops})
        records.append(dict(
            name="recon", kernel="recon", launches=launches["recon"],
            err=err, ms=ms, plain_ms=pms, library_ms=None, bound=b3,
            note=f"{len(rc_args)} launch over {len(rc_args[0][0])} chunks "
                 f"of {tuple(rc_args[0][0][0].shape)}; device {dms:.4f} ms, "
                 f"{100 * b3[0] / dms:.1f}% of bound; launches in run 2: "
                 f"{launches['recon']}"))

        a = caps["hresample"]
        out = orig["hresample"](*a)
        err = max_abs_err(out, warp_fast.hresample_plain(*a))
        ms = cuda_ms(lambda: orig["hresample"](*a), reps)
        pms = cuda_ms(lambda: warp_fast.hresample_plain(*a), reps)
        records.append(dict(
            name="hresample", kernel="hresample",
            launches=launches["hresample"], err=err, ms=ms, plain_ms=pms,
            library_ms=None,
            bound=bound(sum(t.nbytes for t in a) + out.nbytes,
                        {"f32": 4 * out.numel()}),
            note=f"V {tuple(a[0].shape)} -> {tuple(out.shape)}"))

        err, ms, pms, lms, dms = 0, 0.0, 0.0, 0.0, 0.0
        nbytes, nvals, old_bytes = 0, 0, 0
        hist_args = sorted(caps["tile_hist"].items())
        for _, (img, ty, tx, hs) in hist_args:
            a = (img, ty, tx, hs)
            err = max(err, max_abs_err(orig["image_tile_histograms"](*a),
                                       image_tile_histograms_plain(*a)))
            ms += cuda_ms(lambda: orig["image_tile_histograms"](*a), reps)
            dms += device_ms(lambda: orig["image_tile_histograms"](*a), reps)
            pms += cuda_ms(lambda: image_tile_histograms_plain(*a), reps)
            # library yardstick: one bincount over the tile-offset values,
            # made beforehand
            keys = tile_keys(*a)
            T = ty * tx
            lms += cuda_ms(lambda: torch.bincount(keys, minlength=T * hs),
                           reps)
            # bound: the image read once, the bins written once (the
            # kernel's earlier form read a padded int32 tile copy instead)
            nbytes += img.nbytes + T * hs * 4
            old_bytes += keys.numel() * 4 + T * hs * 4
            nvals += keys.numel()
        b5 = bound(nbytes, {"int32": nvals})
        records.append(dict(
            name="tile_hist", kernel="tile_hist",
            launches=launches["tile_hist"], err=err, ms=ms, plain_ms=pms,
            library_ms=lms, bound=b5,
            note=f"images {[k for k, _ in hist_args]}; device {dms:.4f} ms "
                 f"with the output zeroing, {100 * b5[0] / dms:.1f}% of "
                 f"bound; launches in run 2: {launches['tile_hist']}; bound "
                 f"before this kernel read the image: "
                 f"{bound(old_bytes, {'int32': nvals})[0]:.4f} ms"))

        # pass A on the raw chunks the -cw0 path gave it: one launch a chunk
        # into the same accumulators, against torch's reductions
        from solex_ser_recon_en_torch.ops import fused_cuda

        raw_chunks = rc_args[0][0]
        hw = raw_chunks[0].shape[1:]

        def pass_a(step):
            total = torch.zeros(hw, dtype=torch.int32, device="cuda")
            mx = torch.zeros_like(total)
            for c in raw_chunks:
                step(c, total, mx)
            return total, mx

        err = max(max_abs_err(x, y) for x, y in zip(
            pass_a(fused_cuda.sum_max), pass_a(fused_cuda.sum_max_plain)))
        ms = cuda_ms(lambda: pass_a(fused_cuda.sum_max), reps)
        pms = cuda_ms(lambda: pass_a(fused_cuda.sum_max_plain), reps)
        # device time of the launches alone (the accumulators wrap: only
        # the time is read)
        acc_s = torch.zeros(hw, dtype=torch.int32, device="cuda")
        acc_m = torch.zeros_like(acc_s)
        dms = device_ms(lambda: [fused_cuda.sum_max(c, acc_s, acc_m)
                                 for c in raw_chunks], reps)
        # bound: every chunk read once; each launch reads and writes the
        # two accumulators
        raw_bytes = sum(c.nbytes for c in raw_chunks)
        bA = bound(raw_bytes + len(raw_chunks) * 4 * acc_s.nbytes,
                   {"int32": 2 * raw_bytes // raw_chunks[0].element_size()})
        records.append(dict(
            name="sum_max", kernel="sum_max", launches=launches["sum_max"],
            err=err, ms=ms, plain_ms=pms, library_ms=None, bound=bA,
            note=f"{len(raw_chunks)} launches, one a raw chunk of "
                 f"{tuple(raw_chunks[0].shape)} (the last "
                 f"{raw_chunks[-1].shape[0]} frames), with the zeroing of "
                 f"the accumulators; device {dms:.4f} ms for the launches "
                 f"alone, {dms / len(raw_chunks):.4f} ms each, "
                 f"{raw_bytes / dms / 1e9:.3f} TB/s, "
                 f"{100 * bA[0] / dms:.1f}% of bound; plain is torch's "
                 f"int32 copy, sum and amax of each chunk"))
        del acc_s, acc_m, raw_chunks

        # 6. the resident path on the phase-3 scan
        from solex_ser_recon_en_torch import bench_device
        from solex_ser_recon_en_torch.models.shg import shg_forward_plain
        from solex_ser_recon_en_torch.ops.recon_cuda import recon
        from solex_ser_recon_en_torch.bench_kernels import SWEEP
        from solex_ser_recon_en_torch.ops.dtypes import as_int16
        from solex_ser_recon_en_torch.ops.recon import (
            build_shift_indices,
            onehot_weights,
        )

        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0
        for k in fused_cuda.FUSED_PATHS:
            fused_cuda.FUSED_PATHS[k] = 0
        dec = bench_device.device_attached_decomposition(
            path, torch.device("cuda"), os.path.join(tmp, "out_resident"))
        torch.cuda.synchronize()
        launches6 = dict(cuda_build.LAUNCHES)
        paths6 = dict(fused_cuda.FUSED_PATHS)
        print("resident path: " + json.dumps(dec.stages) + f" [{card}]",
              flush=True)
        print(f"launches in the resident path: {launches6}", flush=True)
        for name in RESIDENT_KERNELS:
            if launches6[name] <= 0:
                fail(f"kernel {name} was not launched by the resident path")
        plan = fused_cuda.fused_plan_cuda(dec.frames, len(bench_device.SHIFTS))
        print(f"B1 copy paths in the resident path: {paths6}; launch "
              f"geometry on the bench slab: {plan}; blocks an SM holds: "
              f"{plan['blocks_per_sm']}", flush=True)
        if paths6["bulk"] != launches6["shg_fused"] or paths6["element"]:
            fail("B1 did not take the bulk copy path on the bench slab")
        mirror = fused_cuda.fused_plan(dec.frames.data_ptr(),
                                       len(bench_device.SHIFTS),
                                       *dec.frames.shape[1:])
        if {k: plan[k] for k in mirror} != mirror:
            fail(f"B1's Python plan {mirror} differs from the kernel "
                 f"library's {plan}")
        sr = res["scan"]
        if not np.array_equal(dec.mean.cpu().numpy(), sr.mean_img):
            fail("B1 mean differs from the -cw0 pass-A mean")
        if not np.array_equal(dec.max.cpu().numpy(), res["max_img"]):
            fail("B1 max differs from the -cw0 pass-A max")
        if sr.shifts != bench_device.SHIFTS or not torch.equal(
                as_int16(dec.disks), as_int16(sr.disk_list)):
            fail(f"B1 disks (shifts {bench_device.SHIFTS}) differ from the "
                 f"-cw0 B3 disks (shifts {sr.shifts})")
        png = os.path.join(dec.out_dir, "decomp_shift=0_clahe.png")
        if not os.path.exists(png) or read_png(png).max() == 0:
            fail(f"{png} missing or empty")
        print("resident path: B1 mean, max and shift-10/0 disks equal the "
              "-cw0 pass A (the sum/max kernel) and B3 bit for bit",
              flush=True)

        # 5, the rows of B1 and B6 on the resident slab: S = 2 (shifts
        # [10, 0]) and the S = 7 sweep of the shoot-out, from the line fit
        lf = dec.linefit
        F, ih, iw = dec.frames.shape
        a = (dec.frames, dec.ind_l, dec.left_w)
        ind7, w7 = build_shift_indices(lf.floor, lf.frac, SWEEP, iw)
        a7 = (dec.frames, torch.from_numpy(ind7).cuda(),
              torch.from_numpy(w7).cuda())
        step_bytes = (dec.frames.nbytes + dec.ind_l.nbytes
                      + dec.left_w.nbytes + 2 * ih * iw * 4 + 2 * ih * F * 2)
        W = onehot_weights(dec.ind_l, dec.left_w, iw)
        X = widen(dec.frames).to(torch.float32).permute(1, 2, 0)
        # library yardstick of the disks: one float32 bmm of the one-hot
        # weights with a float32 copy of the slab made beforehand
        bmm_ms = cuda_ms(lambda: torch.bmm(W, X), reps)
        del W, X

        err = max(max_abs_err(x, y) for x, y in zip(
            fused_cuda.shg_fused(*a), fused_cuda.shg_fused_plain(*a)))
        ms = cuda_ms(lambda: fused_cuda.shg_fused(*a), reps)
        pms = cuda_ms(lambda: fused_cuda.shg_fused_plain(*a), reps)
        records.append(dict(
            name="shg_fused", kernel="shg_fused",
            launches=launches6["shg_fused"], err=err, ms=ms, plain_ms=pms,
            library_ms=bmm_ms,
            bound=bound(step_bytes, {"int32": 2 * F * ih * iw,
                                     "f32": 3 * 2 * ih * F}),
            note=f"frames {tuple(dec.frames.shape)}, S=2"))
        ms7 = cuda_ms(lambda: fused_cuda.shg_fused(*a7), reps)

        def rate_lines(tag, fn, times, ops):
            """Wrapper and queued device time of a fused step at S = 2 and
            7, with its read rate and share of its bound."""
            for (S, t_ms), args in zip(times, (a, a7)):
                nb = step_bytes + (S - 2) * (ih * F * 2 + ih * 4)
                bms = bound(nb, ops(S, args))[0]
                dms = device_ms(lambda: fn(*args), reps)
                print(f"{tag} S={S}: wrapper {t_ms:.4f} ms, device "
                      f"{dms:.4f} ms, {nb / dms / 1e9:.3f} TB/s, "
                      f"{100 * bms / dms:.1f}% of its {bms:.4f} ms bound "
                      f"[{card}]", flush=True)

        rate_lines("B1", fused_cuda.shg_fused, ((2, ms), (len(SWEEP), ms7)),
                   lambda S, args: {"int32": 2 * F * ih * iw,
                                    "f32": 3 * S * ih * F})
        # the card's read-rate yardstick: one reduction over the same slab
        whole = dec.frames.view(torch.int32)
        amax_ms = cuda_ms(lambda: torch.amax(whole), reps)
        print(f"read-rate yardstick: torch.amax over the slab as int32 "
              f"{amax_ms:.4f} ms, {dec.frames.nbytes / amax_ms / 1e6:.1f} "
              f"GB/s [{card}]", flush=True)
        del whole

        b1 = fused_cuda.shg_fused(*a)
        b6 = fused_cuda.shg_fused_mxu(*a)
        err = max(max_abs_err(x, y) for args in (a, a7) for x, y in zip(
            fused_cuda.shg_fused_mxu(*args),
            fused_cuda.shg_fused_mxu_plain(*args)))
        if not (torch.equal(b6[0], b1[0]) and torch.equal(b6[1], b1[1])):
            fail("B6 mean or max differs from B1's")
        d = (widen(b6[2]) - widen(b1[2])).abs()
        if d.max().item() > 1:
            fail(f"B6 disks differ from B1's by {d.max().item()} LSB")
        zi = bench_device.SHIFTS.index(0)
        lsb = (widen(b6[2][zi]) - float64_lerp(
            dec.frames, lf.floor, lf.frac)).abs().max().item()
        if lsb > 1:
            fail(f"B6 shift-0 disk differs from the float64 lerp by {lsb} LSB")
        print(f"B6 vs B1 (S=2): mean and max equal, disks max "
              f"{d.max().item()} LSB on {100 * (d > 0).float().mean().item():.4f}"
              f"% of pixels; B6 shift-0 disk vs float64 lerp: {lsb} LSB",
              flush=True)
        del b1, b6, d
        ms = cuda_ms(lambda: fused_cuda.shg_fused_mxu(*a), reps)
        pms = cuda_ms(lambda: fused_cuda.shg_fused_mxu_plain(*a), reps)
        records.append(dict(
            name="shg_fused_mxu", kernel="shg_fused_mxu",
            launches=None,              # the shoot-out's, read in phase 7
            err=err, ms=ms, plain_ms=pms, library_ms=bmm_ms,
            bound=bound(step_bytes, {
                "int32": 2 * F * ih * iw,
                "f64_tensor": 512 * -(-F // 8) * mxu_chunks(dec.ind_l, iw)}),
            note=f"frames {tuple(dec.frames.shape)}, S=2; bit-identical "
                 f"at S=2 and S={len(SWEEP)}"))
        ms7 = cuda_ms(lambda: fused_cuda.shg_fused_mxu(*a7), reps)
        rate_lines("B6", fused_cuda.shg_fused_mxu,
                   ((2, ms), (len(SWEEP), ms7)),
                   lambda S, args: {
                       "int32": 2 * F * ih * iw,
                       "f64_tensor": 512 * -(-F // 8) * mxu_chunks(args[1],
                                                                   iw)})
        print(f"B6 S={len(SWEEP)}: kernel {ms7:.4f} ms, B1 "
              f"{cuda_ms(lambda: fused_cuda.shg_fused(*a7), reps):.4f}"
              f" ms [{card}]", flush=True)
        for S in (2, len(SWEEP)):
            plan6 = fused_cuda.fused_mxu_plan_cuda(dec.frames, S)
            mirror6 = fused_cuda.fused_mxu_plan(dec.frames.data_ptr(), S, ih,
                                                iw)
            print(f"B6 launch geometry on the bench slab, S={S}: {plan6}",
                  flush=True)
            if {k: plan6[k] for k in mirror6} != mirror6:
                fail(f"B6's Python plan {mirror6} differs from the kernel "
                     f"library's {plan6}")
            if plan6["path"] != "bulk":
                fail("B6 would not take the bulk copy path on the bench slab")

        # pass A's kernel on the resident slab against the three-pass torch
        # route (int32 copy, sum, amax), with each route's peak memory
        def peak_gb(fn):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            return (torch.cuda.max_memory_allocated() - base) / 1e9

        overall_peak = torch.cuda.max_memory_allocated()
        err = max(max_abs_err(x, y) for x, y in zip(
            fused_cuda.mean_max(dec.frames),
            fused_cuda.mean_max_plain(dec.frames)))
        ms = cuda_ms(lambda: fused_cuda.mean_max(dec.frames), reps)
        pms = cuda_ms(lambda: fused_cuda.mean_max_plain(dec.frames), reps)
        acc_s = torch.zeros((ih, iw), dtype=torch.int32, device="cuda")
        acc_m = torch.zeros_like(acc_s)
        dms = device_ms(
            lambda: fused_cuda.sum_max(dec.frames, acc_s, acc_m), 10)
        bA = bound(dec.frames.nbytes + 2 * ih * iw * 4,
                   {"int32": 2 * F * ih * iw})
        k_gb = peak_gb(lambda: fused_cuda.mean_max(dec.frames))
        p_gb = peak_gb(lambda: fused_cuda.mean_max_plain(dec.frames))
        overall_peak = max(overall_peak, torch.cuda.max_memory_allocated())
        records.append(dict(
            name="sum_max_resident", kernel="sum_max",
            launches=launches6["sum_max"], err=err, ms=ms, plain_ms=pms,
            library_ms=None, bound=bA,
            note=f"frames {tuple(dec.frames.shape)}; device {dms:.4f} ms, "
                 f"{dec.frames.nbytes / dms / 1e9:.3f} TB/s, "
                 f"{100 * bA[0] / dms:.1f}% of bound; read-rate yardstick "
                 f"torch.amax {amax_ms:.4f} ms; plain is the three-pass "
                 f"torch route (no one PyTorch call gives both results); "
                 f"memory above the slab: kernel route {k_gb:.3f} GB, "
                 f"three-pass route {p_gb:.3f} GB"))
        del acc_s, acc_m

        # information: fused step vs the two-pass route, by shift count
        for S in (2, 7, 21):
            ind_l, left_w = build_shift_indices(
                lf.floor, lf.frac, list(range(-(S // 2), S - S // 2)), iw)
            b = (dec.frames, torch.from_numpy(ind_l).cuda(),
                 torch.from_numpy(left_w).cuda())
            diff = max(max_abs_err(x, y) for x, y in zip(
                fused_cuda.shg_fused(*b), shg_forward_plain(*b)))
            fms = cuda_ms(lambda: fused_cuda.shg_fused(*b), reps)
            kms = cuda_ms(lambda: (fused_cuda.mean_max(b[0]),
                                   recon(*b, False, False)), reps)
            tms = cuda_ms(lambda: shg_forward_plain(*b), reps)
            print(f"fused vs two-pass S={S}: B1 {fms:.4f} ms, sum/max "
                  f"kernel + B3 {kms:.4f} ms (three-pass torch sum/max + "
                  f"B3 {tms:.4f} ms), max_abs_err {diff} [{card}]",
                  flush=True)
        del dec, a, a7, b
        overall_peak = max(overall_peak, torch.cuda.max_memory_allocated())
        print(f"peak device memory: {overall_peak / 1e9:.3f} GB "
              f"[{card}]", flush=True)

        # 7. the kernel shoot-out at full size, through its entry point
        from solex_ser_recon_en_torch import bench_kernels

        torch.cuda.empty_cache()
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0
        rows = bench_kernels.run(device=torch.device("cuda"),
                                 out=lambda line: print(f"{line} [{card}]",
                                                        flush=True))
        torch.cuda.synchronize()
        launches7 = dict(cuda_build.LAUNCHES)
        print(f"launches in the shoot-out: {launches7}", flush=True)
        print("shoot-out: " + json.dumps(rows), flush=True)
        for name in SHOOTOUT_KERNELS:
            if launches7[name] <= 0:
                fail(f"kernel {name} was not launched by the shoot-out")

        # 8. the other product modes of one scan
        torch.cuda.empty_cache()
        records += modes_phase(path, tmp, png4, card, torch.device("cuda"),
                               n_chunks)

        # 9. the session driver: a folder of scans, AVI input, the
        # small-scan group, the process split, --profile
        torch.cuda.empty_cache()
        from solex_ser_recon_en_torch.io.ser import SerReader

        raw = SerReader(path).raw_frames()           # stored wide, u16
        frames8 = np.empty(raw.shape, np.uint8)
        for i in range(0, FRAMES, 100):
            frames8[i:i + 100] = raw[i:i + 100] >> 8
        del raw
        records += session_phase(path, tmp, png4, card, torch.device("cuda"),
                                 frames8)
        del frames8

        # 10. the band and host feeds of read_scan
        torch.cuda.empty_cache()
        recs, hrecs = feeds_phase(path, tmp, png4, card,
                                  torch.device("cuda"), res, wall2)
        records += recs
        host_records += hrecs

        # 11. the other entry points: shg-torch-analyse, shg-torch-clahe,
        # python -m
        torch.cuda.empty_cache()
        records += analyser_phase(path, tmp, png4, card,
                                  torch.device("cuda"), res)

        # 12. the device mesh; phase 4's resident chunks go first (phase 5
        # held them in caps, rc_args and its loop's ``chunks``)
        import gc
        import weakref

        held = [weakref.ref(c) for c in rc_args[0][0]]
        caps["recon"].clear()
        del rc_args, chunks
        gc.collect()
        torch.cuda.empty_cache()
        if any(r() is not None for r in held):
            fail("phase 4's resident chunks are still referenced before "
                 "phase 12")
        records += mesh_phase(path, tmp, png4, card, torch.device("cuda"),
                              res, wall2)

        # 13. -d's live view and product display, and the GUI
        torch.cuda.empty_cache()
        records += display_gui_phase(path, tmp, png4, card,
                                     torch.device("cuda"), res, wall2,
                                     n_chunks)

        # 14. golden: phase 4's results against the reference replica
        golden_phase(path, tmp, png4, card, res, wall2, scan)
        print(f"chip_smoke: phases 1-14 took "
              f"{time.perf_counter() - t_start:.1f} s [{card}]", flush=True)

        for r in records:
            if r["err"] != 0:
                fail(f"kernel {r['name']} differs from its plain version "
                     f"by {r['err']}")

        # each entry's launches are those of the path whose inputs its times
        # were taken on: -cw0's run 2, the resident path, or (B6) the
        # shoot-out; pass A has an entry for each of its two user paths
        kernels = []
        for r in records:
            name = r["name"]
            bms, by = r["bound"]
            print(f"{name}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
                  f"library {r['library_ms']} ms, max_abs_err {r['err']} "
                  f"({r['note']}) [{card}]", flush=True)
            src, rep = REPLACES[r["kernel"]]
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": rep,
                "launches": (launches7[r["kernel"]] if r["launches"] is None
                             else r["launches"]),
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
                "library_ms": r["library_ms"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"host_entry_points": host_records}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
