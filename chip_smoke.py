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

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and the one before that the
per-kernel JSON record (the host library's entry points have a JSON line
of their own before it, ``host_entry_points``): each entry's launches are those of the path whose
inputs its times were taken on, and pass A has two entries, ``sum_max``
(the -cw0 path's raw chunks) and ``sum_max_resident`` (the slab).  The
script imports nothing of JAX.
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
    for (s_new, c_new), (s_plain, c_plain) in zip(new, plain, strict=True):
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


def main() -> int:
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
