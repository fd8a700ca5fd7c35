#!/usr/bin/env python3
"""Device-time breakdown of one ``-cw0`` scan of the PyTorch port on one GPU.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_profile.py [trace.json]

It writes chip_smoke.py's bench scan (2000 x 2048 x 300, stored wide), runs
the CLI once to build the kernels and warm the allocator, then once more
under torch.profiler, and prints: that run's wall time (profiler on) and
its StageTimer stages, the device-busy time (the union of the kernel, copy
and memset intervals of the trace) with the card's idle share of the wall
time, the device time by kernel or copy name, and the launches and device
time of kernels B3, B4 and B5 (``recon_chunks_kernel``,
``hresample_kernel``, ``hist_kernel``), and the host side of the feed in
that run (io/feeder.py:FEED): the copy threads' busy time, what the
producer and the consumer each waited for, and the uploads' device time,
so that the idle share can be read against the side that waits.  It then
makes the same
scan resident and normalised (bench_device.resident_frames) and profiles
one warm call of the fused step (models/shg.py:shg_forward, kernel B1,
shifts [10, 0]) the same way, one of the same step on kernel B6
(``shg_fused(..., mxu=True)``) and one of pass A's sum/max kernel on the
same slab (ops/fused_cuda.py:mean_max).  The Chrome trace of the -cw0 run
is copied to ``trace.json`` when a path is given.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import sys
import tempfile
import time

import chip_smoke

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the kernels of the -cw0 run summed by name (csrc/recon.cu, csrc/warp.cu,
#: csrc/hist.cu)
KERNEL_NAMES = {"B3": "recon_chunks_kernel", "B4": "hresample_kernel",
                "B5": "hist_kernel"}


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def report(prof, trace: str, wall_ms: float, label: str, card: str) -> None:
    """Print the device-busy time, idle share and device time by name of a
    finished profile (its Chrome trace written to ``trace``)."""
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in DEVICE_CATS]
    if not events:
        chip_smoke.fail(f"{label}: the profiler recorded no device activity")
    busy_ms = busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    print(f"{label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}% [{card}]")
    print("device time by name (us, launches):")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us:10.1f} {n:5d}  {name[:100]}")
    return by_name


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    card = chip_smoke.card_line()
    sys.path.insert(0, chip_smoke.ROOT)
    from solex_ser_recon_en_torch.cli import main as cli_main

    tmp = tempfile.mkdtemp(prefix="solex_profile_")
    try:
        path = os.path.join(tmp, "scan.ser")
        chip_smoke.make_scan(path)
        args = ["-cw0", path, "--output-dir", os.path.join(tmp, "out")]
        if cli_main.main(args) != 0:
            chip_smoke.fail("warm-up run failed")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            rc = cli_main.main(args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if rc != 0:
            chip_smoke.fail("profiled run failed")
        trace = os.path.join(tmp, "trace.json")
        by_name = report(prof, trace, wall_ms, "profiled run", card)
        from solex_ser_recon_en_torch.io.feeder import FEED

        print(f"feed of the profiled run: wall {1e3 * FEED['wall_s']:.1f} ms "
              f"of the run's {wall_ms:.1f}; {FEED['threads']} copy threads "
              f"busy {1e3 * FEED['copy_thread_s']:.1f} ms in all "
              f"({1e3 * FEED['fill_s']:.1f} ms of the producer's wall, "
              f"{FEED['bytes'] / FEED['fill_s'] / 1e9:.2f} GB/s); producer "
              f"waited {1e3 * FEED['producer_wait_s']:.1f} ms for a free "
              f"buffer; consumer waited "
              f"{1e3 * FEED['consumer_wait_s']:.1f} ms for a filled buffer "
              f"and {1e3 * FEED['upload_wait_s']:.1f} ms for uploads "
              f"(closing the reader, inside the last wait, "
              f"{1e3 * FEED['close_s']:.1f} ms); the rest of its wall "
              f"{1e3 * (FEED['wall_s'] - FEED['consumer_wait_s'] - FEED['upload_wait_s']):.1f}"
              f" ms (its own CUDA calls, the caller's work between chunks); "
              f"uploads {FEED['h2d_ms']:.1f} ms on the card [{card}]")
        for kid, kernel in KERNEL_NAMES.items():
            hits = [v for k, v in by_name.items() if kernel in k]
            if not hits:
                chip_smoke.fail(f"{kid} ({kernel}) is not in the profile")
            print(f"{kid} ({kernel}): {sum(n for n, _ in hits)} launches, "
                  f"device {sum(us for _, us in hits) / 1e3:.4f} ms [{card}]")
        if argv:
            shutil.copy(trace, argv[0])

        import numpy as np

        from solex_ser_recon_en_torch import bench_device
        from solex_ser_recon_en_torch.io.ser import SerReader
        from solex_ser_recon_en_torch.models import shg_forward
        from solex_ser_recon_en_torch.ops.fused_cuda import (
            mean_max,
            shg_fused,
        )
        from solex_ser_recon_en_torch.ops.recon import build_shift_indices

        r = SerReader(path)
        frames, _ = bench_device.resident_frames(r, r.frame_count,
                                                 torch.device("cuda"))
        curve = r.iw / 2 + 0.001 * np.arange(r.ih)
        floor = np.floor(curve)
        ind_l, left_w = build_shift_indices(floor, curve - floor,
                                            bench_device.SHIFTS, r.iw)
        step = (frames, torch.from_numpy(ind_l).cuda(),
                torch.from_numpy(left_w).cuda())
        for label, fn in (("B1", shg_forward),
                          ("B6", lambda *x: shg_fused(*x, mxu=True)),
                          ("pass A", lambda *x: mean_max(x[0]))):
            fn(*step)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                fn(*step)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            report(prof, trace, wall_ms,
                   f"device step {label} {tuple(frames.shape)}", card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
