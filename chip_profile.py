#!/usr/bin/env python3
"""Device-time breakdown of one ``-cw0`` scan of the PyTorch port on one GPU.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_profile.py [trace.json]

It writes chip_smoke.py's bench scan (2000 x 2048 x 300, stored wide), runs
the CLI once to build the kernels and warm the allocator, then once more
under torch.profiler, and prints: that run's wall time (profiler on) and
its StageTimer stages, the device-busy time (the union of the kernel, copy
and memset intervals of the trace) with the card's idle share of the wall
time, the kernel launches, memsets and copies, the device time by kernel
or copy name and the compute's by the program range (``stage:``) that
launched it, and the launches and device time of kernels B3, B4 and B5
(``recon_chunks_kernel``, ``hresample_kernel``, ``hist_kernel``), of
the Canny's two (``gradient_kernel``, ``hysteresis_kernel``) and of the
product chain's five (csrc/products.cu), the ``products`` stage's card
time and launches, and the host side of the feed in
that run (io/feeder.py:FEED): the copy threads' busy time, what the
producer and the consumer each waited for, and the uploads' device time,
so that the idle share can be read against the side that waits.  It then
makes the same
scan resident and normalised (bench_device.resident_frames) and profiles
one warm call of the fused step (models/shg.py:shg_forward, kernel B1,
shifts [10, 0]) the same way, one of the same step on kernel B6
(``shg_fused(..., mxu=True)``) and one of pass A's sum/max kernel on the
same slab (ops/fused_cuda.py:mean_max).  Before those, the product
chain of the -cw0 run (pipeline/products.py:_products_core_gained, its
input captured in the warm-up run) is profiled twice: on the kernels, and
as the plain twin's torch ops on the card (the route before
csrc/products.cu), with its device time and launches each, and each
wrapper of the kernel path is timed alone.  The Chrome trace of the -cw0
run is copied to ``trace.json`` when a path is given.
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
#: csrc/hist.cu, csrc/canny.cu)
KERNEL_NAMES = {"B3": "recon_chunks_kernel", "B4": "hresample_kernel",
                "B5": "hist_kernel", "Canny gradients": "gradient_kernel",
                "Canny hysteresis": "hysteresis_kernel",
                "row gain": "row_gain_kernel",
                "CLAHE LUTs": "clahe_lut_kernel",
                "CLAHE blend": "clahe_blend_kernel",
                "stretch limits": "stretch_params_kernel",
                "stretches": "stretch_kernel"}


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def by_stage(trace_events, device_events) -> dict:
    """{innermost ``stage:`` range of the launching call: [launches, us]}
    of the kernels and memsets: each matched to its runtime call by the
    trace's correlation id, the call to its thread through the CPU event
    that shares its external id (the runtime calls of a thread other than
    the profiler's carry another thread id than its CPU events, on torch
    2.11), then to
    the shortest program range around it on that thread ("(none)" outside
    every range)."""
    ranges = collections.defaultdict(list)
    thread_of = {}
    for e in trace_events:
        if e.get("cat") not in ("cpu_op", "user_annotation"):
            continue
        if "External id" in e.get("args", {}):
            thread_of[e["args"]["External id"]] = e.get("tid")
        if e["cat"] == "user_annotation" and e["name"].startswith("stage:"):
            ranges[e.get("tid")].append((e["ts"], e["ts"] + e["dur"],
                                         e["name"][len("stage:"):]))
    calls = {e["args"]["correlation"]: e for e in trace_events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    # a launch from native code (the ctypes kernels) has no CPU event: its
    # thread is the one its call's thread id maps to most often
    seen = collections.defaultdict(collections.Counter)
    for call in calls.values():
        cpu = thread_of.get(call["args"].get("External id"))
        if cpu is not None:
            seen[call.get("tid")][cpu] += 1
    remap = {t: c.most_common(1)[0][0] for t, c in seen.items()}
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in device_events:
        if e["cat"] == "gpu_memcpy":
            continue
        call = calls.get(e.get("args", {}).get("correlation"))
        name = "(none)"
        if call is not None:
            tid = thread_of.get(call["args"].get("External id"),
                                remap.get(call.get("tid"), call.get("tid")))
            around = [r for r in ranges[tid] if r[0] <= call["ts"] <= r[1]]
            if around:
                name = min(around, key=lambda r: r[1] - r[0])[2]
        out[name][0] += 1
        out[name][1] += e["dur"]
    return out


def report(prof, trace: str, wall_ms: float, label: str, card: str) -> None:
    """Print the device-busy time, idle share and device time by name of a
    finished profile (its Chrome trace written to ``trace``), and the
    compute's launches and device time by the program range that launched
    them."""
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        trace_events = json.load(f)["traceEvents"]
    events = [e for e in trace_events if e.get("cat") in DEVICE_CATS]
    if not events:
        chip_smoke.fail(f"{label}: the profiler recorded no device activity")
    busy_ms = busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    cats = collections.Counter(e["cat"] for e in events)
    print(f"{label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%; kernel launches "
          f"{cats['kernel']}, memsets {cats['gpu_memset']}, copies "
          f"{cats['gpu_memcpy']} [{card}]")
    print("device time by name (us, launches):")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us:10.1f} {n:5d}  {name[:100]}")
    print("kernels and memsets by launching range (us, launches):")
    stages = by_stage(trace_events, events)
    for name, (n, us) in sorted(stages.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us:10.1f} {n:5d}  {name}")
    if "products" in stages:
        n, us = stages["products"]
        print(f"{label}: products stage {us:.1f} us of card time in {n} "
              f"launches [{card}]")
    return by_name


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    card = chip_smoke.card_line()
    sys.path.insert(0, chip_smoke.ROOT)
    from solex_ser_recon_en_torch.cli import main as cli_main

    from solex_ser_recon_en_torch.pipeline import products

    tmp = tempfile.mkdtemp(prefix="solex_profile_")
    try:
        path = os.path.join(tmp, "scan.ser")
        chip_smoke.make_scan(path)
        args = ["-cw0", path, "--output-dir", os.path.join(tmp, "out")]
        chain = {}
        core = products._products_core_gained

        def capture(fj, gain, want=(True, True)):
            chain["args"] = (fj.clone(), gain.clone(), want)
            return core(fj, gain, want)

        products._products_core_gained = capture
        try:
            if cli_main.main(args) != 0:
                chip_smoke.fail("warm-up run failed")
        finally:
            products._products_core_gained = core
        for k in products.PRODUCTS_LAUNCHES:
            products.PRODUCTS_LAUNCHES[k] = 0
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        # every thread: the CLI post-processes on a pool thread, whose
        # ranges and launches the profiler drops otherwise
        every_thread = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
        with torch.profiler.profile(activities=acts,
                                    experimental_config=every_thread) as prof:
            t0 = time.perf_counter()
            rc = cli_main.main(args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if rc != 0:
            chip_smoke.fail("profiled run failed")
        trace = os.path.join(tmp, "trace.json")
        by_name = report(prof, trace, wall_ms, "profiled run", card)
        print(f"product chain calls in the profiled run: "
              f"{products.PRODUCTS_LAUNCHES}", flush=True)
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
              f"(closing the reader, after the last chunk, "
              f"{1e3 * FEED['close_s']:.1f} ms); the rest of its wall "
              f"{1e3 * (FEED['wall_s'] - FEED['consumer_wait_s'] - FEED['upload_wait_s']):.1f}"
              f" ms (its own CUDA calls, the closing, the caller's work "
              f"between chunks); "
              f"uploads {FEED['h2d_ms']:.1f} ms on the card [{card}]")
        for kid, kernel in KERNEL_NAMES.items():
            hits = [v for k, v in by_name.items() if kernel in k]
            if not hits:
                chip_smoke.fail(f"{kid} ({kernel}) is not in the profile")
            print(f"{kid} ({kernel}): {sum(n for n, _ in hits)} launches, "
                  f"device {sum(us for _, us in hits) / 1e3:.4f} ms [{card}]")
        if argv:
            shutil.copy(trace, argv[0])

        # the -cw0 run's product chain alone: the kernels, then the plain
        # twin's torch ops on the card
        from solex_ser_recon_en_torch.ops.rowstats import (
            _apply_row_gain_plain,
        )

        fj, gain, want = chain["args"]

        def plain(fj, gain, want):
            detrans = _apply_row_gain_plain(fj, gain)
            return (detrans,) + products._products_body_plain(detrans, want)

        for label, fn in (("kernels", core), ("plain twin", plain)):
            fn(fj, gain, want)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                fn(fj, gain, want)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            report(prof, trace, wall_ms, f"product chain on the "
                   f"{tuple(fj.shape)} product, want {want}, {label}", card)

        # each wrapper of the kernel path alone, CUDA events (median of 20)
        from solex_ser_recon_en_torch.ops import clahe, rowstats

        h, w = fj.shape
        _, _, _, clip, scale = clahe._clahe_plan(h, w, 0.8, 2, 2, 65536)
        detrans = core(fj, gain, want)[0]
        hist = clahe.image_tile_histograms(detrans, 2, 2, 65536)
        luts, _ = clahe._launch_clahe_lut(hist, clip, scale, False)
        cl1 = clahe._launch_clahe_blend(detrans, luts, 2, 2)
        hist_c = clahe.value_histogram(cl1, 65536)
        steps = {
            "row gain": lambda: rowstats.apply_row_gain(fj, gain),
            "B5 (2 x 2 tiles)": lambda: clahe.image_tile_histograms(
                detrans, 2, 2, 65536),
            "CLAHE LUTs": lambda: clahe._launch_clahe_lut(hist, clip, scale,
                                                          False),
            "CLAHE blend": lambda: clahe._launch_clahe_blend(detrans, luts,
                                                             2, 2),
            "stretch limits + stretches": lambda: products._launch_stretches(
                cl1, hist_c, detrans, None, (False, False)),
            "the chain": lambda: core(fj, gain, want),
            "the plain twin": lambda: plain(fj, gain, want),
        }
        for name, fn in steps.items():
            print(f"wrapper {name}: {chip_smoke.cuda_ms(fn, 20):.4f} ms "
                  f"[{card}]", flush=True)

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
