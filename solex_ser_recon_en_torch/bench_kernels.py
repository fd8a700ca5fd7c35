"""Device-kernel shoot-out on synthetic data resident on the device.

Counterpart of the device half of the JAX package's benchmarks/kernels.py
(``main`` without ``--host``): the same rows in the same order at the same
default shapes — the fused step and its alternatives at S = 2 (shifts
[10, 0]) and at the S = 7 Doppler sweep ``range(-10, 11, 3)`` on a
(frames, ih, iw) u16 slab, the recon alone, then CLAHE, the product core
and the warps on an (ih + 26, frames + 100) u16 image.

Where the JAX script has two rows for one kernel of this package, one row
is printed: its "VPU" and "VPU windowed" rows are the two bodies of
``_shg_fused`` (the TPU's 128-lane window only drops exact zero mask
terms), and both are kernel B1 here, which gathers its two taps and needs
no window.  Its "packed-pair u16" warps pack two u16 taps into one gather
for the TPU; this package's u16 warp is the four-term path of ops/warp.py,
so those rows time that path.  The "torch step" rows
(models/shg.py:shg_forward_onehot) run PyTorch's own kernels only, torch
reductions and a float32 matmul: they are the library route the fused
steps are set against, so no hand-written kernel runs in them.

Data is made on the device from a seeded ``torch.Generator``; each row is
timed with CUDA events around the call (median of ``--reps`` after one
warm call), so the numbers are device-side times of whole calls.  No row
catches an exception: a failing kernel stops the run.

    python -m solex_ser_recon_en_torch.bench_kernels [--frames 2000]
        [--ih 2048] [--iw 300] [--reps 10] [--device cpu]

prints one line per row (tag, ms, frames/s) and then every row as one JSON
line.  Without ``--device cpu`` CUDA is required; ``--device cpu`` runs the
plain versions (at any size, on the host clock).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .geometry.ellipse import get_correction_matrix
from .models.shg import shg_forward_onehot
from .ops.clahe import _clahe
from .ops.fused_cuda import shg_fused
from .ops.recon import build_shift_indices, recon_onehot
from .ops.recon_cuda import recon
from .ops.warp import warp_projective, warp_projective_u16, warp_to_u16
from .ops.warp_fast import warp_unit_y_u16
from .pipeline.products import _products_core_gained
from .utils.device import resolve_device, synchronize

SWEEP = list(range(-10, 11, 3))          # S = 7
SEED = 0


def time_ms(fn: Callable[[], object], reps: int,
            device: torch.device) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls after one warm
    call: CUDA events on the card, the host clock on the CPU."""
    fn()
    synchronize(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _indices(iw: int, ih: int, shifts, device: torch.device):
    """The JAX script's gently sloped line (kernels.py:132-134)."""
    curve = iw / 2 + 0.001 * np.arange(ih)
    fl = np.floor(curve)
    ind_l, left_w = build_shift_indices(fl, curve - fl, shifts, iw)
    return (torch.from_numpy(ind_l).to(device),
            torch.from_numpy(left_w).to(device))


def run(frames: int = 2000, ih: int = 2048, iw: int = 300, reps: int = 10,
        device: torch.device = torch.device("cuda"),
        out: Callable[[str], None] = print) -> List[dict]:
    """Time every row; ``out`` receives one line per row.  Returns the rows
    as dicts (tag, ms, frames_per_s)."""
    F = frames
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    out(f"device={device.type}  slab=({F}, {ih}, {iw}) u16 "
        f"{F * ih * iw * 2 / 1e9:.3f} GB")
    slab = torch.randint(-32768, 32768, (F, ih, iw), generator=g,
                         dtype=torch.int16, device=device).view(torch.uint16)
    rows: List[dict] = []

    def bench(tag: str, fn: Callable[[], object]) -> None:
        ms = time_ms(fn, reps, device)
        rows.append({"tag": tag, "ms": ms, "frames_per_s": F / ms * 1e3})
        out(f"{tag:48s} {ms:10.4f} ms {F / ms * 1e3:12.0f} frames/s")

    ind2, w2 = _indices(iw, ih, [10, 0], device)
    bench("fused step B1 (mean+max+recon, S=2)",
          lambda: shg_fused(slab, ind2, w2))
    bench("fused step B6 tensor cores (mean+max+recon, S=2)",
          lambda: shg_fused(slab, ind2, w2, mxu=True))
    bench("torch step (reductions + one-hot matmul)",
          lambda: shg_forward_onehot(slab, ind2, w2))

    # large Doppler sweep
    S = len(SWEEP)
    ind7, w7 = _indices(iw, ih, SWEEP, device)
    bench(f"fused step B1 (S={S})", lambda: shg_fused(slab, ind7, w7))
    bench(f"fused step B6 tensor cores (S={S})",
          lambda: shg_fused(slab, ind7, w7, mxu=True))
    bench(f"torch step (S={S})", lambda: shg_forward_onehot(slab, ind7, w7))
    bench("recon only: one-hot matmul",
          lambda: recon_onehot(slab, ind2, w2))
    bench("recon only: two-tap gather (kernel B3)",
          lambda: recon(slab, ind2, w2, False, False))
    del slab

    # post-processing kernels on a warped-disk-sized image
    H, W = ih + 26, F + 100
    img = torch.randint(0, 60000, (H, W), generator=g, dtype=torch.int32,
                        device=device).to(torch.uint16)
    gain = torch.ones((H,), dtype=torch.float32, device=device)
    mat3 = np.array([[0.99, 0.02, -3.0], [0.015, 1.04, -8.0], [0, 0, 1.0]])
    imgf = img.to(torch.int32).to(torch.float32) / 65536.0

    bench(f"CLAHE 2x2 u16 ({H}x{W})",
          lambda: _clahe(img, 0.8, 2, 2, 65536))
    bench("fused product core (gain+CLAHE+stretches)",
          lambda: _products_core_gained(img, gain))
    bench("warp: float 4-tap gathers",
          lambda: warp_to_u16(warp_projective(imgf, mat3, H, W, cval=0.1)))
    bench("warp: u16 four-term (general path)",
          lambda: warp_to_u16(warp_projective_u16(img, mat3, H, W, 0.1)))

    # pipeline-shaped correction matrix (second row [0, 1, ty]): the
    # separable kernel vs the same matrix through the general warp
    corr, _ = get_correction_matrix(0.15, 0.93)
    m3u = np.zeros((3, 3))
    m3u[:2, :2] = corr
    m3u[2, 2] = 1.0
    m3u = m3u @ np.array([[1, 0, -13.4], [0, 1, 7.3], [0, 0, 1.0]])
    cval = torch.full((1,), 0.1, dtype=torch.float32, device=device)
    bench("warp: u16 four-term, unit-y matrix",
          lambda: warp_to_u16(warp_projective_u16(img, m3u, H, W, 0.1)))
    bench("warp: separable kernel B4, unit-y matrix",
          lambda: warp_to_u16(warp_unit_y_u16(img, m3u, H, W, cval=cval)))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m solex_ser_recon_en_torch.bench_kernels",
        description="Device-kernel shoot-out (one line per row, then one "
                    "JSON line).")
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--ih", type=int, default=2048)
    ap.add_argument("--iw", type=int, default=300)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = run(args.frames, args.ih, args.iw, args.reps, device)
    print(json.dumps({
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "shape": [args.frames, args.ih, args.iw], "reps": args.reps,
        "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
