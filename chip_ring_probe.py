#!/usr/bin/env python3
"""Ring-shape probe of kernel B6 and of pass A's sum/max kernel on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_ring_probe.py

The two kernels choose their shared-memory ring from a few constants of
their launch plans (csrc/plans.cuh, namespace fused_mxu: the rows a block
owns, the stage and ring sizes; namespace sum_max: the 16-byte chunks a
thread owns, the ring size) and the blocks an SM that the
``__launch_bounds__`` of their sources (csrc/fused_mxu.cu, csrc/sum_max.cu)
ask for.  This script shows what those constants were chosen from: it
copies the plans and each source with the constants of one variant written
over the committed ones, builds every copy into a library of its own (one
nvcc each, all started together, in a temporary directory), and times each
variant on the shoot-out's slab (2000 x 2048 x 300 random u16 on the card):
the mean device time of calls queued behind a sleep kernel, B6 at S = 2, 7
and 21.
Every variant's outputs must equal the committed kernel's bit for bit.
The variant marked ``committed`` leaves the constants as they are.

It prints one line per variant with the launch geometry the library
reports, the card's name and power limit, and all rows as one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import sys
import tempfile

import chip_smoke

F, IH, IW = chip_smoke.FRAMES, chip_smoke.IH, chip_smoke.IW
REPS = 10

#: B6: (label, rows a block owns, stages D, blocks an SM asked for)
B6_VARIANTS = [("committed", None, None, None),
               (None, 2, 5, 3), (None, 2, 8, 1),
               (None, 4, 2, 3), (None, 4, 2, 4), (None, 4, 3, 3),
               (None, 4, 4, 2), (None, 4, 5, 2), (None, 4, 6, 1),
               (None, 6, 2, 3), (None, 6, 3, 2),
               (None, 8, 2, 2), (None, 8, 5, 1)]
#: pass A: (label, chunks a thread owns, ring KB, blocks an SM asked for)
PASS_A_VARIANTS = [("committed", None, None, None),
                   (None, 2, 48, 4), (None, 2, 72, 3), (None, 3, 48, 4),
                   (None, 3, 72, 3), (None, 3, 100, 2), (None, 4, 72, 2),
                   (None, 4, 100, 2), (None, 4, 130, 1)]


def with_constants(plans: str, text: str, kernel: str, constants: dict,
                   blocks):
    """(plans.cuh with each ``constexpr ... name = ...;`` of ``constants``
    rewritten in the kernel's namespace, the kernel's source with the
    blocks an SM of its ``__launch_bounds__`` rewritten); a name that is
    not there exactly once is an error."""
    head, start, rest = plans.partition(f"\nnamespace {kernel} {{\n")
    body, end, tail = rest.partition(f"\n}}  // namespace {kernel}\n")
    for name, value in constants.items():
        body, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                          rf"\g<1>{value};", body)
        if n != 1:
            chip_smoke.fail(f"constant {name} found {n} times")
    plans = head + start + body + end + tail
    if blocks is not None:
        text, n = re.subn(r"__launch_bounds__\(kThreads, \d+\)",
                          f"__launch_bounds__(kThreads, {blocks})", text)
        if n != 1:
            chip_smoke.fail(f"__launch_bounds__ found {n} times")
    return plans, text


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    card = chip_smoke.card_line()
    sys.path.insert(0, chip_smoke.ROOT)
    from solex_ser_recon_en_torch import bench_kernels
    from solex_ser_recon_en_torch.ops import cuda_build, fused_cuda

    variants = []        # (kernel, label, source name, constants, blocks)
    for label, yb, D, blocks in B6_VARIANTS:
        consts = {} if yb is None else {
            "kMaxRows": yb, "kStageTarget": "48 * 1024",
            "kRingTarget": D * 8 * fused_cuda.mxu_frame_stride(yb * IW)}
        variants.append(("B6", label or f"yb={yb} D={D} asked {blocks}/SM",
                         "fused_mxu.cu", consts, blocks))
    for label, chunks, ring_kb, blocks in PASS_A_VARIANTS:
        consts = {} if chunks is None else {
            "kChunks": chunks, "kRingTarget": f"{ring_kb} * 1024"}
        variants.append(("pass A", label or f"chunks={chunks} ring={ring_kb}"
                         f" KB asked {blocks}/SM", "sum_max.cu", consts,
                         blocks))

    tmp = tempfile.mkdtemp(prefix="solex_ring_probe_")
    try:
        cmds, libs = [], []
        for i, (_, _, src, consts, blocks) in enumerate(variants):
            d = f"{tmp}/{i}"
            shutil.copytree(cuda_build.CSRC, d)
            plans, text = with_constants(
                (cuda_build.CSRC / "plans.cuh").read_text(),
                (cuda_build.CSRC / src).read_text(), src[:-3], consts,
                blocks)
            with open(f"{d}/plans.cuh", "w") as f:
                f.write(plans)
            with open(f"{d}/{src}", "w") as f:
                f.write(text)
            libs.append(f"{d}/probe.so")
            cmds.append([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                         "-shared", "-o", libs[-1], f"{d}/{src}"])
        cuda_build._run_all(cmds, [])

        g = torch.Generator(device="cuda")
        g.manual_seed(bench_kernels.SEED)
        slab = torch.randint(-32768, 32768, (F, IH, IW), generator=g,
                             dtype=torch.int16,
                             device="cuda").view(torch.uint16)
        dev = slab.device
        steps = {S: bench_kernels._indices(IW, IH, shifts, dev)
                 for S, shifts in ((2, [10, 0]), (7, bench_kernels.SWEEP),
                                   (21, list(range(-10, 11))))}
        want6 = {S: fused_cuda.shg_fused_mxu(slab, *a)
                 for S, a in steps.items()}
        wantA = fused_cuda.mean_max(slab)
        stream = cuda_build.stream_handle(dev)
        total = torch.empty((IH, IW), dtype=torch.int32, device=dev)
        mx = torch.empty_like(total)
        rows = []
        for (kernel, label, _, _, _), path in zip(variants, libs):
            lib = ctypes.CDLL(path)
            row = {"kernel": kernel, "variant": label}
            if kernel == "B6":
                lib.solex_shg_fused_mxu.argtypes = cuda_build._SIGNATURES[
                    "solex_shg_fused_mxu"]
                for S, (ind_l, left_w) in steps.items():
                    disks = torch.empty((S, IH, F), dtype=torch.uint16,
                                        device=dev)

                    def call():
                        cuda_build.check(lib.solex_shg_fused_mxu(
                            slab.data_ptr(), ind_l.data_ptr(),
                            left_w.data_ptr(), total.data_ptr(),
                            mx.data_ptr(), disks.data_ptr(), S, F, IH, IW,
                            stream), "shg_fused_mxu")

                    row[f"S={S} ms"] = chip_smoke.device_ms(call, REPS)
                    got = (fused_cuda.to_u16(total // F),
                           fused_cuda.to_u16(mx), disks)
                    if not all(torch.equal(x, y)
                               for x, y in zip(got, want6[S])):
                        chip_smoke.fail(f"B6 {label}: S={S} differs from "
                                        "the committed kernel")
                plan = (ctypes.c_int * 10)()
                cuda_build.check(lib.solex_shg_fused_mxu_plan(
                    ctypes.c_void_p(slab.data_ptr()), 2, F, IH, IW, plan),
                    "shg_fused_mxu_plan")
                row.update(yb=plan[1], D=plan[2], smem=plan[5],
                           blocks_per_sm=plan[6], grid=[plan[7], plan[8]])
            else:
                lib.solex_sum_max.argtypes = cuda_build._SIGNATURES[
                    "solex_sum_max"]

                def call():
                    cuda_build.check(lib.solex_sum_max(
                        slab.data_ptr(), 2, total.data_ptr(), mx.data_ptr(),
                        F, IH * IW, stream, None), "sum_max")

                lib.solex_sum_max_plan.argtypes = cuda_build._SIGNATURES[
                    "solex_sum_max_plan"]
                plan = (ctypes.c_longlong * 12)()
                cuda_build.check(lib.solex_sum_max_plan(
                    slab.data_ptr(), 2, F, IH * IW, plan), "sum_max_plan")
                row.update(plan="owned" if plan[0] else "split", K=plan[2],
                           D=plan[3], smem=plan[6], blocks_per_sm=plan[7],
                           grid=[plan[9], plan[10]])

                row["ms"] = chip_smoke.device_ms(call, REPS)
                total.zero_()
                mx.zero_()
                call()
                got = (fused_cuda.to_u16(total // F), fused_cuda.to_u16(mx))
                if not all(torch.equal(x, y) for x, y in zip(got, wantA)):
                    chip_smoke.fail(f"pass A {label} differs from the "
                                    "committed kernel")
            rows.append(row)
            print(json.dumps(row) + f" [{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card)
    print(json.dumps({"shape": [F, IH, IW], "reps": REPS, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
