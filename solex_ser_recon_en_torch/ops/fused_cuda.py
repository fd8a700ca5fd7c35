"""The fused single-pass step on the card: wrappers of kernels B1
(csrc/fused.cu) and B6 (csrc/fused_mxu.cu), and of pass A's sum/max kernel
(csrc/sum_max.cu).

Counterpart of solex_ser_recon_en_tpu/ops/fused_pallas.py:shg_fused_pallas.
One read of the normalised frame slab gives the int32 frame sum, the frame
max and the multi-shift disks.  ``shg_fused`` runs B1, the counterpart of
the VPU kernels _kernel_win and _kernel (which are bit-identical; B1 folds
both): a two-tap gather-lerp in float32.  ``shg_fused(..., mxu=True)`` runs
B6, the counterpart of the MXU kernel _kernel_mxu: the disks as one
contraction over the spectral axis on the FP64 tensor cores.  A CUDA tensor
launches the kernel; a CPU tensor takes the plain version
(``shg_fused_plain``, ``shg_fused_mxu_plain``); any other device raises.

``sum_max`` and ``mean_max`` are pass A: the int32 frame sum and the frame
max of u8 or u16 frames in any layout, from one read of them (the ring and
the sum/max consumer that B1 and B6 use, with no shifts).  The JAX package
leaves these reductions to XLA (solex_ser_recon_en_tpu/ops/fused.py:33-34);
``mean_max`` also stands for its frames-in-memory reduction
(solex_ser_recon_en_tpu/ops/reduce.py), which the spectral analyser runs.

The three kernels' launch plans and their limits are written once, in
csrc/plans.cuh: the kernel library plans each launch with it on the card,
and the host library (io/native.py) builds the same code, through which
``sum_max_plan``, ``fused_plan``, ``fused_mxu_plan`` and ``PLAN_LIMITS``
answer without a card.  ``*_plan_cuda`` read the kernel library's plan at
the card's own block slots.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..io import native
from . import cuda_build
from .dtypes import as_int16, to_u16, widen
from .recon import recon_plain

#: int32 sum bound: 65535 * 32767 < 2**31 (ops/fused_pallas.py:21)
MAX_FRAMES = 32767
#: longer stacks spill the int32 sum into an int64 fold every 2**15 frames
#: (65535 * 2**15 < 2**31; solex_ser_recon_en_tpu/ops/reduce.py)
SPILL_FRAMES = 1 << 15

Step = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: the names of solex_plan_limits' values (csrc/plans.cpp), in its order
_LIMITS = ("threads", "max_smem", "bar_bytes", "max_stages", "split_frames",
           "sum_max_max_run", "sum_max_min_owned_run", "sum_max_owned_max_k",
           "b1_max_run", "b6_max_iw")


@functools.cache
def _plan_limits() -> dict:
    n, v = _host_plan("solex_plan_limits", len(_LIMITS), ctypes.c_longlong)
    if n != len(_LIMITS):
        raise RuntimeError(f"solex_plan_limits wrote {n} limits, not "
                           f"{len(_LIMITS)}")
    return dict(zip(_LIMITS, v))


def __getattr__(name: str):
    """``PLAN_LIMITS``: the limits of csrc/plans.cuh named in ``_LIMITS``,
    read from the host library at first use, so that importing this module
    builds nothing."""
    if name == "PLAN_LIMITS":
        return _plan_limits()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _host_plan(entry: str, n: int, ctype, *args):
    """(return code, out[n]) of a plan entry point of the host library
    (csrc/plans.cpp); a negative code is an argument the kernel library
    refuses."""
    out = (ctype * n)()
    rc = getattr(native.get_lib(), entry)(*args, out)
    if rc < 0:
        raise ValueError(f"{entry}{args}: an argument is out of range")
    return rc, list(out)


def _check(frames: torch.Tensor, ind_l: torch.Tensor,
           left_w: torch.Tensor, name: str = "shg_fused") -> None:
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {frames.device}")
    if frames.ndim != 3 or frames.dtype != torch.uint16:
        raise TypeError(f"{name}: frames must be (F, ih, iw) uint16, got "
                        f"{tuple(frames.shape)} {frames.dtype}")
    F, ih, iw = frames.shape
    if ind_l.ndim != 2 or ind_l.dtype != torch.int32 or ind_l.shape[1] != ih:
        raise TypeError(f"{name}: ind_l must be (S, {ih}) int32, got "
                        f"{tuple(ind_l.shape)} {ind_l.dtype}")
    if left_w.dtype != torch.float32 or tuple(left_w.shape) != (ih,):
        raise TypeError(f"{name}: left_w must be ({ih},) float32, got "
                        f"{tuple(left_w.shape)} {left_w.dtype}")
    for arg, t in (("frames", frames), ("ind_l", ind_l), ("left_w", left_w)):
        if t.device != frames.device or not t.is_contiguous():
            raise ValueError(
                f"{name}: {arg} must be contiguous on {frames.device}")
    S = ind_l.shape[0]
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"{name}: F={F} outside [1, {MAX_FRAMES}] "
                         "(the int32 frame sum would overflow)")
    if not 1 <= S <= 65535 or not 1 <= ih <= 65535 or iw < 2:
        raise ValueError(f"{name}: S={S}, ih={ih}, iw={iw} out of range")


def mean_max_plain(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (F, ih, iw) u16 -> (mean u16, max u16): int32 sum floor-divided
    by F (the reference's truncating mean), and the max."""
    v = widen(frames)
    total = v.sum(dim=0, dtype=torch.int32)
    return to_u16(total // frames.shape[0]), to_u16(v.amax(dim=0))


def sum_max_plain(frames: torch.Tensor, total: torch.Tensor,
                  mx: torch.Tensor) -> None:
    """Plain version of ``sum_max``: an int32 copy of the frames, its sum
    added to ``total`` and its amax folded into ``mx``."""
    v = widen(frames)
    total += v.sum(dim=0, dtype=torch.int32)
    torch.maximum(mx, v.amax(dim=0), out=mx)


def _sum_max_check(frames: torch.Tensor, name: str) -> None:
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {frames.device}")
    if frames.ndim != 3 or frames.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"{name}: frames must be (F, h, w) uint8 or uint16, "
                        f"got {tuple(frames.shape)} {frames.dtype}")
    if not frames.is_contiguous() or 0 in frames.shape:
        raise ValueError(f"{name}: frames must be contiguous and not empty")
    if frames.shape[0] > MAX_FRAMES:
        raise ValueError(f"{name}: F={frames.shape[0]} > {MAX_FRAMES} (the "
                         "int32 frame sum would overflow)")


#: pass A's launches by plan ("owned": every block owns a run of pixels
#: over all frames of the launch, plain merge; "split": runs over frame
#: splits, atomic merge), as the kernel library reports them; reset by
#: callers that count a run
SUM_MAX_PLANS = {"owned": 0, "split": 0}


def sum_max_plan(data_ptr: int, elem_bytes: int, F: int, npix: int,
                 sms: int, blocks_per_sm: int) -> dict:
    """Pass A's launch plan (csrc/plans.cuh, through the host library) for
    F frames of ``npix`` elements of ``elem_bytes`` at ``data_ptr`` on a
    card of ``sms`` SMs that holds ``blocks_per_sm`` blocks of the kernel
    at the split ring's shared memory: owned where every slot gets a run of
    ``PLAN_LIMITS["sum_max_min_owned_run"]`` bytes.  A dict: plan ("owned"
    or "split"), path ("bulk" or "element"), K frames a stage, D stages,
    base granules (16 bytes) of a block's run and rem runs that take one
    more, smem bytes a block, blocks across a frame, fper frames a block,
    grid.  The kernel library plans each launch itself; tests hold this to
    its plan (``sum_max_plan_cuda``)."""
    _, v = _host_plan("solex_sum_max_plan_host", 10, ctypes.c_longlong,
                      data_ptr, elem_bytes, F, npix, sms * blocks_per_sm)
    return dict(plan="owned" if v[0] else "split",
                path="bulk" if v[1] else "element", K=v[2], D=v[3],
                base=v[4], rem=v[5], smem=v[6], blocks=v[7], fper=v[9],
                grid=(v[7], v[8]))


def sum_max_plan_cuda(frames: torch.Tensor) -> dict:
    """The launch plan pass A's kernel would use on these CUDA frames (F, h,
    w), from the kernel library itself (csrc/sum_max.cu:
    solex_sum_max_plan): the keys of ``sum_max_plan`` plus blocks_per_sm
    and sms."""
    F = frames.shape[0]
    out = (ctypes.c_longlong * 12)()
    with torch.cuda.device(frames.device):
        rc = cuda_build.lib().solex_sum_max_plan(
            frames.data_ptr(), frames.element_size(), F,
            frames[0].numel(), out)
    cuda_build.check(rc, "sum_max_plan")
    v = list(out)
    return dict(plan="owned" if v[0] else "split",
                path="bulk" if v[1] else "element", K=v[2], D=v[3],
                base=v[4], rem=v[5], smem=v[6], blocks_per_sm=v[7], sms=v[8],
                blocks=v[9], fper=v[11], grid=(v[9], v[10]))


def sum_max(frames: torch.Tensor, total: torch.Tensor,
            mx: torch.Tensor) -> None:
    """Pass A over one chunk, accumulated in place: ``total += sum_f frames``
    and ``mx = max(mx, max_f frames)`` for frames (F, h, w) u8 or u16 in any
    layout and total, mx (h, w) int32 that the caller holds (zeroed before
    the first chunk).  CUDA tensors launch the sum/max kernel on the
    current stream, CPU tensors take ``sum_max_plain``.  The caller keeps
    the frames of all chunks within MAX_FRAMES, and every launch into one
    total/mx pair on one stream: the owned plan's merge is a plain load and
    store, ordered only by the stream.  Each launch adds one to
    ``SUM_MAX_PLANS`` under the plan the library took."""
    _sum_max_check(frames, "sum_max")
    for arg, t in (("total", total), ("mx", mx)):
        if (t.dtype != torch.int32 or t.shape != frames.shape[1:]
                or t.device != frames.device or not t.is_contiguous()):
            raise TypeError(f"sum_max: {arg} must be {tuple(frames.shape[1:])}"
                            f" int32, contiguous on {frames.device}")
    if frames.device.type == "cpu":
        sum_max_plain(frames, total, mx)
        return
    F, h, w = frames.shape
    owned = ctypes.c_int(0)
    with torch.cuda.device(frames.device):
        rc = cuda_build.lib().solex_sum_max(
            frames.data_ptr(), frames.element_size(), total.data_ptr(),
            mx.data_ptr(), F, h * w, cuda_build.stream_handle(frames.device),
            ctypes.byref(owned))
    cuda_build.check(rc, "sum_max")
    cuda_build.count_launch("sum_max")
    SUM_MAX_PLANS["owned" if owned.value else "split"] += 1


def mean_max(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (F, ih, iw) u8 or u16, any F -> (mean u16, max u16) on the
    frames' device: the reference's truncating mean of the exact frame
    sum (solex_util.py:174-188, a uint64 accumulation), and the max.

    Up to MAX_FRAMES frames this is ``mean_max_plain`` (one launch of the
    sum/max kernel on CUDA tensors).  Longer stacks spill the int32 sum
    into an int64 fold every SPILL_FRAMES frames, as
    solex_ser_recon_en_tpu/ops/reduce.py:MeanMaxAccumulator does, so any
    length is exact."""
    if frames.ndim == 3 and frames.shape[0] <= MAX_FRAMES:
        _sum_max_check(frames, "mean_max")
        if frames.device.type == "cpu":
            return mean_max_plain(frames)
    total = torch.zeros(frames.shape[1:], dtype=torch.int32,
                        device=frames.device)
    mx = torch.zeros_like(total)
    fold = None
    for start in range(0, frames.shape[0], SPILL_FRAMES):
        if start:
            fold = total.long() if fold is None else fold + total
            total.zero_()
        window = frames[start:start + SPILL_FRAMES]
        for a in range(0, window.shape[0], MAX_FRAMES):
            sum_max(window[a:a + MAX_FRAMES], total, mx)
    if fold is not None:
        total = fold + total
    return to_u16(total // frames.shape[0]), to_u16(mx)


def shg_fused_plain(frames: torch.Tensor, ind_l: torch.Tensor,
                    left_w: torch.Tensor) -> Step:
    """Plain version of kernel B1: int32 sum, amax and the two-tap
    gather-lerp of ops/recon.py:recon_plain on the normalised layout."""
    mean, mx = mean_max_plain(frames)
    return mean, mx, recon_plain(frames, ind_l, left_w, False, False)


def shg_fused_mxu_plain(frames: torch.Tensor, ind_l: torch.Tensor,
                        left_w: torch.Tensor) -> Step:
    """Plain version of kernel B6: int32 sum and amax, then the two taps
    gathered and combined in float64, ``a * w + b * f32(1 - w)`` (exact
    products, one rounding: what the FP64 contraction gives in any order),
    rounded to float32, clipped and truncated to u16.  A tap outside
    [0, iw) is absent (contributes 0), as in the TPU kernel's comb."""
    mean, mx = mean_max_plain(frames)
    F, ih, iw = frames.shape
    src = as_int16(frames)
    ys = torch.arange(ih, device=frames.device)
    l = ind_l.long()

    def tap(col):                                  # (F, S, ih) float64
        ok = (col >= 0) & (col < iw)
        v = widen(src[:, ys, col.clamp(0, iw - 1)].view(torch.uint16))
        return torch.where(ok, v, 0).to(torch.float64)

    w1 = (1.0 - left_w).to(torch.float64)          # 1 - w rounded in f32
    out = tap(l) * left_w.to(torch.float64) + tap(l + 1) * w1
    out = to_u16(out.to(torch.float32).clamp(0, 65535))
    return mean, mx, out.permute(1, 2, 0).contiguous()


#: B1 launches by copy path ("bulk": TMA bulk copies of whole runs;
#: "element": 16-byte cp.async granules), as the kernel library reports
#: them; reset by callers that count a run
FUSED_PATHS = {"bulk": 0, "element": 0}


def fused_plan(data_ptr: int, S: int, ih: int, iw: int):
    """Kernel B1's copy path and ring (csrc/plans.cuh, through the host
    library) for frames at ``data_ptr`` of shape (F, ih, iw) and S shifts,
    as a dict (path, yb rows a block owns, xw its columns, K frames a
    stage, D stages in the ring, fb frames a disk store, smem bytes a
    block), or None where even the smallest ring does not fit (the launch
    then fails)."""
    ok, v = _host_plan("solex_shg_fused_plan_host", 7, ctypes.c_int,
                       data_ptr, S, ih, iw)
    if not ok:
        return None
    return dict(path="bulk" if v[0] else "element", yb=v[1], xw=v[2],
                K=v[3], D=v[4], fb=v[5], smem=v[6])


def mxu_frame_stride(n: int) -> int:
    """Bytes between two frames of a B6 stage that holds runs of n u16
    (csrc/plans.cuh: frame_stride): 16 more than a multiple of 128."""
    return native.get_lib().solex_mxu_frame_stride(n)


def fused_mxu_plan(data_ptr: int, S: int, ih: int, iw: int):
    """Kernel B6's copy path and ring (csrc/plans.cuh, through the host
    library) for frames at ``data_ptr`` of shape (F, ih, iw), iw <=
    ``PLAN_LIMITS["b6_max_iw"]``, and S shifts, as a dict (path, yb rows a
    block owns, D stages of 8 frames in the ring, fb frames a disk store,
    stride bytes between two frames of a stage, smem bytes a block), or
    None where even the smallest plan does not fit (several thousand
    shifts; the kernel library then refuses the launch).  Tests and the
    smoke run hold it to the library's plan (``fused_mxu_plan_cuda``)."""
    ok, v = _host_plan("solex_shg_fused_mxu_plan_host", 6, ctypes.c_int,
                       data_ptr, S, ih, iw)
    if not ok:
        return None
    return dict(path="bulk" if v[0] else "element", yb=v[1], D=v[2],
                fb=v[3], stride=v[4], smem=v[5])


def fused_mxu_plan_cuda(frames: torch.Tensor, S: int) -> dict:
    """The launch geometry kernel B6 would use on these CUDA frames, from
    the kernel library itself (csrc/fused_mxu.cu:solex_shg_fused_mxu_plan):
    the keys of ``fused_mxu_plan`` plus blocks_per_sm, grid and fper (frames
    a block)."""
    F, ih, iw = frames.shape
    out = (ctypes.c_int * 10)()
    with torch.cuda.device(frames.device):
        rc = cuda_build.lib().solex_shg_fused_mxu_plan(frames.data_ptr(), S,
                                                       F, ih, iw, out)
    cuda_build.check(rc, "shg_fused_mxu_plan")
    v = list(out)
    return dict(path="bulk" if v[0] else "element", yb=v[1], D=v[2], fb=v[3],
                stride=v[4], smem=v[5], blocks_per_sm=v[6],
                grid=tuple(v[7:9]), fper=v[9])


def fused_plan_cuda(frames: torch.Tensor, S: int) -> dict:
    """The launch geometry kernel B1 would use on these CUDA frames, from
    the kernel library itself (csrc/fused.cu:solex_shg_fused_plan): the
    keys of ``fused_plan`` plus blocks_per_sm, grid and fper (frames a
    block)."""
    F, ih, iw = frames.shape
    out = (ctypes.c_int * 12)()
    with torch.cuda.device(frames.device):
        rc = cuda_build.lib().solex_shg_fused_plan(frames.data_ptr(), S, F,
                                                   ih, iw, out)
    cuda_build.check(rc, "shg_fused_plan")
    v = list(out)
    return dict(path="bulk" if v[0] else "element", yb=v[1], xw=v[2],
                K=v[3], D=v[4], fb=v[5], smem=v[6], blocks_per_sm=v[7],
                grid=tuple(v[8:11]), fper=v[11])


def _launch(entry: str, frames: torch.Tensor, ind_l: torch.Tensor,
            left_w: torch.Tensor, *extra) -> Step:
    F, ih, iw = frames.shape
    S = ind_l.shape[0]
    dev = frames.device
    total = torch.empty((ih, iw), dtype=torch.int32, device=dev)
    mx = torch.empty((ih, iw), dtype=torch.int32, device=dev)
    disks = torch.empty((S, ih, F), dtype=torch.uint16, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(cuda_build.lib(), "solex_" + entry)(
            frames.data_ptr(), ind_l.data_ptr(), left_w.data_ptr(),
            total.data_ptr(), mx.data_ptr(), disks.data_ptr(), S, F, ih, iw,
            cuda_build.stream_handle(dev), *extra)
    cuda_build.check(rc, entry)
    cuda_build.count_launch(entry)
    # as in the JAX package, the mean division and the u16 casts sit
    # outside the kernel (ops/fused_pallas.py:232-233, :290-291)
    return to_u16(total // F), to_u16(mx), disks


def shg_fused_mxu(frames: torch.Tensor, ind_l: torch.Tensor,
                  left_w: torch.Tensor) -> Step:
    """Kernel B6 on CUDA tensors, ``shg_fused_mxu_plain`` on CPU tensors;
    the contract of ``shg_fused``, for iw <= ``PLAN_LIMITS["b6_max_iw"]``
    (3072).  On the card the shift count is bounded by the block's shared
    memory (its staging tile and tap columns grow with S): past several
    thousand shifts the kernel library refuses the launch
    (cudaErrorInvalidValue, raised by ``cuda_build.check``);
    ``fused_mxu_plan`` says whether a plan exists."""
    _check(frames, ind_l, left_w, "shg_fused_mxu")
    F, ih, iw = frames.shape
    max_iw = _plan_limits()["b6_max_iw"]
    if iw > max_iw:
        raise ValueError(f"shg_fused_mxu: iw={iw} > {max_iw} (B6 holds "
                         "whole rows in shared memory)")
    if frames.device.type == "cpu":
        return shg_fused_mxu_plain(frames, ind_l, left_w)
    return _launch("shg_fused_mxu", frames, ind_l, left_w)


def shg_fused(frames: torch.Tensor, ind_l: torch.Tensor,
              left_w: torch.Tensor, mxu: bool = False) -> Step:
    """frames (F, ih, iw) u16, ind_l (S, ih) i32, left_w (ih,) f32
    -> (mean u16 (ih, iw), max u16 (ih, iw), disks u16 (S, ih, F)).

    The contract of solex_ser_recon_en_tpu/ops/fused_pallas.py:326-337:
    ``mxu`` selects kernel B6 (``shg_fused_mxu``), else kernel B1, whose
    tap columns are clipped to [0, iw-2] as build_shift_indices does.
    Each B1 launch adds one to ``FUSED_PATHS`` under the copy path the
    kernel library took.
    """
    if mxu:
        return shg_fused_mxu(frames, ind_l, left_w)
    _check(frames, ind_l, left_w)
    if frames.device.type == "cpu":
        return shg_fused_plain(frames, ind_l, left_w)
    bulk = ctypes.c_int(0)
    out = _launch("shg_fused", frames, ind_l, left_w, ctypes.byref(bulk))
    FUSED_PATHS["bulk" if bulk.value else "element"] += 1
    return out
