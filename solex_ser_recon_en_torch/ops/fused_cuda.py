"""The fused single-pass step on the card: wrapper of kernel B1 (csrc/fused.cu).

Counterpart of solex_ser_recon_en_tpu/ops/fused_pallas.py:shg_fused_pallas
(the VPU kernels _kernel_win and _kernel, which are bit-identical; B1 folds
both).  One read of the normalised frame slab gives the int32 frame sum,
the frame max and the multi-shift disks.  A CUDA tensor launches the
kernel; a CPU tensor takes the plain version (``shg_fused_plain``); any
other device raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_build
from .dtypes import to_u16, widen
from .recon import recon_plain

#: int32 sum bound: 65535 * 32767 < 2**31 (ops/fused_pallas.py:21)
MAX_FRAMES = 32767

Step = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(frames: torch.Tensor, ind_l: torch.Tensor,
           left_w: torch.Tensor) -> None:
    if frames.ndim != 3 or frames.dtype != torch.uint16:
        raise TypeError(f"shg_fused: frames must be (F, ih, iw) uint16, got "
                        f"{tuple(frames.shape)} {frames.dtype}")
    F, ih, iw = frames.shape
    if ind_l.ndim != 2 or ind_l.dtype != torch.int32 or ind_l.shape[1] != ih:
        raise TypeError(f"shg_fused: ind_l must be (S, {ih}) int32, got "
                        f"{tuple(ind_l.shape)} {ind_l.dtype}")
    if left_w.dtype != torch.float32 or tuple(left_w.shape) != (ih,):
        raise TypeError(f"shg_fused: left_w must be ({ih},) float32, got "
                        f"{tuple(left_w.shape)} {left_w.dtype}")
    for name, t in (("frames", frames), ("ind_l", ind_l), ("left_w", left_w)):
        if t.device != frames.device or not t.is_contiguous():
            raise ValueError(
                f"shg_fused: {name} must be contiguous on {frames.device}")
    S = ind_l.shape[0]
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"shg_fused: F={F} outside [1, {MAX_FRAMES}] "
                         "(the int32 frame sum would overflow)")
    if not 1 <= S <= 65535 or not 1 <= ih <= 65535 or iw < 2:
        raise ValueError(f"shg_fused: S={S}, ih={ih}, iw={iw} out of range")


def mean_max_plain(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (F, ih, iw) u16 -> (mean u16, max u16): int32 sum floor-divided
    by F (the reference's truncating mean), and the max."""
    v = widen(frames)
    total = v.sum(dim=0, dtype=torch.int32)
    return to_u16(total // frames.shape[0]), to_u16(v.amax(dim=0))


def shg_fused_plain(frames: torch.Tensor, ind_l: torch.Tensor,
                    left_w: torch.Tensor) -> Step:
    """Plain version of kernel B1: int32 sum, amax and the two-tap
    gather-lerp of ops/recon.py:recon_plain on the normalised layout."""
    mean, mx = mean_max_plain(frames)
    return mean, mx, recon_plain(frames, ind_l, left_w, False, False)


def shg_fused(frames: torch.Tensor, ind_l: torch.Tensor,
              left_w: torch.Tensor) -> Step:
    """frames (F, ih, iw) u16, ind_l (S, ih) i32, left_w (ih,) f32
    -> (mean u16 (ih, iw), max u16 (ih, iw), disks u16 (S, ih, F)).

    The contract of solex_ser_recon_en_tpu/ops/fused_pallas.py:326-329.
    Tap columns are clipped to [0, iw-2], as build_shift_indices does.
    """
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"shg_fused: unsupported device {frames.device}")
    _check(frames, ind_l, left_w)
    if frames.device.type == "cpu":
        return shg_fused_plain(frames, ind_l, left_w)
    F, ih, iw = frames.shape
    S = ind_l.shape[0]
    dev = frames.device
    total = torch.empty((ih, iw), dtype=torch.int32, device=dev)
    mx = torch.empty((ih, iw), dtype=torch.int32, device=dev)
    disks = torch.empty((S, ih, F), dtype=torch.uint16, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_build.lib().solex_shg_fused(
            frames.data_ptr(), ind_l.data_ptr(), left_w.data_ptr(),
            total.data_ptr(), mx.data_ptr(), disks.data_ptr(), S, F, ih, iw,
            cuda_build.stream_handle(dev),
        )
    cuda_build.check(rc, "shg_fused")
    cuda_build.LAUNCHES["shg_fused"] += 1
    # as in the JAX package, the mean division and the u16 casts sit
    # outside the kernel (ops/fused_pallas.py:290-291)
    return to_u16(total // F), to_u16(mx), disks
