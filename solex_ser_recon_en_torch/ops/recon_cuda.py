"""Pass B on the card: wrapper of kernel B3 (csrc/recon.cu).

Counterpart of solex_ser_recon_en_tpu/ops/pallas_recon.py (the Pallas recon
kernel).  ``recon_chunks`` launches the kernel once over a scan's resident
raw chunks and writes the disks straight into one (S, ih, F) tensor;
``recon`` is its one-chunk case.  A CUDA tensor launches the kernel; a CPU
tensor takes the plain version (ops/recon.py:recon_chunks_plain); any
other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import cuda_build
from .cuda_build import RECON_MAX_CHUNKS
from .recon import recon_chunks_plain


def _check_chunks(chunks: Sequence[torch.Tensor], ind_l: torch.Tensor,
                  left_w: torch.Tensor, rotate: bool,
                  out: Optional[torch.Tensor], frame_offset: int):
    """Validate a launch; returns (F, H, W, ih, S)."""
    if not 1 <= len(chunks) <= RECON_MAX_CHUNKS:
        raise ValueError(f"recon: {len(chunks)} chunks, 1 to "
                         f"{RECON_MAX_CHUNKS} per launch")
    first = chunks[0]
    if first.ndim != 3 or first.dtype not in (torch.uint16, torch.uint8):
        raise TypeError(f"recon: raw must be (F, H, W) u16/u8, got "
                        f"{tuple(first.shape)} {first.dtype}")
    C, H, W = first.shape
    want = (first.dtype, first.get_device(), first.shape[1:])
    frames = []
    for k, c in enumerate(chunks):
        if (c.dtype, c.get_device(), c.shape[1:]) != want:
            raise TypeError(f"recon: chunk {k} is {tuple(c.shape)} "
                            f"{c.dtype} on {c.device}, chunk 0 "
                            f"{tuple(first.shape)} {first.dtype}")
        frames.append(c.shape[0])
    for k, n in enumerate(frames):
        if not (0 < n <= C if k == len(frames) - 1 else n == C):
            raise ValueError(f"recon: chunk {k} holds {n} frames; every "
                             f"chunk but the last must hold {C}")
    F = sum(frames)
    ih, iw = (W, H) if rotate else (H, W)
    S = ind_l.shape[0]
    if ind_l.dtype != torch.int32 or tuple(ind_l.shape) != (S, ih):
        raise TypeError(f"recon: ind_l must be ({S}, {ih}) int32")
    if left_w.dtype != torch.float32 or tuple(left_w.shape) != (ih,):
        raise TypeError(f"recon: left_w must be ({ih},) float32")
    if not 1 <= S <= 65535 or iw < 2:
        raise ValueError(f"recon: S={S}, iw={iw} out of range")
    if out is None:
        if frame_offset != 0:
            raise ValueError("recon: frame_offset needs an out tensor")
    elif (out.dtype != torch.uint16 or out.ndim != 3
          or tuple(out.shape[:2]) != (S, ih)
          or not 0 <= frame_offset <= out.shape[2] - F):
        raise ValueError(f"recon: out must be ({S}, {ih}, >= "
                         f"{frame_offset + F}) u16, got {tuple(out.shape)} "
                         f"{out.dtype}")
    return F, H, W, ih, S


def recon_chunks(chunks: Sequence[torch.Tensor], ind_l: torch.Tensor,
                 left_w: torch.Tensor, rotate: bool, upscale: bool,
                 out: Optional[torch.Tensor] = None,
                 frame_offset: int = 0) -> torch.Tensor:
    """Disks of consecutive raw chunks in one launch of kernel B3.

    chunks: (n_k, H, W) u16/u8 tensors holding consecutive frames, every
    one but the last with the same n_k (the feeder's chunking), at most
    RECON_MAX_CHUNKS of them.  Writes frames [frame_offset, frame_offset +
    sum n_k) of ``out`` (S, ih, F_out) u16 and returns it; with ``out``
    None, returns a new (S, ih, sum n_k) tensor.
    """
    chunks = list(chunks)
    if not chunks:
        raise ValueError("recon: no chunks")
    dev = chunks[0].device
    F, H, W, ih, S = _check_chunks(chunks, ind_l, left_w, rotate, out,
                                   frame_offset)
    if dev.type == "cpu":
        return recon_chunks_plain(chunks, ind_l, left_w, rotate, upscale,
                                  out, frame_offset)
    if dev.type != "cuda":
        raise ValueError(f"recon: unsupported device {dev}")
    if out is None:
        out = torch.empty((S, ih, F), dtype=torch.uint16, device=dev)
    named = [(f"chunk {k}", c) for k, c in enumerate(chunks)]
    for name, t in named + [("ind_l", ind_l), ("left_w", left_w),
                            ("out", out)]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"recon: {name} must be contiguous on {dev}")
    bases = (ctypes.c_uint64 * len(chunks))(*(c.data_ptr() for c in chunks))
    with torch.cuda.device(dev):
        rc = cuda_build.lib().solex_recon_chunks(
            bases, len(chunks), chunks[0].shape[0], chunks[0].element_size(),
            ind_l.data_ptr(), left_w.data_ptr(), out.data_ptr(), S, F, H, W,
            ih, out.shape[2], frame_offset, int(rotate), int(upscale),
            cuda_build.stream_handle(dev),
        )
    cuda_build.check(rc, "recon")
    cuda_build.LAUNCHES["recon"] += 1
    return out


def recon(raw: torch.Tensor, ind_l: torch.Tensor, left_w: torch.Tensor,
          rotate: bool, upscale: bool) -> torch.Tensor:
    """raw (F, H, W) u16/u8 -> disks (S, ih, F) u16 (see recon_plain): the
    one-chunk case of ``recon_chunks``."""
    return recon_chunks([raw], ind_l, left_w, rotate, upscale)
