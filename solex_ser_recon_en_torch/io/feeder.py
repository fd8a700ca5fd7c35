"""Raw SER chunks to the device, and their normalisation there.

Counterpart of solex_ser_recon_en_tpu/io/feeder.py:raw_device_chunks and
normalize_frames.  The chunks keep the on-disk layout (the consumers,
ops/fused.py, index the raw layout directly).  On CUDA, each memmap slice
is copied into one of two pinned staging buffers and uploaded with
``copy_(non_blocking=True)`` on a side stream; the consumer's stream waits
on the upload's event before it uses the chunk, and the host refills a
staging buffer only after the upload that last read it has finished — so
reading chunk k+1 from the file overlaps the upload and the use of chunk
k.

SER only (the AVI demuxer needs OpenCV).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from ..ops.dtypes import as_int16, to_u16, widen
from .ser import SerReader

TARGET_CHUNK_BYTES = 96 * 1024 * 1024


def auto_chunk_frames(frame_bytes: int, requested: int) -> int:
    """Frames per host->device transfer, capped to ~96 MB per chunk."""
    cap = max(1, TARGET_CHUNK_BYTES // max(frame_bytes, 1))
    return max(1, min(requested, cap))


def normalize_frames(raw: torch.Tensor, rotate: bool,
                     upscale: bool) -> torch.Tensor:
    """(F, H, W) raw frames -> (F, ih, iw) uint16, on raw's device.

    rotate: np.rot90 over the spatial axes (wavelength axis -> X),
    out[f, i, j] = raw[f, j, W-1-i].  upscale: 8-bit -> 16-bit x256.
    Either one makes a new contiguous slab (the shape changes, so it
    cannot be done in place): one slab of device memory beside ``raw``
    until the caller drops it.  With neither, ``raw`` is returned as is.
    """
    out = raw
    if upscale:
        out = to_u16(widen(out) << 8)
    if rotate:
        out = as_int16(out).transpose(1, 2).flip(1).contiguous().view(
            out.dtype)
    return out


def raw_device_chunks(
    reader: SerReader, chunk: int, device: torch.device
) -> Tuple[Iterator[Tuple[int, torch.Tensor]], bool, bool]:
    """(iterator of (start, raw chunk on ``device``), rotate, upscale).

    Every yielded tensor is a fresh (n, Height, Width) allocation, ready to
    use on the current stream and safe to keep resident.
    """
    chunk = auto_chunk_frames(reader.header.frame_bytes, chunk)
    dtype = torch.uint8 if reader.header.pixel_depth == 8 else torch.uint16
    shape = (reader.Height, reader.Width)

    def gen_cpu():
        for start in range(0, reader.frame_count, chunk):
            n = min(chunk, reader.frame_count - start)
            yield start, torch.from_numpy(np.array(reader.raw_frames(start, n)))

    def gen_cuda():
        copy_stream = torch.cuda.Stream(device)
        staging = [torch.empty((chunk, *shape), dtype=dtype, pin_memory=True)
                   for _ in range(2)]
        done = [None, None]
        for k, start in enumerate(range(0, reader.frame_count, chunk)):
            n = min(chunk, reader.frame_count - start)
            b = k % 2
            if done[b] is not None:
                done[b].synchronize()      # its previous upload has read it
            host = staging[b][:n]
            np.copyto(host.view(torch.int16).numpy() if dtype == torch.uint16
                      else host.numpy(),
                      reader.raw_frames(start, n).view(
                          np.int16 if dtype == torch.uint16 else np.uint8))
            consumer = torch.cuda.current_stream(device)
            with torch.cuda.stream(copy_stream):
                # allocated from the copy stream's pool; record_stream makes
                # the allocator wait for the consumer's work before reuse
                dev = torch.empty((n, *shape), dtype=dtype, device=device)
                dev.copy_(host, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy_stream)
            dev.record_stream(consumer)
            done[b] = ev
            consumer.wait_event(ev)
            yield start, dev
        for ev in done:
            if ev is not None:
                ev.synchronize()

    gen = gen_cuda() if device.type == "cuda" else gen_cpu()
    return gen, reader.flag_rotate, reader.header.pixel_depth == 8
