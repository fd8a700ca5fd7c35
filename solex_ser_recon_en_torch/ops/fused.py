"""Two-pass scan processing over raw device chunks.

Counterpart of solex_ser_recon_en_tpu/ops/fused.py:RawScanProcessor.  The
scan is inherently two passes (the recon needs the line fit, which needs
the mean image — reference: Solex_recon.py:61-63).  Both passes work on
the raw on-disk layout, so the slab is never rotated or upscaled:

- pass A: int32 sum and max over the raw frames of every chunk, one read
  of it by the sum/max kernel (ops/fused_cuda.py:sum_max; the JAX package
  leaves it to XLA); the small (H, W) results are rotated/upscaled once at
  the end, in float64 on the host.
- pass B: kernel B3 (ops/recon_cuda.py:recon_chunks), launched once over
  all resident chunks (or once per streamed chunk), writing straight into
  the (S, ih, F) disks.

For wide-stored scans (Width > Height, the common Sol'Ex case):
    norm[y, x] = raw[x, W-1-y]   (np.rot90; video_reader.py:119-120)

The JAX package merges small scans' chunks into one slab before pass B
because XLA picks its FMA chaining by shape; kernel B3's arithmetic does
not depend on the chunking, so no merge copy is made here.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .fused_cuda import MAX_FRAMES, sum_max
from .recon import build_shift_indices
from .recon_cuda import RECON_MAX_CHUNKS, recon_chunks


class RawScanProcessor:
    """Feed every chunk to ``accumulate`` (pass A; chunks stay resident if
    ``keep``), call ``mean_max`` for the normalised mean/max, then
    ``reconstruct(fit_floor, fit_frac, shifts)`` (pass B over the resident
    chunks) or ``reconstruct_streaming`` over a fresh chunk iterator."""

    def __init__(self, height: int, width: int, rotate: bool, upscale: bool,
                 device: torch.device):
        self.rotate = rotate
        self.upscale = upscale
        self.device = device
        self.ih = max(width, height) if rotate else height
        self.iw = min(width, height) if rotate else width
        self._sum = torch.zeros((height, width), dtype=torch.int32,
                                device=device)
        self._max = torch.zeros((height, width), dtype=torch.int32,
                                device=device)
        self._chunks: List[Tuple[int, torch.Tensor]] = []
        self.count = 0

    def accumulate(self, start: int, raw_chunk: torch.Tensor,
                   keep: bool = True) -> None:
        if self.count + raw_chunk.shape[0] > MAX_FRAMES:
            raise ValueError(
                f"a scan of more than {MAX_FRAMES} frames would overflow "
                "the int32 frame sum")
        sum_max(raw_chunk, self._sum, self._max)
        self.count += raw_chunk.shape[0]
        if keep:
            self._chunks.append((start, raw_chunk))

    def mean_max(self) -> Tuple[np.ndarray, np.ndarray]:
        """Normalised-orientation mean (uint16, reference truncation) and max."""
        total = self._sum.cpu().numpy().astype(np.int64)
        mx = self._max.cpu().numpy().astype(np.uint16)
        if self.rotate:
            total = np.rot90(total)
            mx = np.rot90(mx)
        scale = 256 if self.upscale else 1
        mean = ((total.astype(np.float64) * scale) / self.count).astype(np.uint16)
        if self.upscale:
            mx = mx << 8
        return mean, np.ascontiguousarray(mx)

    def _pass_b_setup(self, fit_floor, fit_frac, shifts: List[int]):
        """(ind_l, left_w) on the device and the empty (S, ih, count)
        disks that pass B fills."""
        ind_l, left_w = build_shift_indices(fit_floor, fit_frac, shifts,
                                            self.iw)
        disks = torch.empty((len(shifts), self.ih, self.count),
                            dtype=torch.uint16, device=self.device)
        return (torch.from_numpy(ind_l).to(self.device),
                torch.from_numpy(left_w).to(self.device), disks)

    def reconstruct(self, fit_floor, fit_frac, shifts: List[int]) -> torch.Tensor:
        """Pass B over the resident chunks: one launch of kernel B3 over
        all of them (more only past RECON_MAX_CHUNKS chunks), straight
        into the disks."""
        if not self._chunks:
            raise ValueError("no resident chunks to reconstruct from")
        ind_l, left_w, disks = self._pass_b_setup(fit_floor, fit_frac, shifts)
        for start, group in launch_groups(self._chunks, self.count):
            recon_chunks(group, ind_l, left_w, self.rotate, self.upscale,
                         disks, start)
        return disks

    def reconstruct_streaming(self, chunks, fit_floor, fit_frac,
                              shifts: List[int]) -> torch.Tensor:
        """Pass B over an iterable of (start, raw device chunk): one launch
        per chunk, each into its frames of the disks; the chunks must
        cover the frames pass A counted, in order."""
        ind_l, left_w, disks = self._pass_b_setup(fit_floor, fit_frac, shifts)
        for start, c in in_order(chunks, self.count):
            recon_chunks([c], ind_l, left_w, self.rotate, self.upscale,
                         disks, start)
        return disks


def in_order(chunks, count: int):
    """Yield (start, chunk) pairs, checking that they tile frames [0,
    count) in order."""
    end = 0
    for start, c in chunks:
        if start != end:
            raise ValueError(f"a chunk starts at frame {start}, not {end}")
        yield start, c
        end = start + c.shape[0]
    if end != count:
        raise ValueError(f"chunks hold {end} frames, pass A counted {count}")


def launch_groups(chunks, count: int) -> List[Tuple[int, List[torch.Tensor]]]:
    """(first frame, chunks) launches of kernel B3 over (start, chunk)
    pairs that tile frames [0, count): the chunks in frame order,
    RECON_MAX_CHUNKS a launch.  recon_chunks refuses a chunk shorter than
    the first that is not the last, which the feeder never makes."""
    ordered = list(in_order(sorted(chunks, key=lambda p: p[0]), count))
    return [(ordered[i][0], [c for _, c in ordered[i:i + RECON_MAX_CHUNKS]])
            for i in range(0, len(ordered), RECON_MAX_CHUNKS)]
