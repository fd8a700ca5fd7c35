"""Two-pass scan processing over raw device chunks.

Counterpart of solex_ser_recon_en_tpu/ops/fused.py:RawScanProcessor.  The
scan is inherently two passes (the recon needs the line fit, which needs
the mean image — reference: Solex_recon.py:61-63).  Both passes work on
the raw on-disk layout, so the slab is never rotated or upscaled:

- pass A: int32 sum and max over the raw frames of every chunk (plain
  torch, as the JAX package leaves it to XLA); the small (H, W) results
  are rotated/upscaled once at the end, in float64 on the host.
- pass B: kernel B3 (ops/recon_cuda.py) per resident chunk, writing the
  chunk's disjoint frame columns of the (S, ih, F) disks.

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

from .dtypes import as_int16, widen
from .recon import build_shift_indices
from .recon_cuda import recon


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
        v = widen(raw_chunk)
        self._sum += v.sum(dim=0, dtype=torch.int32)
        torch.maximum(self._max, v.amax(dim=0), out=self._max)
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

    def reconstruct(self, fit_floor, fit_frac, shifts: List[int]) -> torch.Tensor:
        if not self._chunks:
            raise ValueError("no resident chunks to reconstruct from")
        return self.reconstruct_streaming(self._chunks, fit_floor, fit_frac,
                                          shifts)

    def reconstruct_streaming(self, chunks, fit_floor, fit_frac,
                              shifts: List[int]) -> torch.Tensor:
        """Pass B over an iterable of (start, raw device chunk)."""
        ind_l, left_w = build_shift_indices(fit_floor, fit_frac, shifts,
                                            self.iw)
        ind_l = torch.from_numpy(ind_l).to(self.device)
        left_w = torch.from_numpy(left_w).to(self.device)
        parts = [(start, recon(c, ind_l, left_w, self.rotate, self.upscale))
                 for start, c in chunks]
        parts.sort(key=lambda p: p[0])
        return torch.cat([as_int16(p) for _, p in parts], dim=2).view(
            torch.uint16)
