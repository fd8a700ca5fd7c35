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
  all resident pieces of a shard (or once per streamed piece); on one
  device it writes straight into the (S, ih, F) disks.
  ``reconstruct_band`` runs it over the ``band`` feed's pieces, which
  hold only the recon's spectral band.

For wide-stored scans (Width > Height, the common Sol'Ex case):
    norm[y, x] = raw[x, W-1-y]   (np.rot90; video_reader.py:119-120)

The feed yields (start, piece, shard) triples; one device is a one-shard
mesh.  Under a device mesh (``shards``) pass A keeps one sum/max pair a
frame shard and folds them on the first device, and pass B runs B3 once a
shard and gathers the columns (``recon_sharded``; JAX ops/fused.py:129-145,
:188-205, where XLA partitions the same programs).

The JAX package merges small scans' chunks into one slab before pass B
because XLA picks its FMA chaining by shape; kernel B3's arithmetic does
not depend on the chunking, so no merge copy is made here.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..parallel.mesh import replicate
from .dtypes import as_int16
from .fused_cuda import MAX_FRAMES, sum_max
from .recon import build_shift_indices
from .recon_cuda import RECON_MAX_CHUNKS, recon_chunks


class RawScanProcessor:
    """Feed every piece to ``accumulate`` (pass A; pieces stay resident if
    ``keep``), call ``mean_max`` for the normalised mean/max, then
    ``reconstruct(fit_floor, fit_frac, shifts)`` (pass B over the resident
    pieces) or ``reconstruct_streaming`` over a fresh piece iterator.

    ``shards`` (a mesh row's frame devices, parallel/mesh.py; default
    ``[device]``, one device being a one-shard mesh) keeps one int32
    sum/max pair a shard on that shard's device: pass A runs once a piece
    on the piece's device, ``mean_max`` folds the shards on ``device`` (the
    mesh's first device), and pass B launches kernel B3 once a shard over
    its pieces and gathers their columns, in frame order, into the disks
    on ``device``.  Integer sums and maxima and B3's per-column arithmetic
    do not depend on the split: the results are bit-identical to one
    device's."""

    def __init__(self, height: int, width: int, rotate: bool, upscale: bool,
                 device: torch.device, shards=None):
        self.rotate = rotate
        self.upscale = upscale
        self.device = device
        self.shards = [torch.device(d) for d in shards] if shards else [
            torch.device(device)]
        self.ih = max(width, height) if rotate else height
        self.iw = min(width, height) if rotate else width
        self._acc = [(torch.zeros((height, width), dtype=torch.int32,
                                  device=d),
                      torch.zeros((height, width), dtype=torch.int32,
                                  device=d)) for d in self.shards]
        self._pieces: List[Tuple[int, torch.Tensor, int]] = []
        self.count = 0

    def accumulate(self, start: int, raw_chunk: torch.Tensor,
                   keep: bool = True, shard: int = 0) -> None:
        if self.count + raw_chunk.shape[0] > MAX_FRAMES:
            raise ValueError(
                f"a scan of more than {MAX_FRAMES} frames would overflow "
                "the int32 frame sum")
        sum_max(raw_chunk, *self._acc[shard])
        self.count += raw_chunk.shape[0]
        if keep:
            self._pieces.append((start, raw_chunk, shard))

    def mean_max(self) -> Tuple[np.ndarray, np.ndarray]:
        """Normalised-orientation mean (uint16, reference truncation) and max."""
        total, mx = self._acc[0]
        if len(self._acc) > 1:
            # the shards' sums and maxima folded on the first device:
            # exact (the total stays within MAX_FRAMES frames)
            total, mx = total.to(self.device), mx.to(self.device)
            for s_k, m_k in self._acc[1:]:
                total = total + s_k.to(self.device)
                mx = torch.maximum(mx, m_k.to(self.device))
        total = total.cpu().numpy().astype(np.int64)
        mx = mx.cpu().numpy().astype(np.uint16)
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
        """Pass B over the resident pieces: kernel B3 once a shard (more
        only past RECON_MAX_CHUNKS pieces), gathered (``recon_sharded``)."""
        if not self._pieces:
            raise ValueError("no resident chunks to reconstruct from")
        ind_l, left_w, disks = self._pass_b_setup(fit_floor, fit_frac, shifts)
        return recon_sharded(self._pieces, self.shards, ind_l, left_w,
                             self.rotate, self.upscale, disks)

    def reconstruct_streaming(self, chunks, fit_floor, fit_frac,
                              shifts: List[int]) -> torch.Tensor:
        """Pass B over an iterable of (start, raw device piece, shard): one
        launch a piece, into its frames of the disks (through a piece of
        disks on its own device when that is not the disks'); the pieces
        must cover the frames pass A counted, in order."""
        ind_l, left_w, disks = self._pass_b_setup(fit_floor, fit_frac, shifts)
        idx, wts = replicate(ind_l, self.shards), replicate(left_w,
                                                            self.shards)
        for start, c, _ in in_order(chunks, self.count):
            if c.device == disks.device:
                recon_chunks([c], ind_l, left_w, self.rotate, self.upscale,
                             disks, start)
            else:
                part = recon_chunks([c], idx[c.device], wts[c.device],
                                    self.rotate, self.upscale)
                as_int16(disks)[:, :, start:start + c.shape[0]].copy_(
                    as_int16(part))
        return disks


def recon_sharded(pieces, shards, ind_l: torch.Tensor, left_w: torch.Tensor,
                  rotate: bool, upscale: bool,
                  disks: torch.Tensor) -> torch.Tensor:
    """Pass B over frame-sharded resident pieces: (start, piece, shard)
    triples that tile the disks' frames.  Kernel B3 runs once a shard (once
    a RECON_MAX_CHUNKS pieces) over the shard's pieces in frame order.  A
    shard on the disks' device that holds every frame (one device) writes
    straight into ``disks`` (S, ih, F); any other shard writes a (S, ih,
    frames of the shard) tensor on its own device, whose pieces' columns
    are then copied to their frames of ``disks``.  A shard's pieces are as
    long as each other but the last (parallel/mesh.py:frame_split), as
    launch_groups needs."""
    F = disks.shape[2]
    mine = [sorted(((st, c) for st, c, sh in pieces if sh == k),
                   key=lambda p: p[0]) for k in range(len(shards))]
    whole = [m for m in mine if m and len(m) == len(pieces)]
    if whole and whole[0][0][1].device == disks.device:
        for start, group in launch_groups(whole[0], F):
            recon_chunks(group, ind_l, left_w, rotate, upscale, disks, start)
        return disks
    idx, wts = replicate(ind_l, shards), replicate(left_w, shards)
    S, ih = disks.shape[:2]
    covered = []                # (start, frames) of every piece copied
    for k, dev in enumerate(shards):
        if not mine[k]:
            continue
        # the shard's pieces at their offsets in its own disks
        local_pairs, n = [], 0
        for _, c in mine[k]:
            local_pairs.append((n, c))
            n += c.shape[0]
        local = torch.empty((S, ih, n), dtype=torch.uint16, device=dev)
        for offset, group in launch_groups(local_pairs, n):
            recon_chunks(group, idx[dev], wts[dev], rotate, upscale, local,
                         offset)
        offset = 0
        for start, c in mine[k]:
            n = c.shape[0]
            as_int16(disks)[:, :, start:start + n].copy_(
                as_int16(local)[:, :, offset:offset + n])
            covered.append((start, n))
            offset += n
    # the pieces tile the disks' frames: no gap, no overlap
    end = 0
    for start, n in sorted(covered):
        if start != end:
            raise ValueError(f"a piece starts at frame {start}, not {end}")
        end = start + n
    if end != F:
        raise ValueError(f"pieces hold {end} frames, the disks {F}")
    return disks


def reconstruct_band(band_chunks, fit_floor, fit_frac, shifts: List[int],
                     iw_total: int, x0: int, rotate: bool, upscale: bool,
                     device: torch.device, frame_count: int,
                     shards=None) -> torch.Tensor:
    """Pass B over *band* chunks (the ``band`` feed): raw chunks holding
    only spectral columns [x0, x0 + bw) (io/hostreduce.py:spectral_band),
    (n, bw, W) when stored wide (``rotate``), else (n, H, bw), as the
    feed's (start, piece, shard) triples over ``shards`` (default
    ``[device]``).  The pieces stay resident and kernel B3 runs once a
    shard over them (``recon_sharded``), with band-local taps ``ind_l -
    x0``: the disks are bit-identical to a pass B over the whole frames.

    Counterpart of solex_ser_recon_en_tpu/ops/fused.py:reconstruct_band
    (a one-hot contraction there).  The taps are clipped against the FULL
    spectral width (build_shift_indices, solex_util.py:117-118) before the
    offset; a tap outside the band raises.
    """
    ind_l, left_w = build_shift_indices(fit_floor, fit_frac, shifts,
                                        iw_total)
    chunks = list(band_chunks)
    if not chunks:
        raise ValueError("no band chunks to reconstruct from")
    first = chunks[0][1]
    bw = first.shape[1] if rotate else first.shape[2]
    ind_b = ind_l - x0
    if int(ind_b.min()) < 0 or int(ind_b.max()) + 1 > bw - 1:
        raise ValueError(f"the band [{x0}, {x0 + bw}) does not hold the "
                         f"taps [{int(ind_l.min())}, {int(ind_l.max()) + 1}]")
    ih = first.shape[2] if rotate else first.shape[1]
    disks = torch.empty((len(shifts), ih, frame_count), dtype=torch.uint16,
                        device=device)
    ind_t = torch.from_numpy(np.ascontiguousarray(ind_b)).to(device)
    w_t = torch.from_numpy(left_w).to(device)
    shards = [torch.device(d) for d in shards] if shards else [disks.device]
    return recon_sharded(chunks, shards, ind_t, w_t, rotate, upscale, disks)


def in_order(chunks, count: int):
    """Yield (start, chunk, ...) items unchanged, checking that they tile
    frames [0, count) in order."""
    end = 0
    for item in chunks:
        start, c = item[0], item[1]
        if start != end:
            raise ValueError(f"a chunk starts at frame {start}, not {end}")
        yield item
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
