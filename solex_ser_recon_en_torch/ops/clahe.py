"""CLAHE and exact value histograms: kernel B5.

Counterpart of solex_ser_recon_en_tpu/ops/clahe.py.  reference: the
reference applies ``cv2.createCLAHE(clipLimit=0.8, tileGridSize=(2, 2))``
to the final uint16 disk (solex_util.py:532-533).  OpenCV's algorithm:

1. pad right/bottom with BORDER_REFLECT_101 to a multiple of the tile grid,
2. per-tile histogram (65536 bins for uint16) — kernel B5,
3. clip at max(1, int(clipLimit*tileArea/histSize)) and redistribute the
   excess (uniform batch + residual at stride max(histSize/residual, 1)),
4. LUT = round_half_even(cdf * (histSize-1)/tileArea),
5. bilinear interpolation of the 4 neighbouring tile LUTs over the
   original (unpadded) pixel grid.

``tile_histograms`` launches kernel B5 (csrc/hist.cu) for CUDA tensors and
takes ``tile_histograms_plain`` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from .dtypes import widen

HIST_CHUNK = 1 << 17   # values per block of kernel B5


def tile_histograms_plain(tiles: torch.Tensor, hist_size: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B5: tiles (T, n) int32 ->
    (T, hist_size) int32 exact counts; values outside [0, hist_size) are
    skipped."""
    T, n = tiles.shape
    ok = (tiles >= 0) & (tiles < hist_size)
    flat = tiles.long() + hist_size * torch.arange(
        T, device=tiles.device)[:, None]
    counts = torch.bincount(flat[ok], minlength=T * hist_size)
    return counts.to(torch.int32).reshape(T, hist_size)


def tile_histograms(tiles: torch.Tensor, hist_size: int) -> torch.Tensor:
    """Kernel B5 on CUDA tensors, the plain version on CPU tensors."""
    if tiles.device.type == "cpu":
        return tile_histograms_plain(tiles, hist_size)
    if tiles.device.type != "cuda":
        raise ValueError(f"tile_histograms: unsupported device {tiles.device}")
    if tiles.dtype != torch.int32 or tiles.ndim != 2 or not tiles.is_contiguous():
        raise TypeError("tile_histograms: tiles must be contiguous (T, n) int32")
    T, n = tiles.shape
    if not (0 < T <= 65535 and 0 < n < (1 << 31) and 0 < hist_size <= (1 << 24)):
        raise ValueError(f"tile_histograms: T={T}, n={n}, "
                         f"hist_size={hist_size} out of range")
    out = torch.empty((T, hist_size), dtype=torch.int32, device=tiles.device)
    with torch.cuda.device(tiles.device):
        rc = cuda_build.lib().solex_tile_hist(
            tiles.data_ptr(), T, n, hist_size, HIST_CHUNK, out.data_ptr(),
            cuda_build.stream_handle(tiles.device),
        )
    cuda_build.check(rc, "tile_hist")
    cuda_build.LAUNCHES["tile_hist"] += 1
    return out


def _clip_redistribute(hist: torch.Tensor, clip: int, hist_size: int
                       ) -> torch.Tensor:
    """OpenCV's histogram clipping + excess redistribution (per tile)."""
    clipped = torch.clamp(hist - clip, min=0).sum(dim=-1, keepdim=True,
                                                  dtype=torch.int32)
    h = torch.clamp(hist, max=clip)
    redist = torch.div(clipped, hist_size, rounding_mode="floor")
    residual = clipped - redist * hist_size                   # (T, 1)
    h = h + redist
    idx = torch.arange(hist_size, dtype=torch.int32, device=hist.device)[None]
    step = torch.clamp(hist_size // torch.clamp(residual, min=1), min=1)
    bonus = ((idx % step) == 0) & (torch.div(idx, step, rounding_mode="floor")
                                   < residual)
    return h + bonus.to(torch.int32)


def _f32(x) -> float:
    """Round a host value to float32 (as a python float)."""
    return float(np.float32(x))


def percentile_from_hist(hist: torch.Tensor, n: int, q_pct: float
                         ) -> torch.Tensor:
    """jnp.percentile(values.astype(f32), q_pct) from an exact value
    histogram: the k-th order statistic is the smallest bin whose
    cumulative count reaches k+1.

    The q -> index arithmetic is the JAX package's (jnp's weakly-typed
    float32 steps, which XLA folds to float32 constants); here it runs in
    numpy float32 on the host, and only the two order statistics and the
    final lerp touch the device.  Returns a 0-d float32 tensor.
    """
    if n >= (1 << 31):
        raise ValueError(f"percentile_from_hist: n={n} exceeds int32 counts")
    q = np.float32(q_pct) / np.float32(100)
    nf = np.float32(n)
    qn = q * (nf - np.float32(1))
    low = np.clip(np.floor(qn), np.float32(0), nf - np.float32(1))
    high = np.clip(np.ceil(qn), np.float32(0), nf - np.float32(1))
    high_w = qn - np.floor(qn)
    low_w = np.float32(1) - high_w
    cum = torch.cumsum(hist.to(torch.int32), dim=0, dtype=torch.int32)
    k = torch.tensor([int(low) + 1, int(high) + 1], dtype=torch.int32,
                     device=hist.device)
    s = torch.searchsorted(cum, k, side="left").to(torch.float32)
    return s[0] * _f32(low_w) + s[1] * _f32(high_w)


def value_histogram(img: torch.Tensor, hist_size: int) -> torch.Tensor:
    """Exact (hist_size,) histogram of a full u8/u16 image (one tile)."""
    return tile_histograms(widen(img).reshape(1, -1), hist_size)[0]


def _reflect_rows(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """Pad ``pad`` entries at the end of ``dim`` with BORDER_REFLECT_101."""
    if pad == 0:
        return x
    n = x.shape[dim]
    idx = torch.arange(n - 2, n - 2 - pad, -1, device=x.device)
    return torch.cat([x, x.index_select(dim, idx)], dim=dim)


def _clahe(img: torch.Tensor, clip_limit: float, tiles_x: int,
                tiles_y: int, hist_size: int, return_full_hist: bool = False):
    """cv2 CLAHE of an integer image -> float32 values (and, on request,
    the image's exact value histogram when the grid needs no padding,
    else None)."""
    h, w = img.shape
    vals = widen(img)
    pad_r = (-w) % tiles_x
    pad_b = (-h) % tiles_y
    src = _reflect_rows(_reflect_rows(vals, pad_b, 0), pad_r, 1)
    ph, pw = h + pad_b, w + pad_r
    th, tw = ph // tiles_y, pw // tiles_x
    tile_area = th * tw
    lut_scale = _f32(np.float32(hist_size - 1) / np.float32(tile_area))
    clip = max(int(clip_limit * tile_area / hist_size), 1) if clip_limit > 0 else 0

    tiles = (
        src.reshape(tiles_y, th, tiles_x, tw)
        .permute(0, 2, 1, 3)
        .reshape(tiles_y * tiles_x, tile_area)
        .contiguous()
    )
    hist = tile_histograms(tiles, hist_size)
    full_hist = None
    if return_full_hist and pad_r == 0 and pad_b == 0:
        full_hist = hist.sum(dim=0, dtype=torch.int32)
    if clip > 0:
        hist = _clip_redistribute(hist, clip, hist_size)
    cdf = torch.cumsum(hist, dim=-1, dtype=torch.int32)
    luts = torch.clamp(
        torch.round(cdf.to(torch.float32) * lut_scale), 0, hist_size - 1
    ).to(torch.int32)                                       # (T, hist_size)

    # bilinear interpolation of tile LUTs over the ORIGINAL grid
    x = torch.arange(w, dtype=torch.float32, device=img.device)
    y = torch.arange(h, dtype=torch.float32, device=img.device)
    txf = x / tw - 0.5
    tyf = y / th - 0.5
    tx1 = torch.floor(txf).to(torch.int32)
    ty1 = torch.floor(tyf).to(torch.int32)
    xa = txf - tx1
    ya = tyf - ty1
    tx2 = torch.clamp(tx1 + 1, max=tiles_x - 1)
    tx1 = torch.clamp(tx1, min=0)
    ty2 = torch.clamp(ty1 + 1, max=tiles_y - 1)
    ty1 = torch.clamp(ty1, min=0)

    luts_flat = luts.reshape(-1)

    def tile_lookup(ty, tx):
        slot = (ty[:, None] * tiles_x + tx[None, :]).long()
        return luts_flat[slot * hist_size + vals.long()].to(torch.float32)

    wx1 = (1.0 - xa)[None, :]
    wy1 = (1.0 - ya)[:, None]
    res = (
        tile_lookup(ty1, tx1) * wx1 * wy1
        + tile_lookup(ty1, tx2) * (1 - wx1) * wy1
        + tile_lookup(ty2, tx1) * wx1 * (1 - wy1)
        + tile_lookup(ty2, tx2) * (1 - wx1) * (1 - wy1)
    )
    out = torch.clamp(torch.round(res), 0, hist_size - 1)
    if return_full_hist:
        return out, full_hist
    return out


def clahe(img: torch.Tensor, clip_limit: float = 0.8, tiles=(2, 2)
          ) -> torch.Tensor:
    """cv2-compatible CLAHE of a (H, W) uint8 or uint16 image."""
    if img.dtype == torch.uint8:
        hist_size, out_dtype = 256, torch.uint8
    elif img.dtype == torch.uint16:
        hist_size, out_dtype = 65536, torch.uint16
    else:
        raise TypeError(f"clahe expects uint8/uint16, got {img.dtype}")
    out = _clahe(img, float(clip_limit), int(tiles[0]), int(tiles[1]),
                      hist_size)
    return out.to(torch.int32).to(out_dtype)
