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

``image_tile_histograms`` (step 2 on the image itself, padding included)
and ``tile_histograms`` (on a (T, n) int32 tile tensor) launch kernel B5
(csrc/hist.cu) for CUDA tensors and take their plain versions for CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from .dtypes import widen

_HIST_DTYPES = (torch.uint8, torch.uint16, torch.int32)


def tile_histograms_plain(tiles: torch.Tensor, hist_size: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B5 on tiles (T, n) int32 ->
    (T, hist_size) int32 exact counts; values outside [0, hist_size) are
    skipped."""
    T, n = tiles.shape
    ok = (tiles >= 0) & (tiles < hist_size)
    flat = tiles.long() + hist_size * torch.arange(
        T, device=tiles.device)[:, None]
    counts = torch.bincount(flat[ok], minlength=T * hist_size)
    return counts.to(torch.int32).reshape(T, hist_size)


def _padded(n: int, tiles: int, what: str) -> int:
    """n padded to a multiple of ``tiles`` (BORDER_REFLECT_101 needs the
    padding to be shorter than n)."""
    if tiles < 1:
        raise ValueError(f"image_tile_histograms: {tiles} tiles along {what}")
    pad = (-n) % tiles
    if pad and pad >= n:
        raise ValueError(f"image_tile_histograms: {n} pixels along {what} "
                         f"cannot be reflect-padded to {tiles} tiles")
    return n + pad


def tile_keys(img: torch.Tensor, tiles_y: int, tiles_x: int,
              hist_size: int) -> torch.Tensor:
    """tile * hist_size + value of every pixel of the BORDER_REFLECT_101-
    padded (h, w) image whose value lies in [0, hist_size), tile t = ty *
    tiles_x + tx: the keys kernel B5 counts (int64, flat)."""
    h, w = img.shape
    ph, pw = _padded(h, tiles_y, "y"), _padded(w, tiles_x, "x")
    th, tw = ph // tiles_y, pw // tiles_x
    dev = img.device
    r = torch.arange(ph, device=dev)
    c = torch.arange(pw, device=dev)
    src_r = torch.where(r < h, r, 2 * h - 2 - r)
    src_c = torch.where(c < w, c, 2 * w - 2 - c)
    vals = widen(img)[src_r][:, src_c].long()                # (ph, pw)
    tile = (r // th)[:, None] * tiles_x + (c // tw)[None, :]
    ok = (vals >= 0) & (vals < hist_size)
    return (tile * hist_size + vals)[ok]


def image_tile_histograms_plain(img: torch.Tensor, tiles_y: int,
                                tiles_x: int, hist_size: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B5 on an image: every pixel of the
    padded image counted into its tile's histogram (``tile_keys``) ->
    (T, hist_size) int32, the counts of cv2's CLAHE tiles."""
    counts = torch.bincount(tile_keys(img, tiles_y, tiles_x, hist_size),
                            minlength=tiles_y * tiles_x * hist_size)
    return counts.to(torch.int32).reshape(tiles_y * tiles_x, hist_size)


def _launch_hist(img: torch.Tensor, tiles_y: int, tiles_x: int,
                 hist_size: int) -> torch.Tensor:
    """One launch of kernel B5 on a CUDA image (checked by the callers),
    its grid sized from the card."""
    out = torch.empty((tiles_y * tiles_x, hist_size), dtype=torch.int32,
                      device=img.device)
    with torch.cuda.device(img.device):
        rc = cuda_build.lib().solex_tile_hist(
            img.data_ptr(), img.element_size(), img.shape[0], img.shape[1],
            tiles_y, tiles_x, hist_size, out.data_ptr(),
            cuda_build.stream_handle(img.device))
    cuda_build.check(rc, "tile_hist")
    cuda_build.LAUNCHES["tile_hist"] += 1
    return out


def _check_cuda(img: torch.Tensor, name: str) -> None:
    if img.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {img.device}")
    if not img.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")


def image_tile_histograms(img: torch.Tensor, tiles_y: int, tiles_x: int,
                          hist_size: int) -> torch.Tensor:
    """Exact value histograms of cv2's CLAHE tiles of an (h, w) u8/u16
    image (BORDER_REFLECT_101 padding to a multiple of the grid included)
    -> (tiles_y * tiles_x, hist_size) int32.  Kernel B5 on CUDA tensors,
    reading the image in place; the plain version on CPU tensors."""
    if img.ndim != 2 or img.dtype not in _HIST_DTYPES:
        raise TypeError(f"image_tile_histograms: (h, w) u8/u16/int32 image "
                        f"expected, got {tuple(img.shape)} {img.dtype}")
    h, w = img.shape
    ph, pw = _padded(h, tiles_y, "y"), _padded(w, tiles_x, "x")
    if not (0 < tiles_y * tiles_x <= 65535 and ph * pw // (tiles_y * tiles_x)
            < (1 << 30) and 0 < hist_size <= (1 << 24)):
        raise ValueError(f"image_tile_histograms: image {h}x{w}, tiles "
                         f"{tiles_y}x{tiles_x}, hist_size={hist_size} out "
                         f"of range")
    if img.device.type == "cpu":
        return image_tile_histograms_plain(img, tiles_y, tiles_x, hist_size)
    _check_cuda(img, "image_tile_histograms")
    return _launch_hist(img, tiles_y, tiles_x, hist_size)


def tile_histograms(tiles: torch.Tensor, hist_size: int) -> torch.Tensor:
    """Histograms of (T, n) int32 tiles: kernel B5 (one 1-row tile per row
    of the tensor) on CUDA tensors, the plain version on CPU tensors."""
    if tiles.dtype != torch.int32 or tiles.ndim != 2:
        raise TypeError("tile_histograms: tiles must be (T, n) int32")
    T, n = tiles.shape
    if not (0 < T <= 65535 and 0 < n < (1 << 30) and 0 < hist_size <= (1 << 24)):
        raise ValueError(f"tile_histograms: T={T}, n={n}, "
                         f"hist_size={hist_size} out of range")
    if tiles.device.type == "cpu":
        return tile_histograms_plain(tiles, hist_size)
    _check_cuda(tiles, "tile_histograms")
    return _launch_hist(tiles, T, 1, hist_size)


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
    return image_tile_histograms(img, 1, 1, hist_size)[0]


def _clahe(img: torch.Tensor, clip_limit: float, tiles_x: int,
                tiles_y: int, hist_size: int, return_full_hist: bool = False):
    """cv2 CLAHE of an integer image -> float32 values (and, on request,
    the image's exact value histogram when the grid needs no padding,
    else None)."""
    h, w = img.shape
    pad_r = (-w) % tiles_x
    pad_b = (-h) % tiles_y
    th, tw = (h + pad_b) // tiles_y, (w + pad_r) // tiles_x
    tile_area = th * tw
    lut_scale = _f32(np.float32(hist_size - 1) / np.float32(tile_area))
    clip = max(int(clip_limit * tile_area / hist_size), 1) if clip_limit > 0 else 0

    # step 2 on the image in place: kernel B5 pads and tiles it itself
    hist = image_tile_histograms(img, tiles_y, tiles_x, hist_size)
    vals = widen(img)                                       # for the LUTs
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
