"""Masked per-row robust statistics for the transversalium correction.

Counterpart of solex_ser_recon_en_tpu/ops/rowstats.py.  reference:
solex_util.py:383-395 — inside the fitted solar circle, the MAD-outlier-
rejected mean of the row-pair log ratio (reject_outliers, m=2), computed
for all rows at once: masked per-row medians come from one row sort with
masked entries pushed to +inf.

0/0 pixels give NaN log-ratios.  They stay counted in the row's valid
count and sort after +inf (torch.sort, like jnp.sort and np.sort, puts
NaN last), so the order statistics match the JAX package's exactly.

``row_stats`` is the entry point: on CUDA tensors one launch of
csrc/rowstats.cu (the chord from the geometry, the log ratio, the medians
by radix selection, the sums), on CPU tensors the plain twin
``strip_mask`` + ``row_log_ratio_stats``.  ``ROW_STATS_LAUNCHES`` counts
the calls by path.  ``apply_row_gain`` multiplies the rows by the gain
the statistics give: csrc/products.cu's row gain on CUDA tensors, its
plain twin on CPU tensors.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import cuda_build
from .dtypes import as_f32, to_u16

#: calls of ``row_stats`` by path: ``kernel`` (CUDA tensors, one launch
#: each) or ``plain`` (CPU tensors); reset by callers that count one run
ROW_STATS_LAUNCHES = {"kernel": 0, "plain": 0}
_count_lock = threading.Lock()


def _count(path: str) -> None:
    with _count_lock:          # a session posts from its pool thread
        ROW_STATS_LAUNCHES[path] += 1


def _masked_row_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """np.median per row over the valid entries (average of middles)."""
    big = torch.where(valid, x, torch.tensor(float("inf"), device=x.device))
    s = torch.sort(big, dim=1).values
    n = valid.sum(dim=1)
    lo_i = torch.clamp((n - 1) // 2, min=0)
    hi_i = torch.clamp(n // 2, min=0)
    lo = torch.gather(s, 1, lo_i[:, None])[:, 0]
    hi = torch.gather(s, 1, hi_i[:, None])[:, 0]
    med = 0.5 * (lo + hi)
    return torch.where(n > 0, med, torch.zeros_like(med))


def strip_mask(h: int, w: int, circle, borders, device):
    """Inside-circle row strips intersected with borders, float32 geometry.

    Returns (valid (H, W) bool, y1, y2): valid[y] covers x in
    [ceil(max(cx-dx, bx0)), floor(min(cx+dx, bx2))) for rows y1 < y < y2,
    dx = floor(sqrt(r^2-(y-cy)^2))  (solex_util.py:384-391).
    """
    c = torch.as_tensor(circle, dtype=torch.float32, device=device)
    b = torch.as_tensor(borders, dtype=torch.float32, device=device)
    cx, cy, r = c[0], c[1], c[2]
    bx0, by1, bx2, by3 = b[0], b[1], b[2], b[3]
    y1 = torch.ceil(torch.maximum(cy - r, by1))
    y2 = torch.floor(torch.minimum(cy + r, by3))
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    d2 = r * r - (ys - cy) * (ys - cy)
    dx = torch.floor(torch.sqrt(torch.clamp(d2, min=0.0)))
    x_lo = torch.ceil(torch.maximum(cx - dx, bx0))
    x_hi = torch.floor(torch.minimum(cx + dx, bx2))
    row_ok = (ys > y1) & (ys < y2) & (d2 >= 0.0)
    valid = (
        row_ok[:, None]
        & (xs[None, :] >= x_lo[:, None])
        & (xs[None, :] < x_hi[:, None])
    )
    return valid, y1.to(torch.int32), y2.to(torch.int32)


def row_log_ratio_stats(img: torch.Tensor, valid: torch.Tensor,
                        detail: bool = False):
    """Per-row (mean, MAD-rejected mean) of log(img[y]/img[y-1]) over the
    valid strip; rows with no valid pixels give 0.  ``img`` is an integer
    image or a float one (the de-vignetted frame), taken as float32.
    ``detail`` adds a dict of the rows' median, MAD and kept count."""
    f = as_f32(img)
    prev = torch.cat([f[:1], f[:-1]], dim=0)
    rat = torch.log(f / prev)
    zero = torch.zeros((), dtype=torch.float32, device=f.device)
    rat = torch.where(valid, rat, zero)

    n = valid.sum(dim=1)
    mean_all = torch.where(n > 0, rat.sum(dim=1) / torch.clamp(n, min=1), zero)

    med = _masked_row_median(rat, valid)
    d = torch.abs(rat - med[:, None])
    mdev = _masked_row_median(d, valid)
    s = torch.where(mdev[:, None] > 0,
                    d / torch.clamp(mdev[:, None], min=1e-30), zero)
    keep = valid & (s < 2.0)
    nk = keep.sum(dim=1)
    mean_r = torch.where(
        nk > 0,
        torch.where(keep, rat, zero).sum(dim=1) / torch.clamp(nk, min=1),
        zero,
    )
    if detail:
        return mean_all, mean_r, {"med": med, "mdev": mdev, "nk": nk}
    return mean_all, mean_r


def row_stats(img: torch.Tensor, circle, borders):
    """(mean_all, mean_r), (H,) float32 on the image's device: the row
    statistics of ``row_log_ratio_stats`` over ``strip_mask``'s chords of
    the circle (cx, cy, r) and borders (x0, y1, x2, y3), both taken as
    float32.  ``img`` is (H, W), integer or float.  The kernel on CUDA
    tensors, the plain twin on CPU tensors."""
    if img.device.type == "cuda":
        return _launch_row_stats(img, circle, borders)
    if img.device.type != "cpu":
        raise ValueError(f"row_stats: unsupported device {img.device}")
    _count("plain")
    h, w = img.shape
    valid, _, _ = strip_mask(h, w, np.asarray(circle, dtype=np.float32),
                             np.asarray(borders, dtype=np.float32),
                             img.device)
    return row_log_ratio_stats(img, valid)


def _launch_row_stats(img: torch.Tensor, circle, borders,
                      detail: bool = False):
    """One launch of csrc/rowstats.cu on a CUDA image: u16 and float32
    read in place, any other dtype through ``as_f32`` (the same values).
    ``detail`` adds a dict of the kernel's chord bounds (clipped to
    [0, W]), row_ok, median, MAD and kept count, row by row."""
    src = img if img.dtype in (torch.uint16, torch.float32) else as_f32(img)
    src = src.contiguous()
    h, w = src.shape
    dev = src.device
    out = torch.empty((2, h), dtype=torch.float32, device=dev)
    ws = (torch.empty((h, w), dtype=torch.float32, device=dev)
          if w > cuda_build.ROW_STATS_STAGE_FLOATS else None)
    dbg_i = torch.empty((h, 4), dtype=torch.int32, device=dev) if detail \
        else None
    dbg_f = torch.empty((h, 2), dtype=torch.float32, device=dev) if detail \
        else None
    geometry = [float(v) for v in np.concatenate([
        np.asarray(circle, dtype=np.float32)[:3],
        np.asarray(borders, dtype=np.float32)[:4]])]
    with torch.cuda.device(dev):
        rc = cuda_build.lib().solex_row_stats(
            src.data_ptr(), src.element_size(), h, w, *geometry,
            out[0].data_ptr(), out[1].data_ptr(),
            *(None if t is None else t.data_ptr() for t in (ws, dbg_i, dbg_f)),
            cuda_build.stream_handle(dev))
    cuda_build.check(rc, "row_stats")
    _count("kernel")
    if not detail:
        return out[0], out[1]
    return out[0], out[1], {
        "x_lo": dbg_i[:, 0], "x_hi": dbg_i[:, 1], "row_ok": dbg_i[:, 2] != 0,
        "nk": dbg_i[:, 3].to(torch.int64), "med": dbg_f[:, 0],
        "mdev": dbg_f[:, 1]}


def _apply_row_gain_plain(img: torch.Tensor,
                          gain: torch.Tensor) -> torch.Tensor:
    """The row gain's plain twin: float32 multiply, clamp, truncation."""
    out = as_f32(img) * gain.to(torch.float32)[:, None]
    return to_u16(torch.clamp(out, 0, 65535))


def _launch_row_gain(img: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/products.cu's row gain on a CUDA image: u16 and
    float32 read in place, any other dtype through ``as_f32`` (the twin's
    float32 values)."""
    src = img if img.dtype in (torch.uint16, torch.float32) else as_f32(img)
    src = src.contiguous()
    h, w = src.shape
    dev = src.device
    g = gain.to(device=dev, dtype=torch.float32).contiguous()
    if g.shape != (h,):
        raise ValueError(f"apply_row_gain: a gain of shape {tuple(g.shape)} "
                         f"for {h} rows")
    out = torch.empty((h, w), dtype=torch.uint16, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = cuda_build.lib().solex_row_gain(
            src.data_ptr(), src.element_size(), h, w, g.data_ptr(),
            out.data_ptr(), cuda_build.stream_handle(dev))
    cuda_build.check(rc, "row_gain")
    cuda_build.count_launch("row_gain")
    return out


def apply_row_gain(img: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """img * gain[:, None] in float32, clipped to uint16
    (solex_util.py:489,515-516); ``img`` integer or float.  One kernel
    launch on CUDA tensors (csrc/products.cu), the plain twin on CPU
    tensors, bit for bit the same."""
    if img.device.type == "cuda":
        return _launch_row_gain(img, gain)
    if img.device.type != "cpu":
        raise ValueError(f"apply_row_gain: unsupported device {img.device}")
    return _apply_row_gain_plain(img, gain)
