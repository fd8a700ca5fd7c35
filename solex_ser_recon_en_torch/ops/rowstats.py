"""Masked per-row robust statistics for the transversalium correction.

Counterpart of solex_ser_recon_en_tpu/ops/rowstats.py.  reference:
solex_util.py:383-395 — inside the fitted solar circle, the MAD-outlier-
rejected mean of the row-pair log ratio (reject_outliers, m=2), computed
for all rows at once: masked per-row medians come from one row sort with
masked entries pushed to +inf.

0/0 pixels give NaN log-ratios.  They stay counted in the row's valid
count and sort after +inf (torch.sort, like jnp.sort and np.sort, puts
NaN last), so the order statistics match the JAX package's exactly.
"""

from __future__ import annotations

import torch

from .dtypes import as_f32, to_u16


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


def row_log_ratio_stats(img: torch.Tensor, valid: torch.Tensor):
    """Per-row (mean, MAD-rejected mean) of log(img[y]/img[y-1]) over the
    valid strip; rows with no valid pixels give 0.  ``img`` is an integer
    image or a float one (the de-vignetted frame), taken as float32."""
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
    return mean_all, mean_r


def apply_row_gain(img: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """img * gain[:, None] in float32, clipped to uint16
    (solex_util.py:489,515-516); ``img`` integer or float."""
    out = as_f32(img) * gain.to(torch.float32)[:, None]
    return to_u16(torch.clamp(out, 0, 65535))
