"""Bilinear resize of a uint16 image, as ``cv2.resize(img, (0, 0), fx=f,
fy=f)`` (INTER_LINEAR) gives it, in plain torch on the image's device.

reference: the analyser's preview downscale (spectralAnalyserUI.py:161-162,
solex_util.py:89-90).  OpenCV's rules, reproduced:

- the output size is ``round(n * f)`` (round half to even);
- source coordinate ``(d + 0.5) / f - 0.5``, split into ``floor`` and a
  fraction in double, the weights kept as float32; a coordinate left of
  the first pixel reads the first pixel, one at or past the last reads
  the last;
- a horizontal pass, then a vertical one, in float32, rounded to the
  nearest integer (half to even) and saturated;
- a scale of exactly 1/2 on both axes is INTER_AREA instead: the mean of
  each 2 x 2 block (of its pixels inside the image, at an odd edge),
  rounded half to even.

OpenCV's wheels resize 16-bit images through Intel IPP by default, whose
coordinates and area rounding are those above: this version is within
1 LSB of it on < 1% of pixels (tests/test_torch_analyser.py).  OpenCV's
own code (IPP off) keeps the coordinate in float32 and rounds the area
mean half up, up to 2 LSB away.

The JAX package calls cv2 itself (solex_ser_recon_en_tpu/analyser/core.py:
_downscale) and falls back to a nearest-index pick where cv2 is absent;
that fallback is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .dtypes import widen


def _taps(n_in: int, n_out: int, f: float):
    """(left index, right index, right weight) of each output position."""
    x = (np.arange(n_out) + 0.5) * (1.0 / f) - 0.5
    i = np.floor(x)
    frac = (x - i).astype(np.float32)
    i = i.astype(np.int64)
    frac[i < 0] = 0
    i[i < 0] = 0
    last = i >= n_in - 1
    frac[last] = 0
    i[last] = n_in - 1
    return i, np.minimum(i + 1, n_in - 1), frac


def resize_linear(img: torch.Tensor, f: float) -> torch.Tensor:
    """(h, w) uint16 -> (round(h f), round(w f)) uint16, as cv2.resize
    with fx = fy = f and INTER_LINEAR."""
    h, w = img.shape
    oh, ow = int(np.rint(h * f)), int(np.rint(w * f))
    dev = img.device
    v = widen(img)
    if 1.0 / f == 2.0:
        # OpenCV's INTER_AREA fast path for an exact 1/2 on both axes
        ph, pw = max(2 * oh - h, 0), max(2 * ow - w, 0)
        v = F.pad(v[:2 * oh, :2 * ow], (0, pw, 0, ph))
        n = F.pad(torch.ones((h, w), dtype=torch.int32, device=dev)[
            :2 * oh, :2 * ow], (0, pw, 0, ph))
        q, n = (x.reshape(oh, 2, ow, 2).sum(dim=(1, 3)) for x in (v, n))
        return torch.round(q.to(torch.float32) / n).to(torch.int32).to(
            torch.uint16)
    x0, x1, fx = _taps(w, ow, f)
    y0, y1, fy = _taps(h, oh, f)

    def t(a):
        return torch.from_numpy(a).to(dev)

    v = v.to(torch.float32)
    ax = t(fx)[None, :]
    rows = v[:, t(x0)] * (1 - ax) + v[:, t(x1)] * ax         # (h, ow)
    ay = t(fy)[:, None]
    out = rows[t(y0)] * (1 - ay) + rows[t(y1)] * ay          # (oh, ow)
    return torch.clamp(torch.round(out), 0, 65535).to(torch.int32).to(
        torch.uint16)
