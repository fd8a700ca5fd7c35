"""Shared helpers of the test_torch_* parity tests (PyTorch port vs the
JAX package on the same numpy inputs)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (decided
    when the test runs, never at import, so every worker collects the same
    tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU interpret mode)")
    return torch.device("cuda")


def t(a, device="cpu") -> torch.Tensor:
    """numpy (or JAX) array -> torch tensor (copied)."""
    return torch.from_numpy(np.array(np.asarray(a), copy=True)).to(device)


def lsb_diff(a, b):
    """(max |a-b|, fraction of differing entries) of integer images."""
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return int(d.max()), float((d > 0).mean())


def flooded_ellipse(h: int, w: int, seed: int) -> np.ndarray:
    """A 0/65000 float32 ellipse, as the ellipse fit floods its disk: a
    random centre, axes and tilt from ``seed``."""
    rng = np.random.default_rng(seed)
    cy, cx = h / 2 + rng.uniform(-5, 5), w / 2 + rng.uniform(-5, 5)
    a, b = rng.uniform(0.3, 0.42) * h, rng.uniform(0.3, 0.42) * w
    tilt = rng.uniform(0, np.pi)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    u = ((x - cx) * np.cos(tilt) + (y - cy) * np.sin(tilt)) / b
    v = (-(x - cx) * np.sin(tilt) + (y - cy) * np.cos(tilt)) / a
    return np.where(u * u + v * v <= 1, 65000.0, 0.0).astype(np.float32)


def graded_ellipse(h: int, w: int, seed: int) -> np.ndarray:
    """The flooded ellipse with a brightness gradient across it and
    Gaussian noise (sigma 300), clipped at 0: no exact ties."""
    f = flooded_ellipse(h, w, seed)
    rng = np.random.default_rng(seed + 1000)
    x = np.arange(w, dtype=np.float32)[None, :]
    g = f * (0.6 + 0.4 * np.cos(x / w * 3)) + rng.normal(
        0, 300, (h, w)).astype(np.float32)
    return np.clip(g, 0, None).astype(np.float32)


def halfway_ellipse(h: int, w: int, seed: int) -> np.ndarray:
    """The flooded ellipse at 0/65536: its blur's float64 sums fall halfway
    between two float32 values, so the twin redoes both passes exactly
    (ops/canny.py:_conv1d)."""
    return (flooded_ellipse(h, w, seed) > 0).astype(np.float32) * 65536.0


def weak_snake(h: int = 300, w: int = 600):
    """(image, thresholds, band rows): a 4-pixel band of 1.0 winding across
    the image in rows 24 apart, joined at alternate ends, ramped up to 4.0
    over its first 60 pixels.  At sigma 1.0 and the thresholds only the
    ramp's edges are strong; every other edge is weak, joined to them along
    the whole band, so the hysteresis must cross the image many times."""
    band, pitch = 4, 24
    img = np.zeros((h, w), np.float32)
    rows = list(range(20, h - 20 - band, pitch))
    for j, y in enumerate(rows):
        img[y:y + band, 20:w - 20] = 1.0
        if j + 1 < len(rows):
            x = 20 if j % 2 else w - 20 - band
            img[y:rows[j + 1] + band, x:x + band] = 1.0
    img[rows[0]:rows[0] + band, 20:80] = np.linspace(4.0, 1.0, 60,
                                                     dtype=np.float32)
    return img, (1.0, 5.0), rows


def limb_darkened_disk(h: int, w: int, seed: int) -> np.ndarray:
    """A uint16 disk image of the bench scan's kind: an ellipse of Y/X
    1.08 tilted by up to 10 degrees, limb-darkened (0.4 + 0.6 mu) on a
    600-count sky, Gaussian noise of 150 counts."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = h / 2 + rng.uniform(-20, 20), w / 2 + rng.uniform(-20, 20)
    a = 0.40 * h
    b = a / 1.08
    tilt = np.deg2rad(rng.uniform(-10, 10))
    u = ((x - cx) * np.cos(tilt) + (y - cy) * np.sin(tilt)) / b
    v = (-(x - cx) * np.sin(tilt) + (y - cy) * np.cos(tilt)) / a
    r2 = u * u + v * v
    mu = np.sqrt(np.clip(1 - r2, 0, 1))
    img = np.where(r2 <= 1, 30000 * (0.4 + 0.6 * mu), 600.0)
    img = img + rng.normal(0, 150, img.shape)
    return np.clip(np.round(img), 0, 65535).astype(np.uint16)


def bench_product(seed: int, h: int = 2048, w: int = 2204):
    """The bench scan's product and its row gain: ``limb_darkened_disk``
    with row stripes of +-2% and a few saturated pixels, u16, and a
    transversalium row gain of about 1 +- 0.03, float32."""
    rng = np.random.default_rng(seed + 1000)
    stripes = 1 + 0.02 * np.sin(np.arange(h) / 3.0)[:, None]
    img = np.clip(np.round(limb_darkened_disk(h, w, seed) * stripes), 0,
                  65535).astype(np.uint16)
    img[rng.integers(0, h, 40), rng.integers(0, w, 40)] = 65535
    gain = (1 + 0.03 * np.sin(np.arange(h) / 7.0)
            + rng.normal(0, 0.002, h)).astype(np.float32)
    return img, gain
