"""CLAHE, histograms and percentiles of the PyTorch port vs the JAX
package and OpenCV (CPU).

Kernel B5 (csrc/hist.cu) runs only on the card; its plain version is held
here against the JAX Pallas histogram kernel in interpret mode (exact).
CLAHE tolerance: the final bilinear LUT blend is float32 and rounds
half-to-even, so a value within an ulp of .5 can round either way between
two evaluations that round differently — XLA:CPU contracts the blend's
products and sums into FMAs, OpenCV associates it differently.  The JAX
package holds itself to cv2 within 1 LSB on < 2% of pixels
(tests/test_clahe.py); the port is held to the same against cv2 and to
1 LSB on < 1% of pixels against JAX.
"""

import importlib


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solex_ser_recon_en_torch.ops import cuda_build
from solex_ser_recon_en_torch.ops.clahe import (
    _clip_redistribute,
    clahe,
    image_tile_histograms,
    percentile_from_hist,
    tile_histograms,
    tile_histograms_plain,
    value_histogram,
)

from torch_parity import lsb_diff, t

jax_clahe_mod = importlib.import_module("solex_ser_recon_en_tpu.ops.clahe")


@pytest.mark.parametrize("hist_size,hi", [(65536, 65536), (256, 256)])
def test_plain_histogram_matches_pallas_kernel(rng, hist_size, hi):
    tiles = rng.integers(0, hi, (3, 5000), dtype=np.int64).astype(np.int32)
    tiles[1, -300:] = -1  # padding slots count nowhere
    ref = np.asarray(jax_clahe_mod._tile_histograms_mxu(jnp.asarray(tiles),
                                                        hist_size))
    before = cuda_build.LAUNCHES["tile_hist"]
    ours = tile_histograms(t(tiles), hist_size).numpy()
    assert cuda_build.LAUNCHES["tile_hist"] == before  # CPU: no launch
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum(axis=1).tolist() == [5000, 4700, 5000]


def _padded_tiles(img, tiles_y, tiles_x):
    """cv2's CLAHE tiles of ``img`` made the old way, in numpy: pad with
    BORDER_REFLECT_101 (numpy's "reflect"), permute to (T, tile_area)."""
    h, w = img.shape
    pad_b, pad_r = (-h) % tiles_y, (-w) % tiles_x
    src = np.pad(img.astype(np.int32), ((0, pad_b), (0, pad_r)),
                 mode="reflect")
    th, tw = src.shape[0] // tiles_y, src.shape[1] // tiles_x
    return np.ascontiguousarray(
        src.reshape(tiles_y, th, tiles_x, tw).transpose(0, 2, 1, 3)
        .reshape(tiles_y * tiles_x, th * tw))


# even, odd; then tiles that lie wholly in the reflected padding at 8x8
# (padding of 7 columns or rows, tiles of 4)
@pytest.mark.parametrize("shape", [(40, 36), (37, 29), (40, 25), (25, 40)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("grid", [(2, 2), (8, 8)])
def test_image_tile_histograms_match_padded_tiles(rng, shape, dtype, grid):
    """Kernel B5's image form (its plain version: each pixel's tile and
    reflected source worked out per pixel) equals the histograms of the
    padded, permuted int32 tiles, and the JAX Pallas kernel on them."""
    hi = 256 if dtype == np.uint8 else 65536
    img = rng.integers(0, hi, shape).astype(dtype)
    img[:5, :7] = 3                               # a hot value
    ty, tx = grid
    tiles = _padded_tiles(img, ty, tx)
    before = cuda_build.LAUNCHES["tile_hist"]
    ours = image_tile_histograms(t(img), ty, tx, hi).numpy()
    assert cuda_build.LAUNCHES["tile_hist"] == before  # CPU: no launch
    np.testing.assert_array_equal(ours,
                                  tile_histograms_plain(t(tiles), hi).numpy())
    ref = np.asarray(jax_clahe_mod._tile_histograms_mxu(jnp.asarray(tiles),
                                                        hi))
    np.testing.assert_array_equal(ours, ref)
    assert ours.shape == (ty * tx, hi)
    assert (ours.sum(axis=1) == tiles.shape[1]).all()


def test_image_tile_histograms_refuses_what_cannot_be_padded():
    with pytest.raises(ValueError, match="reflect-padded"):
        image_tile_histograms(torch.zeros((2, 9), dtype=torch.uint16),
                              4, 2, 65536)
    with pytest.raises(TypeError):
        image_tile_histograms(torch.zeros((4, 4), dtype=torch.float32),
                              2, 2, 65536)
    with pytest.raises(ValueError, match="unsupported device"):
        image_tile_histograms(torch.zeros((4, 4), dtype=torch.uint16,
                                          device="meta"), 2, 2, 65536)


def test_value_histogram_exact(rng):
    img = rng.integers(0, 65536, (70, 33)).astype(np.uint16)
    np.testing.assert_array_equal(
        value_histogram(t(img), 65536).numpy(),
        np.bincount(img.ravel(), minlength=65536))


def test_clip_redistribute_matches_jax(rng):
    hist = rng.integers(0, 40, (4, 65536)).astype(np.int32)
    hist[:, :50] += 5000
    for clip in (1, 7, 33):
        ref = np.asarray(jax_clahe_mod._clip_redistribute(
            jnp.asarray(hist), jnp.int32(clip), 65536))
        np.testing.assert_array_equal(
            _clip_redistribute(t(hist), clip, 65536).numpy(), ref)


CLAHE_CASES = [  # shape, dtype, tiles, clip limit
    ((64, 48), np.uint16, (2, 2), 0.8),
    ((101, 67), np.uint16, (2, 2), 0.8),     # reflect-padded grid
    ((100, 90), np.uint16, (2, 2), 0.8),     # the product config
    ((64, 80), np.uint8, (4, 4), 2.0),
    ((128, 160), np.uint8, (16, 16), 2.0),
]


@pytest.mark.parametrize("shape,dtype,tiles,clip", CLAHE_CASES)
def test_clahe_matches_jax_and_cv2(rng, shape, dtype, tiles, clip):
    hi = 256 if dtype == np.uint8 else 65536
    img = rng.integers(0, hi, shape).astype(dtype)
    ours = clahe(t(img), clip_limit=clip, tiles=tiles)
    assert ours.dtype == (torch.uint8 if dtype == np.uint8 else torch.uint16)
    ours = ours.numpy()
    ref = np.asarray(jax_clahe_mod.clahe(img, clip_limit=clip, tiles=tiles))
    mx, frac = lsb_diff(ours, ref)
    assert mx <= 1 and frac < 0.01
    cv2 = pytest.importorskip("cv2")
    ref_cv = cv2.createCLAHE(clipLimit=clip, tileGridSize=tiles).apply(img)
    mx, frac = lsb_diff(ours, ref_cv)
    assert mx <= 1 and frac < 0.02


def test_percentile_from_hist_bit_exact(rng):
    """Fuzzed histograms and quantiles: the port's float32 result equals
    the JAX function's bit for bit."""
    for _ in range(60):
        n = int(rng.integers(1, 100000))
        vals = rng.integers(0, int(rng.choice([10, 300, 65536])), n)
        hist = np.bincount(vals, minlength=65536).astype(np.int32)
        q = float(rng.choice([10.0, 99.9999, 33.3, 0.0, 100.0,
                              rng.uniform(0, 100)]))
        ref = np.float32(jax_clahe_mod.percentile_from_hist(
            jnp.asarray(hist), n, q))
        ours = percentile_from_hist(t(hist), n, q)
        assert ours.dtype == torch.float32
        assert np.float32(ours.item()) == ref, (n, q)


def test_clahe_rejects_bad_dtype():
    with pytest.raises(TypeError):
        clahe(torch.zeros((8, 8), dtype=torch.float32))
