"""The product chain's arithmetic (csrc/products.cuh) against the plain twin
(pipeline/products.py, ops/clahe.py, ops/rowstats.py), on the CPU.

csrc/products.cu runs on the card only, but its arithmetic lives in a
header that the host library builds too (csrc/products.cpp, g++ with
contraction off), behind entry points that take the card's arguments: here
that build is held to the twin bit for bit, step by step (the row gain, the
LUTs with their clip and redistribution, the blend, the stretches' limits
and the stretches) and over the whole chain, with kernel B5's histograms
from its plain version.  The card's threads and clusters are tested on the
card (tests/test_torch_cuda_kernels.py).  Also here: the CPU path is the
twin, counted ``plain``, and another device raises.
"""

import numpy as np
import pytest
import torch

from solex_ser_recon_en_torch.io import native
from solex_ser_recon_en_torch.ops import clahe, rowstats
from solex_ser_recon_en_torch.pipeline import products

from torch_parity import bench_product


def _ptr(a):
    return None if a is None else a.ctypes.data


def host_row_gain(img, gain):
    """solex_row_gain_host of a u16 or float32 image; any other dtype as
    float32, as the card's wrapper takes it."""
    with np.errstate(over="ignore"):      # 1e300 is inf in float32
        img = np.ascontiguousarray(img if img.dtype == np.uint16
                                   else img.astype(np.float32))
    gain = np.ascontiguousarray(gain, dtype=np.float32)
    out = np.empty(img.shape, np.uint16)
    assert native.get_lib().solex_row_gain_host(
        img.ctypes.data, img.itemsize, *img.shape, gain.ctypes.data,
        out.ctypes.data) == 0
    return out


def host_luts(hist, clip, scale, full=False):
    """(LUTs u16, the tiles' sum or None) of solex_clahe_lut_host."""
    hist = np.ascontiguousarray(hist, dtype=np.int32)
    tiles, hist_size = hist.shape
    luts = np.empty((tiles, hist_size), np.uint16)
    total = np.empty(hist_size, np.int32) if full else None
    assert native.get_lib().solex_clahe_lut_host(
        hist.ctypes.data, tiles, hist_size, clip, scale, luts.ctypes.data,
        _ptr(total)) == 0
    return luts, total


def host_clahe(img, clip_limit, tiles_x, tiles_y, hist_size, full=False):
    """The card's CLAHE on the host: kernel B5's plain version, then the
    host LUTs and blend; (levels, the whole image's histogram or None)."""
    img = np.ascontiguousarray(img)
    h, w = img.shape
    padded, _, _, clip, scale = clahe._clahe_plan(h, w, clip_limit, tiles_x,
                                                  tiles_y, hist_size)
    hist = clahe.image_tile_histograms_plain(torch.from_numpy(img), tiles_y,
                                             tiles_x, hist_size).numpy()
    luts, total = host_luts(hist, clip, scale, full and not padded)
    out = np.empty_like(img)
    assert native.get_lib().solex_clahe_blend_host(
        img.ctypes.data, img.itemsize, h, w, tiles_y, tiles_x, hist_size,
        luts.ctypes.data, out.ctypes.data) == 0
    return out, total


def host_params(hist_c, n, full=None):
    lo, hi, lo_w, hi_w = clahe.percentile_taps(10.0, n)
    f = clahe.percentile_taps(99.9999, n)
    params = np.empty(6, np.float32)
    assert native.get_lib().solex_stretch_params_host(
        np.ascontiguousarray(hist_c, np.int32).ctypes.data,
        lo + 1, hi + 1, lo_w, hi_w,
        _ptr(None if full is None else np.ascontiguousarray(full, np.int32)),
        f[0] + 1, f[1] + 1, f[2], f[3], params.ctypes.data) == 0
    return params


def host_chain(fj, gain=None, want=(True, True)):
    """(detrans, cl1, cc, high_contrast, protus) of the card's launches,
    each on the host."""
    if gain is not None:
        fj = host_row_gain(fj, gain)
    stretched = want[0] or want[1]
    cl1, full = host_clahe(fj, 0.8, 2, 2, 65536, full=stretched)
    hist_c = np.bincount(cl1.ravel(), minlength=65536)
    if stretched and full is None:
        full = np.bincount(fj.ravel(), minlength=65536)
    params = host_params(hist_c, fj.size, full if stretched else None)
    cc = np.empty_like(cl1)
    hc = np.empty_like(fj) if want[0] else None
    pr = np.empty_like(fj) if want[1] else None
    assert native.get_lib().solex_stretch_host(
        cl1.ctypes.data, fj.ctypes.data if stretched else None, fj.size,
        params.ctypes.data, cc.ctypes.data, _ptr(hc), _ptr(pr)) == 0
    return fj, cl1, cc, hc, pr


def assert_same(got, want):
    """Two chains' outputs equal, None where either is."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(
                g, w.numpy() if isinstance(w, torch.Tensor) else w)


def row_gain_case(kind):
    rng = np.random.default_rng(3)
    h, w = 97, 131
    gain = rng.uniform(0.5, 1.5, h).astype(np.float32)
    gain[:4] = [0.0, 1.0, 3e4, -1.0]
    if kind == "f64":       # the de-vignetted frame
        img = rng.uniform(-100, 70000, (h, w))
        img[5, :4] = [np.nan, 1e300, -0.0, 65535.00000001]
        return img, gain
    if kind == "u16":
        img = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        img[10, :6] = [0, 1, 43690, 65534, 65535, 32768]
        return img, gain
    img = (rng.standard_normal((h, w)) * 10.0 ** rng.uniform(-3, 5, (h, w))
           ).astype(np.float32)
    img[20, :8] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 65535.0, 65535.5,
                   1e30]
    return img, gain


@pytest.mark.parametrize("kind", ["f64", "u16", "f32"])
def test_host_row_gain_equals_the_twin(kind):
    """u16(trunc(clamp(f32(v) * g, 0, 65535))): saturation at both ends,
    a gain of 0, a negative gain, NaN and infinities of a float image (NaN
    to 0 on both), and a float64 image rounded to float32 first."""
    img, gain = row_gain_case(kind)
    want = rowstats._apply_row_gain_plain(torch.from_numpy(img),
                                          torch.from_numpy(gain))
    np.testing.assert_array_equal(host_row_gain(img, gain), want.numpy())


def tile_hist_case(hist_size, tiles, seed):
    """Tile histograms with tall peaks (the clip's excess), long empty runs
    and a tile of one value."""
    rng = np.random.default_rng(seed)
    hist = rng.poisson(rng.uniform(0, 40, (tiles, 1)),
                       (tiles, hist_size)).astype(np.int32)
    hist[:, rng.integers(0, hist_size, 12)] += rng.integers(
        0, 50_000, (tiles, 12)).astype(np.int32)
    hist[0, hist_size // 3: hist_size // 2] = 0
    if tiles > 1:
        hist[-1] = 0
        hist[-1, 7 % hist_size] = 123_457
    return hist


@pytest.mark.parametrize("clip_limit", [0.0, 0.8, 40.0])
@pytest.mark.parametrize("hist_size,tiles,shape", [
    (65536, 4, (2048, 2204)), (65536, 1, (301, 257)), (65536, 15, (600, 1024)),
    (256, 1, (300, 260)), (256, 4, (301, 257)), (256, 16, (2048, 2204))],
    ids=lambda v: str(v))
def test_host_luts_equal_the_twin(hist_size, tiles, shape, clip_limit):
    """The clip (none at 0), the excess's uniform batch and its residual
    spread every step-th bin, the cumsum and the rounded levels; the
    tiles' sum."""
    h, w = shape
    side = int(np.sqrt(tiles)) if tiles in (1, 4, 16) else None
    ty, tx = (side, side) if side else (3, 5)
    _, _, _, clip, scale = clahe._clahe_plan(h, w, clip_limit, tx, ty,
                                             hist_size)
    hist = tile_hist_case(hist_size, tiles, tiles + hist_size)
    luts, total = host_luts(hist, clip, scale, full=True)
    want = clahe._clahe_luts_plain(torch.from_numpy(hist), clip, scale,
                                   hist_size)
    np.testing.assert_array_equal(luts.astype(np.int32), want.numpy())
    np.testing.assert_array_equal(total, hist.sum(axis=0, dtype=np.int32))
    assert clip_limit == 0 or clip > 0


def u8_image(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[:100, :80] = 3
    return img


@pytest.mark.parametrize("clip_limit", [0.0, 0.8])
@pytest.mark.parametrize("tiles", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(300, 260), (301, 257)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_host_clahe_u8_256_bins_equals_the_twin(shape, tiles, clip_limit):
    """The CLAHE tool's case: an 8-bit image, 256 bins, 1-4 tiles a side,
    reflect padding where the grid does not divide the image."""
    img = u8_image(shape, tiles)
    got, _ = host_clahe(img, clip_limit, tiles, tiles, 256)
    want = clahe.clahe_levels(torch.from_numpy(img), clip_limit, tiles,
                              tiles, 256)
    assert want.dtype == torch.uint8
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("clip_limit", [0.0, 0.8])
@pytest.mark.parametrize("shape", [(2048, 2204), (600, 1024), (301, 257)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_host_clahe_u16_equals_the_twin(shape, clip_limit):
    """The products' CLAHE (65536 bins, 2 x 2 tiles) on the bench
    product's size and smaller and odd ones; the whole image's histogram
    where the grid pads nothing."""
    img, _ = bench_product(1, *shape)
    got, full = host_clahe(img, clip_limit, 2, 2, 65536, full=True)
    want, want_full = clahe.clahe_levels(torch.from_numpy(img), clip_limit,
                                         2, 2, 65536, return_full_hist=True)
    np.testing.assert_array_equal(got, want.numpy())
    assert (full is None) == (want_full is None) == (shape[1] % 2 == 1)
    if full is not None:
        np.testing.assert_array_equal(full, want_full.numpy())


@pytest.mark.parametrize("shape", [(2, 2), (3, 5), (5, 3), (2, 301), (37, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_host_clahe_on_tiny_shapes(shape):
    """Tiles of one or two pixels a side, padded where the grid asks."""
    img = np.random.default_rng(shape[1]).integers(
        0, 65536, shape).astype(np.uint16)
    got, _ = host_clahe(img, 0.8, 2, 2, 65536)
    want = clahe.clahe_levels(torch.from_numpy(img), 0.8, 2, 2, 65536)
    np.testing.assert_array_equal(got, want.numpy())


WANTS = [(False, False), (True, True), (True, False), (False, True)]


@pytest.mark.parametrize("want", WANTS, ids=str)
@pytest.mark.parametrize("shape", [(600, 1024), (301, 257)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_host_chain_equals_the_twin(shape, want):
    """CLAHE, the percentiles, the CLAHE image's maximum and the three
    stretches, each asked for or not; an odd shape takes the disk's
    histogram from B5 rather than from the tiles."""
    img, _ = bench_product(2, *shape)
    got = host_chain(img, want=want)[1:]
    assert_same(got, products._products_body_plain(torch.from_numpy(img),
                                                   want))


@pytest.mark.parametrize("want", [(False, False), (True, True)], ids=str)
def test_host_gained_chain_on_the_bench_product(want):
    """The scan's whole chain at the bench product's 2048 x 2204: the row
    gain, then the products."""
    img, gain = bench_product(0)
    got = host_chain(img, gain, want)
    assert_same(got, products._products_core_gained(
        torch.from_numpy(img), torch.from_numpy(gain), want))


@pytest.mark.parametrize("value", [0, 1, 40000, 65535])
def test_host_chain_of_a_constant_image(value):
    """One value: the percentiles fall on it, the CLAHE image's maximum
    is its only level and the stretch's span is one."""
    img = np.full((64, 80), value, np.uint16)
    assert_same(host_chain(img, want=(True, True))[1:],
                products._products_body_plain(torch.from_numpy(img)))


def test_host_chain_of_a_two_level_image():
    """Half the pixels at 0 and half at 65535: the 10th percentile's
    order statistics straddle nothing, the 99.9999th's both fall on the
    top."""
    img = np.zeros((50, 64), np.uint16)
    img[:, 32:] = 65535
    assert_same(host_chain(img, want=(True, True))[1:],
                products._products_body_plain(torch.from_numpy(img)))


def test_cpu_path_is_the_twin_counted_plain():
    img, gain = bench_product(4, 120, 96)
    fj = torch.from_numpy(img)
    before = dict(products.PRODUCTS_LAUNCHES)
    got = products._products_core_gained(fj, torch.from_numpy(gain))
    assert products.PRODUCTS_LAUNCHES == {"kernel": before["kernel"],
                                          "plain": before["plain"] + 1}
    detrans = rowstats._apply_row_gain_plain(fj, torch.from_numpy(gain))
    assert torch.equal(got[0], detrans)
    assert_same(got[1:], products._products_body_plain(detrans))
    assert torch.equal(clahe.clahe(fj),
                       clahe._clahe(fj, 0.8, 2, 2, 65536).to(
                           torch.int32).to(torch.uint16))


def test_another_device_raises():
    img = torch.empty((64, 60), dtype=torch.uint16, device="meta")
    before = dict(products.PRODUCTS_LAUNCHES)
    with pytest.raises(ValueError, match="meta"):
        products._products_body(img)
    with pytest.raises(ValueError, match="meta"):
        rowstats.apply_row_gain(img, torch.ones(64, device="meta"))
    with pytest.raises(ValueError, match="meta"):
        clahe.clahe_levels(img, 0.8, 2, 2, 65536)
    assert products.PRODUCTS_LAUNCHES == before
