"""The host pipeline of the PyTorch port (the ``host`` feed's
post-processing) against the JAX package's host branches, and each native
entry point it calls against its numpy twin (CPU).

The host product core, the host warp, the host row statistics and the
host Canny are the JAX package's functions on the same C++ library, so
every comparison here is bit for bit.
"""

import importlib

import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.io import native as jax_native
from solex_ser_recon_en_tpu.ops import canny_host as jax_canny_host
from solex_ser_recon_en_tpu.ops.warp import warp_host_u16 as jax_warp_host
from solex_ser_recon_en_tpu.pipeline import products as jax_products
from solex_ser_recon_en_tpu.pipeline import transversalium as jax_trans
from solex_ser_recon_en_tpu.utils import placement as jax_placement
from solex_ser_recon_en_torch.geometry import correct, edges
from solex_ser_recon_en_torch.io import native
from solex_ser_recon_en_torch.ops import canny_host
from solex_ser_recon_en_torch.ops.warp import warp_host_u16, warp_host_u16_plain
from solex_ser_recon_en_torch.pipeline import products, transversalium
from solex_ser_recon_en_torch.pipeline.vignette import remove_vignette
from solex_ser_recon_en_torch.utils import placement

jax_correct = importlib.import_module("solex_ser_recon_en_tpu.geometry.correct")
CPU = torch.device("cpu")


def _disk_image(rng, h=300, w=340):
    """A bright disk with limb darkening, stripes and noise (uint16)."""
    yy, xx = np.mgrid[:h, :w]
    r = np.hypot(yy - h / 2, xx - w / 2)
    img = np.where(r < 0.4 * min(h, w), 30000 * (1 - 0.3 * (r / (0.4 * h)) ** 2),
                   900.0)
    img *= 1 + 0.02 * np.sin(yy / 3.0)
    img += rng.normal(0, 200, (h, w))
    return np.clip(img, 0, 65535).astype(np.uint16)


@pytest.fixture
def host_pipe():
    """The host pipeline on in both packages (this thread)."""
    placement.set_host_pipeline(True)
    jax_placement.set_host_pipeline(True)
    yield
    placement.set_host_pipeline(False)
    jax_placement.set_host_pipeline(False)


# ---- the product core -----------------------------------------------------


@pytest.mark.parametrize("want", [(True, True), (False, False),
                                  (True, False), (False, True)])
def test_products_body_host_equals_jax(want):
    rng = np.random.default_rng(9)
    f = _disk_image(rng)
    got = products._products_body_host(f, want)
    ref = jax_products._products_body_host(f, want)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (got[2] is None, got[3] is None) == (not want[0], not want[1])


@pytest.mark.parametrize("shape", [(300, 340), (257, 199)])
def test_products_core_gained_host_equals_jax(shape):
    rng = np.random.default_rng(4)
    f = _disk_image(rng, *shape)
    gain = 1 + 0.05 * rng.standard_normal(shape[0])
    got = products._products_core_gained_host(f, gain)
    ref = jax_products._products_core_gained_host(f, gain)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    # the fused multiply equals the numpy form
    want = np.clip(f.astype(np.float32) * gain.astype(np.float32)[:, None],
                   0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(got[0], want)


def test_histogram_percentile_twin_fuzz():
    """_np_percentile_from_counts == float(np.percentile) for u16 data, and
    the JAX package's twin."""
    rng = np.random.default_rng(3)
    for _ in range(60):
        n = int(rng.integers(3, 20000))
        img = rng.integers(0, 65536, size=n, dtype=np.uint16)
        counts = np.bincount(img, minlength=65536)
        for q in (99.9999, 10.0, 0.1, 50.0, float(rng.uniform(0, 100))):
            got = products._np_percentile_from_counts(counts, n, q)
            assert got == float(np.percentile(img, q))
            assert got == jax_products._np_percentile_from_counts(counts, n, q)


def test_image_process_takes_the_host_core_in_the_host_pipeline(host_pipe):
    rng = np.random.default_rng(2)
    f = torch.from_numpy(_disk_image(rng))
    calls = []
    real = products._products_body_host

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    from solex_ser_recon_en_torch.config import Options

    opts = Options(shift=[0], clahe_only=True)
    try:
        products._products_body_host = spy
        cc, protus = products.image_process(f, (170, 150, 110), opts,
                                            save=False)
    finally:
        products._products_body_host = real
    assert calls == [1] and cc.device.type == "cpu"
    assert cc.dtype == torch.uint16 and protus.dtype == torch.uint16
    want = jax_products._products_body_host(f.numpy(), (True, True))
    np.testing.assert_array_equal(cc.numpy(), want[1])


# ---- native entry points against their numpy twins ------------------------


def test_native_hist_lut_gain_against_numpy():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 65536, (123, 77), dtype=np.uint16)
    np.testing.assert_array_equal(native.hist_u16(img),
                                  np.bincount(img.ravel(), minlength=65536))
    lut = rng.integers(0, 65536, 65536, dtype=np.uint16)
    np.testing.assert_array_equal(native.lut_u16(img, lut), lut[img])
    gain = rng.uniform(0.5, 1.5, 123).astype(np.float32)
    out, hist = native.gain_hist_u16(img, gain)
    want = np.clip(img.astype(np.float32) * gain[:, None], 0,
                   65535).astype(np.uint16)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(hist, np.bincount(want.ravel(),
                                                    minlength=65536))
    assert native.gain_hist_u16(img, gain, want_hist=False)[1] is None
    with pytest.raises(TypeError):
        native.hist_u16(img.astype(np.int32))
    with pytest.raises(ValueError):
        native.gain_hist_u16(img, gain[:-1])


@pytest.mark.parametrize("shape,tiles", [((300, 340), (2, 2)),
                                         ((257, 199), (2, 2)),
                                         ((64, 96), (4, 3))])
def test_native_clahe_against_cv2_and_jax(shape, tiles):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(11)
    img = _disk_image(rng, *shape)
    out, hist = native.clahe_u16(img, 0.8, tiles, want_hist=True)
    ref = cv2.createCLAHE(clipLimit=0.8, tileGridSize=tiles).apply(img)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(hist, np.bincount(out.ravel(),
                                                    minlength=65536))
    np.testing.assert_array_equal(
        out, jax_native.native_clahe_u16(img, 0.8, tiles))
    with pytest.raises(ValueError):
        native.clahe_u16(img[:1], 0.8, tiles)


@pytest.mark.parametrize("sorted_rows", [True, False])
def test_row_stats_host_native_equals_numpy_and_jax(monkeypatch, sorted_rows):
    """The native masked medians (sorted hybrid and radix) = the numpy
    twin = the JAX package's, on the band rows and on full frames."""
    monkeypatch.setattr(native, "ROWSTATS_SORTED", sorted_rows)
    rng = np.random.default_rng(6)
    img = _disk_image(rng)
    img[100, 50:60] = 0                       # 0/0 log ratios
    h, w = img.shape
    circle, borders = (170.0, 150.0, 115.0), [40.0, 30.0, 300.0, 270.0]
    row_ok, lo, hi = transversalium._strip_bounds_host(h, w, circle, borders)
    valid = transversalium._strip_mask_host(h, w, circle, borders)
    fast = transversalium._row_stats_host_fast(img, row_ok, lo, hi)
    twin = transversalium._row_stats_host(img, valid)
    np.testing.assert_array_equal(fast, twin)
    np.testing.assert_array_equal(
        fast, jax_trans._row_stats_host_fast(img, row_ok, lo, hi))
    np.testing.assert_array_equal(
        valid, jax_trans._strip_mask_host(h, w, circle, borders))
    np.testing.assert_array_equal(
        transversalium._masked_row_median_host(img.astype(np.float32), valid),
        jax_trans._masked_row_median_host(img.astype(np.float32), valid))


def test_transversalium_gain_host_equals_jax_and_device(host_pipe,
                                                        monkeypatch):
    """transversalium_gain's host branch = the JAX host branch, and its
    gains = the port's device branch within float32 reduction order."""
    monkeypatch.setenv("SOLEX_HOST_PRODUCTS", "1")
    rng = np.random.default_rng(7)
    img = _disk_image(rng)
    circle, borders = (170.0, 150.0, 115.0), [40.0, 30.0, 300.0, 270.0]
    got = transversalium.transversalium_gain(torch.from_numpy(img), circle,
                                             borders, 301)
    ref = jax_trans.transversalium_gain(img, circle, borders, 301)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:3] == ref[1:3]
    out, c = transversalium.correct_transversalium(torch.from_numpy(img),
                                                   circle, borders)
    out_j, _ = jax_trans.correct_transversalium(img, circle, borders)
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_j))
    placement.set_host_pipeline(False)
    dev = transversalium.transversalium_gain(torch.from_numpy(img), circle,
                                             borders, 301)
    np.testing.assert_allclose(dev[0], got[0], rtol=1e-5)


# ---- the host warp --------------------------------------------------------


def test_warp_host_u16_native_equals_twin_and_jax():
    rng = np.random.default_rng(8)
    img = _disk_image(rng, 200, 160)
    _, _, mat3, _, _, out_h, out_w = correct._correction_mat3(img.shape, 0.3,
                                                              1.07)
    cval = float(img[0, 0]) / 65536.0
    got = warp_host_u16(img, mat3, out_h, out_w, cval)
    np.testing.assert_array_equal(
        got, warp_host_u16_plain(img, mat3, out_h, out_w, cval))
    np.testing.assert_array_equal(
        got, jax_warp_host(img, mat3, out_h, out_w, cval))
    f01 = img.astype(np.float32) / 65536.0
    np.testing.assert_array_equal(
        warp_host_u16(f01, mat3, out_h, out_w, cval),
        warp_host_u16_plain(f01, mat3, out_h, out_w, cval))
    stack = [img, img[::-1].copy(), (img // 2).astype(np.uint16)]
    cvals = [float(s[0, 0]) / 65536.0 for s in stack]
    batch = native.warp_u16_batch(stack, mat3, out_h, out_w, cvals, None)
    for k in range(3):
        np.testing.assert_array_equal(
            batch[k], warp_host_u16(stack[k], mat3, out_h, out_w, cvals[k]))


def test_correct_image_host_branch_equals_jax(host_pipe):
    """correct_image and correct_images_batched in the host pipeline: the
    native warp of CPU tensors, equal to the JAX host branches."""
    rng = np.random.default_rng(12)
    img = _disk_image(rng, 200, 160)
    calls = dict(native.CALLS)
    got, circle, mat3 = correct.correct_image(
        torch.from_numpy(img), 0.2, 1.05, np.array([80.0, 100.0]), 60.0)
    assert native.CALLS["warp_u16_u16"] == calls["warp_u16_u16"] + 1
    ref, circle_j, _ = jax_correct.correct_image(
        img, 0.2, 1.05, np.array([80.0, 100.0]), 60.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert circle == circle_j
    stack = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    warped, _, _ = correct.correct_images_batched(stack, 0.2, 1.05)
    assert native.CALLS["warp_u16_u16_batch"] == \
        calls["warp_u16_u16_batch"] + 1
    ref_b, _, _ = jax_correct.correct_images_batched(
        [img, img[::-1].copy()], 0.2, 1.05)
    np.testing.assert_array_equal(warped.numpy(), np.asarray(ref_b))


# ---- Canny's size dispatch, de-vignette -----------------------------------


def test_canny_host_copy_equals_jax():
    rng = np.random.default_rng(1)
    img = np.where(_disk_image(rng, 120, 90) > 10000, 65000.0, 0.0)
    for sigma in (2.0, 1.5):
        np.testing.assert_array_equal(
            canny_host.canny(img, sigma, 100.0, 150.0),
            jax_canny_host.canny(img, sigma, 100.0, 150.0))


@pytest.mark.parametrize("shape,host", [((120, 100), True),
                                        ((256, 256), True),
                                        ((257, 256), False)])
def test_edges_size_dispatch(monkeypatch, shape, host):
    """Blobs of 65536 px or fewer take the host Canny on every feed; larger
    ones the torch Canny on the small ops' device."""
    rng = np.random.default_rng(3)
    img = _disk_image(rng, *shape).astype(np.float64) / 65536
    used = []
    real_host, real_dev = edges.canny_host, edges.canny

    monkeypatch.setattr(edges, "canny_host",
                        lambda *a, **k: used.append("host") or
                        real_host(*a, **k))
    monkeypatch.setattr(edges, "canny",
                        lambda *a, **k: used.append("torch") or
                        real_dev(*a, **k))
    X, raw = edges.get_edge_list(img, CPU)
    assert used[0] == ("host" if host else "torch") and len(X) > 6


def test_vignette_in_the_host_pipeline_equals_device_branch(host_pipe):
    rng = np.random.default_rng(13)
    img = torch.from_numpy(_disk_image(rng))
    a = remove_vignette(img, (170.0, 150.0, 115.0))
    placement.set_host_pipeline(False)
    b = remove_vignette(img, (170.0, 150.0, 115.0))
    assert a.dtype == torch.float64 and torch.equal(a, b)
