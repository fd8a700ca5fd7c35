"""The photometric modules of the PyTorch port against the JAX package on
the same numpy inputs (CPU): the stubborn filter's mean filters
(ops/filters.py), ``fix_edge_effect``, ``stubborn_filter``,
``correct_transversalium``, ``transversalium_gain`` and
``remove_vignette``, uint16 and float frames.  Each test states its bound.

Where the two packages may differ.  A device array's ``.astype(float64)``
yields float32 in JAX, and ``jnp.asarray`` of a float64 numpy frame rounds
it to float32; the port rounds at the same places (``ops/dtypes.as_f32``),
so the row statistics and the row multiply see the same float32 values.
``image_process`` clips and truncates a float frame in float64 in the port
and in float32 in the JAX package: 1 LSB where a value lies within a
float32 ulp below an integer.  XLA:CPU contracts the percentile's lerp into
an FMA (1 float32 ulp of the profile).  The JAX mean filters take their
window sums from float32 cumulative sums, which lose 1e-4 of a window mean
on long rows; the port's sum in float64 (ops/filters.py says why), so the
difference between the two is the JAX filters' own rounding.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from solex_ser_recon_en_tpu.ops import filters as jax_filters
from solex_ser_recon_en_tpu.pipeline import transversalium as jax_tr
from solex_ser_recon_en_tpu.pipeline import vignette as jax_vig
from solex_ser_recon_en_torch.ops import filters
from solex_ser_recon_en_torch.pipeline import transversalium as tr
from solex_ser_recon_en_torch.pipeline import vignette as vig

from test_photometric import _striped_disk
from torch_parity import lsb_diff, t


def _borders(img, circle):
    return [0, circle[1] - circle[2] + 10, img.shape[1] - 1,
            circle[1] + circle[2] - 10]


# ---- ops/filters.py --------------------------------------------------------


@pytest.mark.parametrize("shape,linlen,hw", [((120, 160), 41, 3),
                                             ((300, 280), 101, 5),
                                             ((64, 64), 1, 1)])
def test_mean_filters_match_jax(shape, linlen, hw):
    """The JAX filters difference float32 cumulative sums: their error is
    2e-5 relative to the largest cumulative sum (|x| * the padded width),
    measured 6e-5 absolute on log images of width 400; the port's float64
    sums carry none of it, so that is the bound between the two."""
    rng = np.random.default_rng(4)
    x = np.log(rng.uniform(50, 60000, shape))
    scale = np.abs(x).max() * (shape[1] + linlen) * (2 * hw + 1)
    for ours, ref in (
        (filters.mean_filter_hole(t(x), linlen, hw),
         jax_filters.mean_filter_hole(jnp.asarray(x), linlen, hw)),
        (filters.mean_filter_line(t(x), linlen),
         jax_filters.mean_filter_line(jnp.asarray(x), linlen)),
    ):
        assert ours.dtype == torch.float32 and ours.shape == shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=2e-5 * scale / linlen, rtol=0)


def test_mean_filters_against_float64_correlation():
    """The two kernels of solex_util.py:293-323 written out in float64 with
    BORDER_REFLECT_101: the port's filters agree to float32 rounding of the
    result (2e-6 on log values up to 11)."""
    rng = np.random.default_rng(5)
    x = np.log(rng.uniform(50, 60000, (40, 90)))
    linlen, hw = 21, 2
    xp = np.pad(x, ((hw, hw), (linlen // 2, linlen // 2)), mode="reflect")
    line = np.zeros_like(x)
    hole = np.zeros_like(x)
    for i in range(x.shape[0]):
        for j in range(x.shape[1]):
            win = xp[i:i + 2 * hw + 1, j:j + linlen]
            line[i, j] = win[hw].mean()
            hole[i, j] = (win.sum() - win[hw].sum()) / (2 * hw * linlen)
    x = x.astype(np.float32).astype(np.float64)     # the filters' input
    np.testing.assert_allclose(filters.mean_filter_line(t(x), linlen).numpy(),
                               line, atol=2e-6)
    np.testing.assert_allclose(
        filters.mean_filter_hole(t(x), linlen, hw).numpy(), hole, atol=2e-6)


# ---- fix_edge_effect, stubborn_filter ---------------------------------------


@pytest.mark.parametrize("circle,linlen", [((70.0, 60.0, 60.0), 41),
                                           ((80.0, 50.0, 30.0), 21),
                                           ((10.0, 110.0, 45.0), 31),
                                           ((70.0, 60.0, 300.0), 121)])
def test_fix_edge_effect_is_the_jax_function(circle, linlen):
    """A numpy copy: identical output (clipped circles, narrow rows, a
    circle larger than the image)."""
    mult = np.random.default_rng(1).normal(size=(120, 140))
    np.testing.assert_array_equal(tr.fix_edge_effect(mult, circle, linlen),
                                  jax_tr.fix_edge_effect(mult, circle, linlen))


@pytest.mark.parametrize("as_float", [False, True])
def test_stubborn_filter_matches_jax(as_float):
    """Host float64 math around the two mean filters.  The JAX filters'
    float32 cumulative sums lose about 1e-5 in log space, which the
    truncating cast turns into a changed pixel often (1e-5 * 45000 = 0.5);
    the port's float64 sums lose nothing.  Measured: 1 LSB at most, on
    7.50% of pixels (uint16 input) and 7.50% (float input).  Bound, with
    room: 2 LSB on fewer than 12% of pixels."""
    img, circle, _ = _striped_disk()
    if as_float:
        img = img.astype(np.float64) * 1.0003
    spurious = np.zeros(img.shape[0], bool)
    spurious[[0, 100, 101, 102, 180, 299]] = True
    y1, y2 = 45, 255
    ours = tr.stubborn_filter(t(img), spurious, y1, y2, circle)
    ref = jax_tr.stubborn_filter(img, spurious, y1, y2, circle)
    assert ours.dtype == ref.dtype == np.uint16
    mx, frac = lsb_diff(ours, ref)
    assert mx <= 2 and frac < 0.12
    assert lsb_diff(ours, img.astype(np.uint16))[1] > 0.1   # it does filter


# ---- correct_transversalium --------------------------------------------------


@pytest.mark.parametrize("as_float", [False, True])
def test_correct_transversalium_matches_jax(as_float):
    """Gains to 1e-6 relative (float32 row sums in another order); the
    corrected image within 1 LSB on < 0.1% of pixels; a float frame is
    taken as float32 in both packages."""
    img, circle, _ = _striped_disk()
    frame = img.astype(np.float64) * 1.01 if as_float else img
    borders = _borders(img, circle)
    out, c = tr.correct_transversalium(t(frame), circle, borders, 151)
    out_j, c_j = jax_tr.correct_transversalium(frame, circle, borders, 151)
    assert out.dtype == torch.uint16
    np.testing.assert_allclose(c, np.asarray(c_j), rtol=1e-6)
    mx, frac = lsb_diff(out.numpy(), out_j)
    assert mx <= 1 and frac < 1e-3
    assert not np.allclose(c, 1.0)


def test_correct_transversalium_stubborn_matches_jax():
    """The stubborn branch end to end: the same rows flagged (the gains
    agree to 1e-6), the image within the stubborn filter's bound (2 LSB on
    fewer than 12% of pixels; measured 1 LSB on 7.71%)."""
    img, circle, _ = _striped_disk(stripe_amp=0.2)
    img = img.copy()
    img[150] = (img[150] * 0.5).astype(np.uint16)      # one stubborn row
    borders = _borders(img, circle)
    out, c = tr.correct_transversalium(t(img), circle, borders, 151,
                                       stubborn=True)
    out_j, c_j = jax_tr.correct_transversalium(img, circle, borders, 151,
                                               stubborn=True)
    assert out.dtype == torch.uint16 and out.shape == img.shape
    np.testing.assert_allclose(c, np.asarray(c_j), rtol=1e-6)
    mx, frac = lsb_diff(out.numpy(), np.asarray(out_j))
    assert mx <= 2 and frac < 0.12
    # the dimmed row is repaired: closer to its neighbours than before
    cols = slice(100, 180)
    before = abs(float(img[150, cols].mean()) - float(img[149, cols].mean()))
    after = abs(float(out.numpy()[150, cols].astype(np.int64).mean())
                - float(out.numpy()[149, cols].astype(np.int64).mean()))
    assert after < 0.2 * before


@pytest.mark.parametrize("k", [0, 1, 2])
def test_transversalium_gain_matches_jax_batched_program(k):
    """The per-image gain against the JAX package's vmapped program on a
    stack of three disks, image by image: 1e-6 relative."""
    imgs = [_striped_disk(seed=s, stripe_amp=a)[0]
            for s, a in ((0, 0.12), (1, 0.05), (2, 0.2))]
    _, circle, _ = _striped_disk()
    borders = _borders(imgs[0], circle)
    ref = jax_tr.transversalium_gains_batched(jnp.asarray(np.stack(imgs)),
                                              circle, borders, 151)
    c = tr.transversalium_gain(t(imgs[k]), circle, borders, 151)[0]
    assert c.shape == (imgs[k].shape[0],) and c.dtype == np.float64
    np.testing.assert_allclose(c, ref[k], rtol=1e-6)
    assert not np.allclose(c, 1.0)


def test_transversalium_gain_short_band_is_identity():
    """Fewer than 7 rows in the band: the gain is all ones in both."""
    img, _, _ = _striped_disk()
    circle, borders = (140.0, 150.0, 110.0), [0, 148, 279, 153]
    c = tr.transversalium_gain(t(img), circle, borders, 151)[0]
    np.testing.assert_array_equal(c, np.ones(img.shape[0]))
    np.testing.assert_array_equal(
        c, jax_tr.transversalium_gain(img, circle, borders, 151)[0])


# ---- remove_vignette -------------------------------------------------------


def _drooping_disk():
    img, circle, _ = _striped_disk(stripe_amp=0.0, h=400, w=380)
    droop = 1 - 0.3 * ((np.arange(400) - 200) / 200) ** 2
    return np.clip(img.astype(float) * droop[:, None], 1, 65535), circle


def test_axis_percentiles_match_jax():
    """The sort-and-lerp written out against jnp.percentile under jit: one
    float32 ulp of the value (the FMA contraction of XLA:CPU)."""
    vigd, _ = _drooping_disk()
    for frame in (vigd, vigd.astype(np.uint16)):
        ours = vig._axis_percentiles(t(frame))
        ref = jax_vig._axis_percentiles(jnp.asarray(frame))
        for a, b in zip(ours, ref):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1.2e-7)


@pytest.mark.parametrize("as_u16", [False, True])
def test_remove_vignette_flattens_droop_and_matches_jax(as_u16):
    """The JAX test's drooping disk: float64 out, flatter rows, and within
    3e-7 relative of the JAX result (1 ulp of a float32 profile value
    through the savgol trends)."""
    vigd, circle = _drooping_disk()
    frame = vigd.astype(np.uint16) if as_u16 else vigd
    out = vig.remove_vignette(t(frame), circle)
    ref = jax_vig.remove_vignette(frame, circle)
    assert out.dtype == torch.float64 and ref.dtype == np.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=3e-7)
    rows_in = vigd[140:260, 150:230].mean(axis=1)
    rows_out = out.numpy()[140:260, 150:230].mean(axis=1)
    assert np.std(rows_out) < np.std(rows_in)


def test_remove_vignette_is_float64_where_jax_gives_float32():
    """On a device array the JAX function multiplies a uint16 jax array by
    the float64 correction and gets float32 (no 64-bit types on the
    device); the port keeps the reference's float64.  The two agree to one
    float32 ulp."""
    vigd, circle = _drooping_disk()
    frame = vigd.astype(np.uint16)
    out = vig.remove_vignette(t(frame), circle)
    ref = jax_vig.remove_vignette(jnp.asarray(frame), circle)
    assert out.dtype == torch.float64 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-7)


@pytest.mark.parametrize("circle", [(190.0, 200.0, 70.0),     # short profiles
                                    (190.0, -400.0, 110.0)])  # off the frame
def test_remove_vignette_early_returns(circle):
    """Too little data: the frame comes back as it went in, in both."""
    vigd, _ = _drooping_disk()
    frame = t(vigd)
    assert vig.remove_vignette(frame, circle) is frame
    assert jax_vig.remove_vignette(vigd, circle) is vigd
