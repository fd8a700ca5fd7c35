"""Every product mode of one scan in the PyTorch port against the JAX
package (CPU): the protus raster, the crops, the product gates, the
product core, and the whole file set of each mode on the basic synthetic
scan (names equal, FITS headers equal, images within stated bounds).

The JAX side runs its device feed with the separable warp switched on (its
TPU gate), as in test_torch_pipeline.py, whose module text explains the
whole-slice bounds: the two recons differ by 1 LSB on ~0.01% of disk pixels
(XLA:CPU contracts the lerp into an FMA); CLAHE turns one count into up to
65535/tile_area levels and each stretch multiplies by its slope.

The transversalium gain is not continuous in its input: its MAD outlier
rejection keeps or drops whole pixels, so 6 disk pixels that differ by
1 LSB moved the gains of the sweep's shift -3 by 3e-5 (measured on this
scan; on identical inputs the packages' gains agree to 5e-7), which is
1 LSB on 6.7% of the corrected pixels and, after CLAHE, up to 12.4 LUT
steps (63 levels, mean 3.6).  Shift 0 and shift 3 stay inside the bounds
of test_torch_pipeline.py (3 LUT steps, mean 2).  ``_bounds`` states both.
"""

import importlib
import itertools
import math
import os
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.config import Options as JaxOptions
from solex_ser_recon_en_tpu.io import writers as jax_writers
from solex_ser_recon_en_tpu.io.fits import read_fits as jax_read_fits
from solex_ser_recon_en_tpu.io.png import read_image
from solex_ser_recon_en_tpu.ops.warp_fast import unit_y_row, window_for
from solex_ser_recon_en_tpu.pipeline import products as jax_products
from solex_ser_recon_en_tpu.pipeline import run as jax_run
from solex_ser_recon_en_torch.cli.main import main as cli_main
from solex_ser_recon_en_torch.config import Options
from solex_ser_recon_en_torch.io import writers
from solex_ser_recon_en_torch.io.fits import read_fits
from solex_ser_recon_en_torch.io.png import read_png
from solex_ser_recon_en_torch.pipeline import products
from solex_ser_recon_en_torch.pipeline import run as port_run

from test_photometric import _striped_disk
from torch_parity import lsb_diff, t

jax_correct = importlib.import_module("solex_ser_recon_en_tpu.geometry.correct")
CPU = torch.device("cpu")
FIGURES = ("_spectral_line_data.png", "_ellipse_fit.png",
           "_transversalium_correction.png")


# ---- the protus disc ---------------------------------------------------------


def _centres(h, w, r):
    return [(w // 2, h // 2), (0, 0), (w - 1, h - 1), (3, h - 2),
            (-5, h // 3), (w + 3, -2), (w // 3, h + r - 1), (-r, h // 2),
            (-r - 1, 5), (w + r, h // 2), (w // 2, -r), (w // 2, h + r + 1)]


@pytest.mark.parametrize("radii", [range(1, 17), range(17, 40), (63, 64, 65),
                                   (97, 128, 255), (256, 511), (777, 1000),
                                   (1200,)])
def test_protus_raster_equals_cv2_circle(radii):
    """``cv2.circle(img, (x0, y0), r, 80, -1)`` pixel for pixel: centres
    inside the image, on its edge and outside it (clipped, tangent and
    wholly outside circles)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for r in radii:
        h, w = (60, 90) if r < 100 else (700, 900)
        img = rng.integers(100, 60000, (h, w)).astype(np.uint16)
        for x0, y0 in _centres(h, w, r):
            want = cv2.circle(img.copy(), (x0, y0), r, 80, -1)
            got = products.protus_disc(t(img), x0, y0, r)
            assert got.dtype == torch.uint16
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"r={r} c=({x0},{y0})")


def test_protus_raster_equals_jax_protus_disc():
    """The JAX package's ``_protus_disc``, on its cv2 branch and on its
    cv2-less ``dx*dx + dy*dy <= r*r`` branch: the same pixels, and the
    input is left untouched."""
    img, circle, _ = _striped_disk()
    x0, y0, r = int(circle[0]), int(circle[1]), int(circle[2]) - 3
    src = t(img)
    got = products.protus_disc(src, x0, y0, r).numpy()
    np.testing.assert_array_equal(src.numpy(), img)
    assert (got == 80).sum() > 3 * r * r
    for have_cv2 in (jax_products._HAVE_CV2, False):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_products, "_HAVE_CV2", have_cv2)
            np.testing.assert_array_equal(
                got, jax_products._protus_disc(img, x0, y0, r))


def _opencv_fill_half_widths(r: int) -> np.ndarray:
    """Half-width of every row of OpenCV's filled circle: its midpoint walk
    (drawing.cpp, ``Circle``) draws, at each step (dx, dy), the spans
    [x0 - dx, x0 + dx] on the rows y0 +- dy and [x0 - dy, x0 + dy] on the
    rows y0 +- dx; a row's pixels are the widest span it was given."""
    half = np.full(r + 1, -1, dtype=np.int64)
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        half[dy] = max(half[dy], dx)
        half[dx] = max(half[dx], dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return half


@pytest.mark.parametrize("radii", [range(1, 400), range(400, 4000, 37)])
def test_opencv_midpoint_fill_is_the_squared_distance_disc(radii):
    """Why the port's mask needs no walk: for every radius the union of
    OpenCV's spans is floor(sqrt(r*r - d*d)) wide on the rows d from the
    centre, i.e. the set dx*dx + dy*dy <= r*r."""
    for r in radii:
        d = np.arange(r + 1)
        want = np.floor(np.sqrt(r * r - d * d)).astype(np.int64)
        want -= (want * want + d * d > r * r)          # exact in integers
        want += ((want + 1) ** 2 + d * d <= r * r)
        np.testing.assert_array_equal(_opencv_fill_half_widths(r), want)


# ---- crop_width ---------------------------------------------------------------


@pytest.mark.parametrize("circle", [(22.0, 15.0, 10.0), (-1, -1, -1),
                                    (3.5, 15.0, 10.0), (38.2, 15.0, 10.0)])
@pytest.mark.parametrize("fixed,square", [(20, False), (None, True),
                                          (41, False), (100, False),
                                          (7, False), (None, False)])
def test_crop_width_matches_jax(fixed, square, circle):
    """``-s`` and ``-r N`` narrower and wider than the image, with and
    without a circle, the disk near either edge: identical pixels and
    circle, on uint16 and on float frames."""
    img = np.random.default_rng(2).integers(0, 65536, (30, 40)).astype(
        np.uint16)
    for frame in (img, img.astype(np.float64) * 1.5):
        out, c = products.crop_width(
            t(frame), circle, Options(fixed_width=fixed,
                                      crop_width_square=square))
        ref, c_ref = jax_products.crop_width(
            frame, circle, JaxOptions(fixed_width=fixed,
                                      crop_width_square=square))
        np.testing.assert_array_equal(out.numpy(), ref)
        assert out.numpy().dtype == ref.dtype and c == c_ref


# ---- needed_products -------------------------------------------------------------


@pytest.mark.parametrize("clahe_only,protus_only,nolog,display,save",
                         list(itertools.product([False, True], repeat=5)))
def test_needed_products_gates(clahe_only, protus_only, nolog, display, save):
    kw = dict(clahe_only=clahe_only, protus_only=protus_only, _nolog=nolog,
              flag_display=display)
    assert products.needed_products(Options(**kw), save) == \
        jax_products.needed_products(JaxOptions(**kw), save)


# ---- the product core -------------------------------------------------------------


def _stack(odd=False):
    imgs = [_striped_disk(seed=s, stripe_amp=a)[0]
            for s, a in ((0, 0.12), (1, 0.05), (2, 0.2))]
    if odd:
        imgs = [im[:-1, :-3] for im in imgs]
    return np.stack(imgs)


@pytest.mark.parametrize("with_gains", [False, True])
@pytest.mark.parametrize("want", [(True, True), (False, False), (False, True)])
@pytest.mark.parametrize("odd", [False, True])
def test_products_core_want_gates_skip_without_changing(with_gains, want, odd):
    """A stretch ``want`` does not ask for comes back as None, and what is
    computed equals the full core's bit for bit, on even and odd images."""
    img = _stack(odd)[0]
    if with_gains:
        gain = torch.tensor(
            np.random.default_rng(7).uniform(0.9, 1.1, img.shape[0]),
            dtype=torch.float32)
        full = products._products_core_gained(t(img), gain)
        gated = products._products_core_gained(t(img), gain, want)
    else:
        full = products._products_body(t(img))
        gated = products._products_body(t(img), want)
    assert len(gated) == len(full) == (5 if with_gains else 4)
    wanted = (True,) * (len(full) - 2) + tuple(want)
    for got, ref, asked in zip(gated, full, wanted):
        if asked:
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
        else:
            assert got is None


@pytest.mark.parametrize("with_gains", [False, True])
def test_products_core_matches_jax_batched_program(with_gains, monkeypatch):
    """The per-image core, image by image, against the JAX package's
    vmapped program on the same stack: the row multiply identical, CLAHE
    within 1 LSB on < 1% of pixels, each stretch within its slope + 1 LSB."""
    slopes = []
    orig = products._stretch

    def spy(img, lo, hi):
        slopes.append(65535.0 / float(hi - lo))
        return orig(img, lo, hi)

    monkeypatch.setattr(products, "_stretch", spy)
    stack = _stack()
    gains = (np.random.default_rng(7).uniform(0.9, 1.1, stack.shape[:2])
             if with_gains else None)
    ref = jax_products.products_core_batched(jnp.asarray(stack), gains)
    for k in range(stack.shape[0]):
        if with_gains:
            ours = products._products_core_gained(
                t(stack[k]), torch.tensor(gains[k], dtype=torch.float32))
            np.testing.assert_array_equal(ours[0].numpy(),
                                          np.asarray(ref[0][k]))
            ours, ref_k = ours[1:], [c[k] for c in ref[1:]]
        else:
            ours, ref_k = products._products_body(t(stack[k])), \
                [c[k] for c in ref]
        cl1, cc, hc, protus = (c.numpy() for c in ours)
        r_cl1, r_cc, r_hc, r_protus = (np.asarray(c) for c in ref_k)
        mx, frac = lsb_diff(cl1, r_cl1)
        assert mx <= 1 and frac < 0.01
        for (a, b), slope in zip(((cc, r_cc), (hc, r_hc), (protus, r_protus)),
                                 slopes[3 * k: 3 * k + 3]):
            mx, frac = lsb_diff(a, b)
            assert mx <= math.ceil(slope) + 1 and frac < 0.01


# ---- image_process ------------------------------------------------------------------


def test_image_process_float_frame_is_clipped_then_cast():
    """A float frame (after de-vignetting) saturates at 0 and 65535 before
    the cast, in float64 here and in float32 in the JAX package: equal
    except where a value lies within a float32 ulp of an integer (none
    here), so the products agree as for a uint16 frame."""
    img, circle, _ = _striped_disk()
    frame = img.astype(np.float64) * 1.6 - 900.25        # below 0, above 65535
    opts = dict(transversalium=False, _nolog=True)
    cc, protus = products.image_process(t(frame), circle, Options(**opts),
                                        save=False)
    cc_j, protus_j = jax_products.image_process(frame, circle,
                                                JaxOptions(**opts), save=False)
    assert cc.dtype == protus.dtype == torch.uint16
    mx, frac = lsb_diff(cc.numpy(), np.asarray(cc_j))
    assert mx <= 3 and frac < 0.01
    mx, frac = lsb_diff(protus.numpy(), np.asarray(protus_j))
    assert mx <= 9 and frac < 0.01
    want = np.clip(frame, 0, 65535).astype(np.uint16)
    assert want.min() == 0 and want.max() == 65535
    core = products._products_body(t(want), (False, True))
    x0, y0, r = int(circle[0]), int(circle[1]), int(circle[2])
    np.testing.assert_array_equal(
        protus.numpy(), products.protus_disc(core[3], x0, y0, r).numpy())


@pytest.mark.parametrize("rotate", [0, 90, 180, 270])
def test_image_process_rotates_every_product(tmp_path, rotate):
    """All four PNGs and neither FITS rotate, as in the JAX package; the
    disc is painted before the rotation."""
    img, circle, _ = _striped_disk(h=120, w=150)
    circle = (75.0, 60.0, 40.0)
    base = str(tmp_path / "p_shift=0")
    hdr = {"NAXIS1": 150}
    products.image_process(t(img), circle, Options(
        img_rotate=rotate, save_fit=True, delta_radius=-2), hdr, base)
    writers.barrier()
    flat = {}
    products.image_process(t(img), circle, Options(
        save_fit=True, delta_radius=-2), hdr, str(tmp_path / "q_shift=0"))
    writers.barrier()
    for suffix in ("_clahe.png", "_protus.png", "_uncontrasted.png",
                   "_high_contrast.png"):
        got = read_png(base + suffix)
        flat[suffix] = read_png(str(tmp_path / "q_shift=0") + suffix)
        np.testing.assert_array_equal(got, np.rot90(flat[suffix],
                                                    rotate // 90))
    np.testing.assert_array_equal(flat["_uncontrasted.png"], img)
    assert flat["_protus.png"][60, 75] == 80
    assert flat["_protus.png"][60, 75 + 38] == 80
    assert flat["_protus.png"][60, 75 + 39] != 80        # r = 40 - 2
    cl1, h = read_fits(base + "_clahe.fits")
    assert cl1.shape == img.shape and h["NAXIS1"] == 150


@pytest.mark.parametrize("kw,suffixes", [
    (dict(), ["_clahe.png", "_high_contrast.png", "_protus.png",
              "_uncontrasted.png"]),
    (dict(clahe_only=True), ["_clahe.png"]),
    (dict(protus_only=True), ["_protus.png"]),
    (dict(clahe_only=True, protus_only=True), ["_clahe.png", "_protus.png"]),
    (dict(save_fit=True, clahe_only=True), ["_clahe.fits", "_clahe.png"]),
    (dict(_nolog=True, save_fit=True), ["_clahe.fits"]),
    (dict(_nolog=True), []),
])
def test_image_process_file_gates(tmp_path, kw, suffixes):
    """The save gates of solex_util.py:556-587: the same files as the JAX
    package for the same options; a product nobody consumes is None."""
    img, circle, _ = _striped_disk(h=100, w=90)
    circle = (45.0, 50.0, 30.0)
    for sub, fn, opts, frame, join in (
        ("port", products.image_process, Options(**kw), t(img),
         writers.barrier),
        ("jax", jax_products.image_process, JaxOptions(**kw), img,
         jax_writers.barrier),
    ):
        (tmp_path / sub).mkdir()
        out = fn(frame, circle, opts, {"NAXIS1": 90},
                 str(tmp_path / sub / "g_shift=0"))
        join()
        if sub == "port":
            assert (out[1] is None) == (not products.needed_products(opts)[1])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == ["g_shift=0" + s for s in suffixes]


# ---- whole modes on the basic scan -----------------------------------------------------


def _tpu_warp_gate(mat3):
    return bool(unit_y_row(mat3) and window_for(mat3) > 0)


def _run_both(path, root, kw):
    """One scan through both packages with the same options -> (port dir,
    jax dir, stretch slopes of the port's run, in call order)."""
    out_j, out_t = str(root / "jax"), str(root / "port")
    os.makedirs(out_j)
    os.makedirs(out_t)
    slopes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_correct, "_use_fast_warp", _tpu_warp_gate)
        jax_run.process_file(path, JaxOptions(
            feed_mode="device", output_dir=out_j, **kw))
        jax_writers.figure_barrier()
        orig = products._stretch

        def spy(img, lo, hi):
            slopes.append(65535.0 / float(hi - lo))
            return orig(img, lo, hi)

        mp.setattr(products, "_stretch", spy)
        res = port_run.process_file(path, Options(output_dir=out_t, **kw), CPU)
        writers.figure_barrier()
    return out_t, out_j, slopes, res


MODES = {
    "default": dict(shift=[0]),
    "protus_only": dict(shift=[0], protus_only=True),
    "fits": dict(shift=[0], save_fit=True),
    "square": dict(shift=[0], crop_width_square=True),
    "fixed_odd": dict(shift=[0], fixed_width=301, clahe_only=True,
                      save_fit=True),
    "sweep_fits": dict(shift=[-3, 0, 3], clahe_only=True, save_fit=True),
    "no_trans_mirror_rot": dict(shift=[0], transversalium=False, flip_x=True,
                                img_rotate=90, save_fit=True,
                                disk_display=False),
}


@pytest.fixture(scope="module")
def mode_runs(basic_scan, tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run_both(basic_scan["path"],
                                    tmp_path_factory.mktemp(name),
                                    MODES[name])
        return cache[name]

    return get


def _bounds(name):
    """(LUT steps, mean LSB, share of corrected pixels that may differ) for
    one product file: the whole-slice bounds of test_torch_pipeline.py at
    shift 0, the measured sensitivity of the gains elsewhere (module
    text)."""
    shift = int(name.split("shift=")[1].split("_")[0])
    return (3, 2.0, 1e-2) if shift == 0 else (13, 4.0, 0.1)


def _png_size(path):
    with open(path, "rb") as f:
        data = f.read(24)
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    return struct.unpack(">II", data[16:24])


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_writes_the_jax_packages_files(mode_runs, mode):
    """Exactly the files the JAX package writes for the same options."""
    out_t, out_j, _, res = mode_runs(mode)
    names = sorted(os.listdir(out_t))
    assert names == sorted(os.listdir(out_j))
    kw = MODES[mode]
    n_shifts = len(kw["shift"])
    assert [s for s, _ in res][0] == 0 and len(res) == n_shifts
    figures = not kw.get("clahe_only") and not kw.get("protus_only")
    for fig in FIGURES:
        assert any(n.endswith(fig) for n in names) == (
            figures and (kw.get("transversalium", True)
                         or "transversalium" not in fig))
    assert "basic_log.txt" in names


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_fits_headers_and_data(mode_runs, mode):
    """FITS headers equal card for card; ``_mean`` identical, ``_raw`` and
    ``_circular`` within 1 LSB on < 0.1% of pixels (the FMA in XLA's
    lerp), ``_detransversaliumed`` within 2 LSB on < 1% (< 10% off shift
    0), ``_clahe`` within 3 LUT steps + 1 (13 off shift 0): ``_bounds``."""
    out_t, out_j, _, _ = mode_runs(mode)
    seen = 0
    for name in sorted(os.listdir(out_t)):
        if not name.endswith(".fits"):
            continue
        seen += 1
        a, ha = read_fits(os.path.join(out_t, name))
        b, hb = jax_read_fits(os.path.join(out_j, name))
        assert ha == hb, name
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint16
        mx, frac = lsb_diff(a, b)
        h, w = a.shape
        lut_step = 65535 / (((h + h % 2) // 2) * ((w + w % 2) // 2))
        if name.endswith("_mean.fits"):
            assert mx == 0
        elif name.endswith(("_raw.fits", "_circular.fits")):
            assert mx <= 1 and frac < 1e-3, name
        elif name.endswith("_detransversaliumed.fits"):
            assert mx <= 2 and frac < _bounds(name)[2], name
        else:
            assert name.endswith("_clahe.fits")
            assert mx <= math.ceil(_bounds(name)[0] * lut_step) + 1, name
    assert (seen > 0) == bool(MODES[mode].get("save_fit"))


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_png_products(mode_runs, mode):
    """Product PNGs: same shape; ``_uncontrasted`` within 2 LSB on < 1%,
    the two plain stretches within 2 slopes + 1, ``_clahe`` within 3 LUT
    steps x its slope + 1 with a mean of at most 2 LSB (the bounds of
    test_torch_pipeline.py's whole-slice test; 13 steps and 4 LSB off shift
    0, see ``_bounds``).  The protus disc lies on
    the same pixels."""
    out_t, out_j, slopes, _ = mode_runs(mode)
    kw = MODES[mode]
    per_image = 1 if kw.get("clahe_only") else (
        2 if kw.get("protus_only") else 3)
    seen = 0
    for name in sorted(os.listdir(out_t)):
        if not name.endswith(".png") or name.endswith(FIGURES):
            continue
        a = read_png(os.path.join(out_t, name))
        b = read_image(os.path.join(out_j, name))
        assert a.shape == b.shape and a.dtype == np.uint16, name
        shift = int(name.split("shift=")[1].split("_")[0])
        k = [0] + [s for s in kw["shift"] if s != 0]
        sl = slopes[per_image * k.index(shift): per_image * (k.index(shift) + 1)]
        mx, frac = lsb_diff(a, b)
        h, w = a.shape
        lut_step = 65535 / (((h + h % 2) // 2) * ((w + w % 2) // 2))
        if name.endswith("_clahe.png"):
            steps, mean, _ = _bounds(name)
            assert mx <= math.ceil(steps * lut_step * sl[0]) + 1, name
            assert np.abs(a.astype(np.int64)
                          - b.astype(np.int64)).mean() <= mean
        elif name.endswith("_uncontrasted.png"):
            assert mx <= 2 and frac < 1e-2, name
        elif name.endswith("_high_contrast.png"):
            assert mx <= 2 * math.ceil(sl[1]) + 1 and frac < 1e-2, name
        else:
            assert name.endswith("_protus.png")
            assert mx <= 2 * math.ceil(sl[-1]) + 1 and frac < 1e-2, name
            if kw.get("disk_display", True):
                np.testing.assert_array_equal(a == 80, b == 80)
                assert (a == 80).sum() > 1000
        seen += 1
    assert seen == len(kw["shift"]) * (
        1 if kw.get("clahe_only") or kw.get("protus_only") else 4)


def test_mode_shapes_of_the_crops(mode_runs):
    """``-s`` gives a square image, ``-r 301`` an odd width (CLAHE pads by
    reflection there), rotation by 90 degrees swaps the axes."""
    assert read_png(os.path.join(mode_runs("square")[0],
                                 "basic_shift=0_clahe.png")).shape == (256, 256)
    out = mode_runs("fixed_odd")[0]
    assert read_png(os.path.join(out, "basic_shift=0_clahe.png")).shape == \
        (256, 301)
    data, hdr = read_fits(os.path.join(out, "basic_shift=0_clahe.fits"))
    assert data.shape == (256, 301) and hdr["NAXIS1"] == 301
    _, hdr = read_fits(os.path.join(out, "basic_shift=0_raw.fits"))
    assert hdr["NAXIS1"] == 200                      # the recon's width
    out = mode_runs("no_trans_mirror_rot")[0]
    assert read_png(os.path.join(out, "basic_shift=0_clahe.png")).shape == \
        (202, 256)


def test_default_mode_figures_are_valid_pngs(mode_runs):
    """The three figures exist, are PNGs of the JAX figures' size, and the
    deferred lane rendered them at ``figure_barrier``."""
    out_t, out_j, _, _ = mode_runs("default")
    for name in ("basic_spectral_line_data.png", "basic_shift=10_ellipse_fit.png",
                 "basic_shift=0_transversalium_correction.png"):
        assert _png_size(os.path.join(out_t, name)) == \
            _png_size(os.path.join(out_j, name))
        assert os.path.getsize(os.path.join(out_t, name)) > 5000


def test_default_mode_chain_on_jax_disks(basic_scan, tmp_path):
    """The port's ``process_scan`` on the JAX ``read_scan`` result (through
    ``interop.scan_result``, header included), default mode with ``-f``:
    fed identical disks the stages agree within 1-2 LSB, so every product
    lies within one stretch slope + 1 LSB of the JAX package's on >= 99.9%
    identical pixels, and the FITS headers are equal."""
    from solex_ser_recon_en_torch import interop

    out_j, out_t = tmp_path / "jax", tmp_path / "port"
    out_j.mkdir()
    out_t.mkdir()
    kw = dict(shift=[0], save_fit=True)
    slopes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_correct, "_use_fast_warp", _tpu_warp_gate)
        oj = JaxOptions(feed_mode="device", output_dir=str(out_j), **kw)
        scan_j = jax_run.read_scan(basic_scan["path"], oj)
        jax_run.process_scan(scan_j, oj)
        jax_writers.figure_barrier()
        orig = products._stretch

        def spy(img, lo, hi):
            slopes.append(65535.0 / float(hi - lo))
            return orig(img, lo, hi)

        mp.setattr(products, "_stretch", spy)
        scan = interop.scan_result(scan_j, CPU)
        assert scan.header == scan_j.header and scan.header["NAXIS1"] == 200
        opts = Options(output_dir=str(out_t), **kw)
        opts.basefich0 = scan.basefich0
        port_run.process_scan(scan, opts)
        writers.figure_barrier()
    made = sorted(os.listdir(out_t))
    assert made == sorted(n for n in os.listdir(out_j)
                          if not n.endswith(("_mean.fits", "_raw.fits",
                                             "_spectral_line_data.png")))
    bound = {"_clahe.png": slopes[0], "_high_contrast.png": slopes[1],
             "_protus.png": slopes[2], "_uncontrasted.png": 1.0,
             "_circular.fits": 0.0, "_detransversaliumed.fits": 1.0,
             "_clahe.fits": 1.0}
    for name in made:
        if name.endswith(FIGURES + ("_log.txt",)):
            continue
        suffix = name[len("basic_shift=0"):]
        if name.endswith(".fits"):
            a, ha = read_fits(str(out_t / name))
            b, hb = jax_read_fits(str(out_j / name))
            assert ha == hb
        else:
            a, b = read_png(str(out_t / name)), read_image(str(out_j / name))
        mx, frac = lsb_diff(a, b)
        assert mx <= math.ceil(bound[suffix]) + 1 and frac <= 1e-3, name


# ---- a Doppler sweep against its shifts run one at a time ---------------------------------


def _sweep(path, root, name, shifts, **kw):
    out = root / name
    out.mkdir()
    opts = Options(shift=list(shifts), output_dir=str(out), **kw)
    res = port_run.process_file(path, opts, CPU)
    writers.figure_barrier()
    return res, out


@pytest.mark.parametrize("kw", [
    dict(save_fit=True),
    dict(clahe_only=True),
    dict(transversalium=False, save_fit=True, protus_only=True),
    dict(img_rotate=180, clahe_only=True, save_fit=True),
], ids=["default_fits", "clahe_only", "no_trans_protus_fits", "rot_fits"])
def test_sweep_equals_single_shift_runs(basic_scan, tmp_path, kw):
    """A sweep (one batched warp for its shifts) writes byte for byte the
    data files of its shifts run one at a time, returns the same images in
    the order of the augmented shift list, and the same figures."""
    res, out = _sweep(basic_scan["path"], tmp_path, "sweep", [-4, 0, 4], **kw)
    assert [s for s, _ in res] == [0, -4, 4]
    n_data = 0
    for s, imgs in res:
        (_, imgs_1), = _sweep(basic_scan["path"], tmp_path, f"one{s}", [s],
                              **kw)[0]
        for img, img_1 in zip(imgs, imgs_1):
            assert (img is None) == (img_1 is None)
            if img is not None:
                np.testing.assert_array_equal(img.numpy(), img_1.numpy())
        one = tmp_path / f"one{s}"
        for f in sorted(os.listdir(one)):
            if f.endswith(FIGURES):
                assert _png_size(out / f) == _png_size(one / f)
            elif f.endswith((".fits", ".png")):
                assert (out / f).read_bytes() == (one / f).read_bytes(), f
                n_data += 1
    assert n_data >= 3
    assert sum(f.endswith("_clahe.png") or f.endswith("_protus.png")
               for f in os.listdir(out)) >= 3


@pytest.mark.parametrize("kw", [dict(crop_width_square=True),
                                dict(fixed_width=150),
                                dict(stubborn_transversalium=True),
                                dict(de_vignette=True)],
                         ids=["square", "fixed", "stubborn", "devignette"])
def test_sweep_with_per_shift_steps_yields_every_product(basic_scan, tmp_path,
                                                         kw):
    """Crop, stubborn and de-vignette sit between the batched warp and the
    products of each shift: the sweep still yields every product."""
    res, out = _sweep(basic_scan["path"], tmp_path, "seq", [-4, 0, 4],
                      clahe_only=True, **kw)
    assert [s for s, _ in res] == [0, -4, 4]
    width = 256 if kw.get("crop_width_square") else kw.get("fixed_width", 202)
    for s in (-4, 0, 4):
        assert read_png(str(out / f"basic_shift={s}_clahe.png")).shape == \
            (256, width)


# ---- stubborn and de-vignette through process_file -----------------------------------------


@pytest.mark.parametrize("kw", [dict(stubborn_transversalium=True),
                                dict(de_vignette=True),
                                dict(de_vignette=True, transversalium=False)],
                         ids=["stubborn", "devignette", "devignette_no_trans"])
def test_library_modes_match_jax(basic_scan, tmp_path, kw):
    """``Options(stubborn_transversalium=True)`` and ``(de_vignette=True)``
    through ``process_file``: the same files and header cards.
    ``_clahe.fits`` within 3 LUT steps + 1 of the JAX package's, mean at
    most 2 LSB (measured with de-vignette: 16 levels, mean 1.2); with the
    stubborn filter, whose JAX form alone moves 7.5% of pixels by 1 LSB
    (float32 cumulative sums, test_torch_photometric.py), 10 LUT steps
    and a mean of 4 LSB (measured: 40 levels = 7.9 steps, mean 3.0).

    One card differs by design: after de-vignetting the frame is float64
    here, as in the reference, and float32 in the JAX package (a device
    array times a float64 vector gives float32 there), so ``_circular.fits``
    has BITPIX -64 here and -32 there; the values agree to one float32
    ulp."""
    out_t, out_j, _, _ = _run_both(
        basic_scan["path"], tmp_path,
        dict(shift=[0], clahe_only=True, save_fit=True, **kw))
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    a, ha = read_fits(os.path.join(out_t, "basic_shift=0_clahe.fits"))
    b, hb = jax_read_fits(os.path.join(out_j, "basic_shift=0_clahe.fits"))
    assert ha == hb and a.shape == b.shape
    steps, mean = (10, 4.0) if "stubborn_transversalium" in kw else (3, 2.0)
    assert lsb_diff(a, b)[0] <= math.ceil(steps * 65535 / (128 * 101)) + 1
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).mean() <= mean
    c, hc = read_fits(os.path.join(out_t, "basic_shift=0_circular.fits"))
    cj, hcj = jax_read_fits(os.path.join(out_j, "basic_shift=0_circular.fits"))
    if kw.get("de_vignette"):
        assert (hc.pop("BITPIX"), hcj.pop("BITPIX")) == (-64, -32)
        assert c.dtype == np.float64 and cj.dtype == np.float32
        # 1 LSB of the warped uint16 frame times the correction, plus one
        # float32 ulp
        np.testing.assert_allclose(c, cj, atol=1.5, rtol=1e-6)
        assert (np.abs(c - cj) > 0.01).mean() < 1e-3
    else:
        assert lsb_diff(c, cj)[0] <= 1
    assert hc == hcj
    if kw.get("transversalium", True):
        d, _ = read_fits(os.path.join(
            out_t, "basic_shift=0_detransversaliumed.fits"))
        dj, _ = jax_read_fits(os.path.join(
            out_j, "basic_shift=0_detransversaliumed.fits"))
        assert d.dtype == dj.dtype == np.uint16
        assert lsb_diff(d, dj)[0] <= 2
        assert lsb_diff(d, np.clip(c, 0, 65535).astype(np.uint16))[1] > 0.1


# ---- figures without matplotlib -----------------------------------------------------------


def _no_matplotlib(monkeypatch):
    import solex_ser_recon_en_torch.pipeline as pkg

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "solex_ser_recon_en_torch.pipeline.plots",
                        raising=False)
    monkeypatch.delattr(pkg, "plots", raising=False)


@pytest.mark.parametrize("flags", ["-w0", "-fw0", "-sw0", "-r300"])
def test_cli_without_matplotlib_refuses_figure_modes(basic_scan, tmp_path,
                                                     monkeypatch, capsys,
                                                     flags):
    """Where matplotlib cannot be imported a mode that writes figures exits
    2 with an error naming matplotlib and the two sets that need none;
    nothing is written, not even the log."""
    _no_matplotlib(monkeypatch)
    rc = cli_main([flags, basic_scan["path"], "--device", "cpu",
                   "--output-dir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert rc == 2
    assert "matplotlib" in out and "-c" in out and "protus_only" in out
    assert os.listdir(tmp_path / "out") == []


def test_library_without_matplotlib(basic_scan, tmp_path, monkeypatch):
    """``read_scan`` and ``process_scan`` raise the same error; ``-c``,
    ``protus_only`` and ``_nolog`` runs need no matplotlib."""
    _no_matplotlib(monkeypatch)
    with pytest.raises(port_run.FiguresNeedMatplotlib, match="matplotlib"):
        port_run.read_scan(basic_scan["path"],
                           Options(output_dir=str(tmp_path)), CPU)
    assert os.listdir(tmp_path) == []
    for kw in (dict(clahe_only=True), dict(protus_only=True),
               dict(_nolog=True)):
        port_run.check_supported(Options(**kw))
    res = port_run.process_file(basic_scan["path"], Options(
        shift=[0], protus_only=True, save_fit=True,
        output_dir=str(tmp_path)), CPU)
    assert len(res) == 1
    assert "basic_shift=0_protus.png" in os.listdir(tmp_path)
    assert "matplotlib" not in [m for m, v in sys.modules.items()
                                if v is not None and m == "matplotlib"]
