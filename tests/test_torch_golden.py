"""Golden parity of the PyTorch port: its pipeline against the port's own
reference replica (solex_ser_recon_en_torch/utils/cpu_reference.py), and
that replica against OpenCV and against the JAX package's replica (CPU).

The port's replica runs without cv2 (the card's machine has none): its
numpy stand-ins for the reference's OpenCV calls are held to cv2 here,
where cv2 exists.  Bounds:
- ``_clahe_u16``, ``_blur_u16`` and ``_fill_circle`` equal cv2's CLAHE,
  ``cv2.blur`` and ``cv2.circle(..., -1)`` bit for bit (bound 0), odd
  sides included; ``_write_png_u16`` reads back through
  ``cv2.imread(IMREAD_UNCHANGED)`` as its input.
- Every public function of the port's replica equals the JAX replica's
  on the same input (bound 0): the stand-ins are exact and the rest is
  the same arithmetic.
- The port's pipeline (RawScanProcessor, fit_spectral_line, pass B and the
  product core, on the CPU) against the port's replica, as
  tests/test_golden.py holds the JAX pipeline to its replica: mean and
  max bit for bit, disks within 1 LSB on < 2% of pixels, the CLAHE and
  high-contrast stretches within 4 LSB; the line fit within 1 px on the
  rows it is fitted on.  On an image of the bench scan's 4.1 M pixels the
  high-contrast stretch differs more (7 LSB on the card, chip_smoke.py
  phase 14) through the 99.9999th percentile's float32 index (ROADMAP
  C19): at the port's percentile the replica's stretch is within 1 LSB.
- On an image with one odd side, the replica's CLAHE (cv2's) differs from
  the port's by more than 10 LSB, and the port's CLAHE of cv2's own
  extension of the image, cut back, agrees with the replica within 1 LSB
  on < 2% of pixels: cv2's padding is the difference (ROADMAP C13).
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.utils import cpu_reference as jref
from solex_ser_recon_en_torch.geometry.edges import downscale_local_mean
from solex_ser_recon_en_torch.geometry.linefit import fit_spectral_line
from solex_ser_recon_en_torch.io.feeder import raw_device_chunks
from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
from solex_ser_recon_en_torch.io.video import open_video
from solex_ser_recon_en_torch.ops.clahe import clahe
from solex_ser_recon_en_torch.ops.fused import RawScanProcessor
from solex_ser_recon_en_torch.pipeline.products import _products_body
from solex_ser_recon_en_torch.utils import cpu_reference as ref

from torch_parity import lsb_diff, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden_scan(tmp_path_factory):
    """The scan of tests/test_golden.py, from the port's generator."""
    path = str(tmp_path_factory.mktemp("golden") / "g.ser")
    scan = SyntheticScan(
        ih=256, iw=96, frames=180, depth=16,
        line_poly=(48.0, 0.01, -5e-5, 0.0),
        trans_stripes=0.08, noise=0.002, seed=17,
    )
    scan.write(path, transpose_to_wide=True)
    return path


@pytest.fixture(scope="module")
def golden(golden_scan):
    """The port's replica's mean, max, line fit and hidden [10, 0] disks."""
    mean_img, max_img = ref.cpu_mean_max(golden_scan)
    fit = ref.cpu_line_fit(mean_img, max_img)
    return dict(mean=mean_img, max=max_img, fit=fit,
                disks=ref.cpu_recon(golden_scan, fit, [10, 0]))


def _run_port(path, shifts):
    """The port's main path on the CPU: the feed, pass A, the line fit and
    pass B (tests/test_golden.py:_run_device's counterpart)."""
    vid = open_video(path)
    it, rotate, upscale = raw_device_chunks(vid, 64, CPU)
    proc = RawScanProcessor(vid.Height, vid.Width, rotate, upscale, CPU)
    for s, c, _ in it:
        proc.accumulate(s, c)
    mean_img, max_img = proc.mean_max()
    lf = fit_spectral_line(mean_img, max_img)
    disks = proc.reconstruct(lf.floor, lf.frac, shifts).numpy()
    return mean_img, max_img, lf, disks


def _image(rng, shape):
    """A bright disk on a ramp with noise: CLAHE's tiles all populated."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    disk = np.hypot(yy - h / 2, xx - w / 2) < 0.4 * min(h, w)
    return (rng.random(shape) * 3000 + np.linspace(0, 30000, w)[None, :]
            + 20000 * disk).astype(np.uint16)


# -- the stand-ins against cv2 ----------------------------------------------

CLAHE_SHAPES = [(256, 180), (255, 181), (256, 181), (2048, 1001),
                (2048, 2204), (97, 64), (7, 9)]


@pytest.mark.parametrize("content", ["disk", "uniform"])
@pytest.mark.parametrize("shape", CLAHE_SHAPES)
def test_clahe_u16_equals_cv2(shape, content):
    rng = np.random.default_rng(sum(shape))
    img = (_image(rng, shape) if content == "disk"
           else rng.integers(0, 65536, shape, dtype=np.uint16))
    want = cv2.createCLAHE(clipLimit=0.8, tileGridSize=(2, 2)).apply(img)
    np.testing.assert_array_equal(ref._clahe_u16(img, 0.8, (2, 2)), want)


@pytest.mark.parametrize("clip,tiles", [(2.0, (3, 4)), (40.0, (1, 1)),
                                        (0.0, (2, 3))])
def test_clahe_u16_other_limits_and_grids_equal_cv2(clip, tiles):
    img = _image(np.random.default_rng(4), (255, 181))
    want = cv2.createCLAHE(clipLimit=clip, tileGridSize=tiles).apply(img)
    np.testing.assert_array_equal(ref._clahe_u16(img, clip, tiles), want)


def _line_fit_windows(max_img, mean_img):
    """The (kx, ky) windows cpu_line_fit gives its two blurs."""
    blur = ref._blur_u16(max_img, 5, 5)
    ymean = np.mean(blur, axis=1)
    where = ymean > np.median(ymean) / 5
    y1 = int(np.argmax(where))
    y2 = int(mean_img.shape[0] - 1 - np.argmax(where[::-1]))
    clip = int((y2 - y1) * 0.05)
    y1, y2 = min(mean_img.shape[0] - 1, y1 + clip), max(0, y2 - clip)
    return (5, 5), (25, max(1, int((y2 - y1) * 0.01)))


def test_blur_u16_equals_cv2_on_the_golden_scan(golden):
    """Both of cpu_line_fit's blurs on the golden scan's own images."""
    w5, w25 = _line_fit_windows(golden["max"], golden["mean"])
    for img, (kx, ky) in ((golden["max"], w5), (golden["mean"], w25)):
        np.testing.assert_array_equal(ref._blur_u16(img, kx, ky),
                                      cv2.blur(img, (kx, ky)))


@pytest.mark.parametrize("width", [300, 96, 13, 301])
@pytest.mark.parametrize("window", [(5, 5), (25, 16), (25, 20), (25, 1),
                                    (3, 7)])
def test_blur_u16_equals_cv2(window, width):
    """The bench scan's windows (25 x 16 and 25 x 20 are where a float64
    scaling misses cv2's rounding) on full-range noise; widths that leave
    0, 5 and 4 columns to cv2's scalar tail, and a 25-wide window over 13
    columns (reflected more than once)."""
    rng = np.random.default_rng(width)
    img = rng.integers(0, 65536, (2048, width), dtype=np.uint16)
    img[:64] = 65535
    np.testing.assert_array_equal(ref._blur_u16(img, *window),
                                  cv2.blur(img, window))


def test_the_packages_blur_rounds_unlike_cv2():
    """ROADMAP C18: both packages' u16 box blur scales its exact window
    sums in float64 throughout, cv2 in float32 outside its scalar tail; on
    full-range noise the two differ by 1 LSB on 402 pixels at 25 x 16 and
    788 at 25 x 20 (none at 5 x 5), the replica on none."""
    from solex_ser_recon_en_tpu.ops.blur import box_blur_u16_host as jax_blur
    from solex_ser_recon_en_torch.ops.blur import box_blur_u16_host

    img = np.random.default_rng(0).integers(0, 65536, (2048, 300),
                                            dtype=np.uint16)
    for window, misses in (((5, 5), 0), ((25, 16), 402), ((25, 20), 788)):
        want = cv2.blur(img, window).astype(np.int64)
        port = box_blur_u16_host(img, *window).astype(np.int64)
        np.testing.assert_array_equal(
            port, np.asarray(jax_blur(img, *window)).astype(np.int64))
        assert int((port != want).sum()) == misses
        assert np.abs(port - want).max() <= 1
        np.testing.assert_array_equal(ref._blur_u16(img, *window), want)


@pytest.mark.parametrize("shape,center,r", [
    ((2048, 2204), (1102, 1024), 819),      # the bench product's disc
    ((256, 183), (91, 128), 73),            # cpu_products' on the golden disk
    ((50, 60), (3, 40), 20), ((50, 60), (-5, 25), 30),
    ((50, 60), (70, 25), 15), ((50, 60), (30, -10), 12),
    ((50, 60), (30, 25), 0), ((50, 60), (30, 25), 200)])
def test_fill_circle_equals_cv2(shape, center, r):
    got = np.full(shape, 7, np.uint16)
    want = got.copy()
    ref._fill_circle(got, center, r, 80)
    cv2.circle(want, center, r, 80, -1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(256, 183), (1, 1), (37, 2204)])
def test_write_png_u16_reads_back_through_cv2(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 65536, shape, dtype=np.uint16)
    path = str(tmp_path / "x.png")
    ref._write_png_u16(path, np.rot90(np.rot90(img)))
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, np.rot90(np.rot90(img)))


# -- the port's replica against the JAX replica -------------------------------

def test_downscale_local_mean_equals_jax():
    from solex_ser_recon_en_tpu.geometry.edges import (
        downscale_local_mean as jax_downscale)

    img = np.random.default_rng(2).random((257, 183))
    for f in (1, 4):
        np.testing.assert_array_equal(downscale_local_mean(img, f),
                                      jax_downscale(img, f))


def test_mean_max_line_fit_recon_equal_jax(golden_scan, golden):
    mean_j, max_j = jref.cpu_mean_max(golden_scan)
    np.testing.assert_array_equal(golden["mean"], mean_j)
    np.testing.assert_array_equal(golden["max"], max_j)
    np.testing.assert_array_equal(golden["fit"],
                                  jref.cpu_line_fit(mean_j, max_j))
    for a, b in zip(golden["disks"],
                    jref.cpu_recon(golden_scan, golden["fit"], [10, 0])):
        np.testing.assert_array_equal(a, b)
    assert ref.cpu_detect_bounds(golden["max"]) == \
        jref.cpu_detect_bounds(max_j)


def _cv2_y800(path, frames):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"Y800"), 30,
                         (frames.shape[2], frames.shape[1]), isColor=False)
    assert vw.isOpened(), "this cv2 writes no Y800 AVI"
    for f in frames:
        vw.write(f)
    vw.release()


@pytest.mark.parametrize("wide", [False, True])
def test_cpu_mean_max_of_a_y800_avi_equals_jax(tmp_path, wide):
    """The JAX replica decodes with cv2.VideoCapture, the port's reads the
    planes; a wide AVI is turned upright by both."""
    base = SyntheticScan(ih=96, iw=48, frames=40, depth=16,
                         line_poly=(22.0, 0.01, 0.0, 0.0), seed=3).generate()
    frames8 = (base >> 8).astype(np.uint8)
    if wide:
        frames8 = np.ascontiguousarray(np.rot90(frames8, -1, axes=(1, 2)))
    path = str(tmp_path / "a.avi")
    _cv2_y800(path, frames8)
    got, want = ref.cpu_mean_max(path), jref.cpu_mean_max(path)
    assert got[0].shape == (96, 48)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    fit = ref.cpu_line_fit(*got)
    np.testing.assert_array_equal(ref.cpu_recon(path, fit, [0])[0],
                                  jref.cpu_recon(path, fit, [0])[0])


def test_a_compressed_avi_is_refused_naming_cv2(tmp_path):
    path = str(tmp_path / "m.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (48, 96), isColor=False)
    assert vw.isOpened()
    for _ in range(3):
        vw.write(np.zeros((96, 48), np.uint8))
    vw.release()
    with pytest.raises(RuntimeError, match="cv2"):
        ref.cpu_mean_max(path)


@pytest.mark.parametrize("protus", [False, True])
@pytest.mark.parametrize("cols", [180, 179])
def test_cpu_products_equal_jax(golden, protus, cols):
    disk = np.ascontiguousarray(golden["disks"][1][:, :cols])
    got = ref.cpu_products(disk, protus=protus)
    want = jref.cpu_products(disk, protus=protus)
    assert len(got) == len(want) == (3 if protus else 2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint16
        np.testing.assert_array_equal(a, b)


def test_cpu_transversalium_and_crop_equal_jax(golden):
    disk = golden["disks"][1]
    y1, y2 = ref.cpu_detect_bounds(golden["max"])
    cp, cj = [], []
    np.testing.assert_array_equal(
        ref.cpu_transversalium(disk, y1, y2, correction_out=cp),
        jref.cpu_transversalium(disk, y1, y2, correction_out=cj))
    np.testing.assert_array_equal(cp[0], cj[0])
    for width in (120, 300):
        np.testing.assert_array_equal(ref.cpu_crop_width(disk, width),
                                      jref.cpu_crop_width(disk, width))


def _tilted_disk():
    yy, xx = np.mgrid[0:240, 0:260].astype(np.float64)
    e = (((xx - 130) + 0.15 * (yy - 120)) / 80) ** 2 + ((yy - 120) / 95) ** 2
    return np.where(e < 1.0, 42000, 900).astype(np.uint16)


@pytest.mark.parametrize("which", ["tilted", "golden", "flat"])
def test_cpu_ellipse_warp_equals_jax(golden, which):
    """The port's host edge/ellipse chain and numpy warp give the JAX
    replica's circle and warped disk (bound 0); a featureless disk takes
    the fallback in both."""
    disks = {"tilted": [_tilted_disk()] * 2, "golden": golden["disks"],
             "flat": [np.zeros((64, 64), np.uint16)] * 2}[which]
    (got,), circle = ref.cpu_ellipse_warp(disks, [1])
    (want,), circle_j = jref.cpu_ellipse_warp(disks, [1])
    assert (circle is None) == (circle_j is None) == (which == "flat")
    if circle is not None:
        np.testing.assert_array_equal(np.asarray(circle),
                                      np.asarray(circle_j))
    np.testing.assert_array_equal(got, want)


def test_clahe_only_pipeline_writes_the_jax_replicas_png(golden_scan,
                                                         tmp_path):
    """The -c leg end to end: the same _clahe.png pixels as the JAX
    replica's (written there by cv2.imwrite, here by _write_png_u16)."""
    out = {}
    for name, mod in (("port", ref), ("jax", jref)):
        d = tmp_path / name
        d.mkdir()
        assert mod.cpu_pipeline(golden_scan, [-1, 0], clahe_only=True,
                                transversalium=True, save_dir=str(d)) > 0
        out[name] = d
    for shift in (-1, 0):
        name = f"g_shift={shift}_clahe.png"
        np.testing.assert_array_equal(
            cv2.imread(str(out["port"] / name), cv2.IMREAD_UNCHANGED),
            cv2.imread(str(out["jax"] / name), cv2.IMREAD_UNCHANGED))


# -- the port's pipeline against its replica (tests/test_golden.py) ----------

def test_mean_max_bit_exact(golden_scan, golden):
    mean_d, max_d = _run_port(golden_scan, [0])[:2]
    np.testing.assert_array_equal(mean_d, golden["mean"])
    np.testing.assert_array_equal(max_d, golden["max"])


def test_disks_match_reference_loop(golden_scan):
    shifts = [10, 0, -4]
    _, _, lf, disks_d = _run_port(golden_scan, shifts)
    fit = np.stack([lf.floor.astype(np.float64), lf.frac], axis=1)
    disks_c = ref.cpu_recon(golden_scan, fit, shifts)
    for i in range(len(shifts)):
        mx, frac = lsb_diff(disks_d[i], disks_c[i])
        assert mx <= 1, f"shift {shifts[i]}: max {mx}"
        assert frac < 0.02


def test_line_fit_within_a_pixel_of_the_replica_on_the_fitted_rows(
        golden_scan, golden):
    """On the rows both fits are made on; beyond them each cubic is
    extrapolated (4.3 px apart at the last row of this scan): the replica
    fits its blurred argmin once, the port refits on the sharp argmin
    after two rejection rounds."""
    lf = _run_port(golden_scan, [0])[2]
    port = lf.floor.astype(np.float64) + lf.frac
    d = np.abs(port - golden["fit"].sum(axis=1))[lf.y1:lf.y2]
    assert d.max() <= 1.0


def test_line_fit_on_a_quarter_of_the_bench_scan(tmp_path):
    """ROADMAP C20 at 1/4 of the bench scan's rows and frames (its widths
    and proportions kept): the replica's single fit of its blurred argmin
    is over 1 px off the true line where the port's is within 0.1 px, so
    the two are 1-2 px apart (chip_smoke.py phase 14 gates 2 px on the
    bench scan itself)."""
    f = 4
    scan = SyntheticScan(ih=2048 // f, iw=300, frames=2000 // f, depth=16,
                         line_poly=(150.0, 0.005 * f, -2e-6 * f ** 2,
                                    1e-9 * f ** 3),
                         squash_y=1.08, shear=0.02, disk_radius=int(
                             0.42 * 2000 / f), trans_stripes=0.08,
                         noise=0.002, seed=5)
    path = str(tmp_path / "quarter.ser")
    scan.write(path, transpose_to_wide=True)
    mean_img, max_img = ref.cpu_mean_max(path)
    replica = ref.cpu_line_fit(mean_img, max_img).sum(axis=1)
    lf = fit_spectral_line(mean_img, max_img)
    ys = np.arange(lf.y1, lf.y2)
    truth = scan.line_center(ys)
    assert np.abs(lf.curve[ys] - truth).max() < 0.1
    assert np.abs(replica[ys] - truth).max() > 1.0
    assert 1.0 < np.abs(lf.curve - replica).max() <= 2.0


def test_products_match_reference(golden_scan):
    disk = _run_port(golden_scan, [0])[3][0]
    _, cc, hc, _ = (a.numpy() for a in _products_body(t(disk)))
    cc_ref, hc_ref = ref.cpu_products(disk)
    assert lsb_diff(cc, cc_ref)[0] <= 4
    assert lsb_diff(hc, hc_ref)[0] <= 4


def test_high_contrast_differs_by_the_float32_percentile_index():
    """On the bench image's 4.1 M pixels the packages' 99.9999th percentile
    (jnp.percentile's float32 index, ops/clahe.py:percentile_taps) lerps
    the two top order statistics at 0.75 where numpy's float64 index lerps
    at 0.904 (ROADMAP C19); at the port's percentile the replica's stretch
    is the port's within 1 LSB."""
    from solex_ser_recon_en_torch.ops.clahe import (
        percentile_from_hist, percentile_taps, value_histogram)

    rng = np.random.default_rng(5)
    disk = _image(rng, (2048, 2000))
    disk[rng.integers(0, 2048, 8), rng.integers(0, 2000, 8)] = \
        rng.integers(54000, 65000, 8)
    _, _, hc, _ = (a.numpy() for a in _products_body(t(disk)))
    low, high, low_w, high_w = percentile_taps(99.9999, disk.size)
    assert (low, float(high_w)) == (4095994, 0.75)
    stats = np.partition(disk.ravel(), [low, high])[[low, high]]
    bright = float(percentile_from_hist(value_histogram(t(disk), 65536),
                                        disk.size, 99.9999))
    assert bright == float(np.float32(stats[0]) * low_w
                           + np.float32(stats[1]) * high_w)
    assert abs(bright - np.percentile(disk, 99.9999)) > 1
    at_port = (65535.0 * (disk - bright * 0.25) / max(bright * 0.75, 1)
               ).clip(0, 65535).astype(np.uint16)
    assert lsb_diff(hc, at_port)[0] <= 1


def test_cpu_replica_config_extensions(golden_scan, tmp_path):
    out = tmp_path / "rep"
    out.mkdir()
    dt = ref.cpu_pipeline(
        golden_scan, [0], transversalium=True, save_dir=str(out),
        save_fits=True, protus=True, img_rotate=90, fixed_width=200,
    )
    assert dt > 0
    names = {p.name for p in out.iterdir()}
    assert {"g_mean.fits", "g_shift=0_raw.fits", "g_shift=0_circular.fits",
            "g_shift=0_detransversaliumed.fits", "g_shift=0_clahe.fits",
            "g_shift=0_clahe.png", "g_shift=0_protus.png",
            "g_shift=0_uncontrasted.png",
            "g_shift=0_high_contrast.png"} <= names
    assert cv2.imread(str(out / "g_shift=0_protus.png"),
                      cv2.IMREAD_UNCHANGED).shape == (200, 256)
    assert ref.cpu_pipeline(golden_scan, [-2, 0, 2]) > 0


def test_cpu_replica_hidden_shifts_and_figures(golden_scan, tmp_path):
    out = tmp_path / "fig"
    out.mkdir()
    assert ref.cpu_pipeline(golden_scan, [0], save_dir=str(out),
                            figures=True) > 0
    names = {p.name for p in out.iterdir()}
    assert {"g_shift=0_clahe.png", "g_spectral_line_data.png",
            "g_ellipse_fit.png"} <= names


def test_cpu_replica_clahe_only_reference_save_set(golden_scan, tmp_path):
    out = tmp_path / "conly"
    out.mkdir()
    assert ref.cpu_pipeline(golden_scan, [-1, 0], clahe_only=True,
                            transversalium=True, save_dir=str(out)) > 0
    names = sorted(p.name for p in out.iterdir())
    assert names == ["g_shift=-1_clahe.png", "g_shift=0_clahe.png"], names


def test_one_odd_side_is_cv2s_padding():
    """ROADMAP C13 on the replica: the port's CLAHE of an image with one
    odd side is far from cv2's (the replica's); of cv2's extension of it,
    cut back, within the packages' CLAHE bound of cv2."""
    img = _image(np.random.default_rng(9), (2048, 1001))
    h, w = img.shape
    want = ref._clahe_u16(img, 0.8, (2, 2))
    assert lsb_diff(clahe(t(img), 0.8, (2, 2)).numpy(), want)[0] > 10
    ext = img[np.r_[0:h, h - 2:h - 4:-1]][:, np.r_[0:w, w - 2]]
    assert ext.shape == (h + 2, w + 1)
    mx, frac = lsb_diff(clahe(t(ext), 0.8, (2, 2)).numpy()[:h, :w], want)
    assert mx <= 1 and frac < 0.02


BLOCKED = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "matplotlib", "jax",
                                  "solex_ser_recon_en_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import os
from solex_ser_recon_en_torch.utils import cpu_reference as ref
os.makedirs("out")
assert ref.cpu_pipeline(sys.argv[1], [0], clahe_only=True,
                        transversalium=True, save_dir="out") > 0
assert sorted(os.listdir("out")) == ["g_shift=0_clahe.png"]
try:
    ref.cpu_pipeline(sys.argv[1], [0], save_dir="out", figures=True)
except ImportError as e:
    assert "matplotlib" in str(e), e
else:
    raise AssertionError("figures without matplotlib did not raise")
print("BLOCKED_OK")
"""


def test_clahe_only_leg_runs_without_cv2_and_matplotlib(golden_scan,
                                                        tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", BLOCKED, golden_scan],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "BLOCKED_OK" in res.stdout, \
        res.stdout + res.stderr
    png = cv2.imread(str(tmp_path / "out" / "g_shift=0_clahe.png"),
                     cv2.IMREAD_UNCHANGED)
    assert png.dtype == np.uint16 and png.max() > 0
