"""The port's spectral analyser (analyser/, cli/analyse.py) with
ops/fused_cuda.py:mean_max, ops/recon.py:reconstruct and ops/resize.py,
against the JAX package and OpenCV (CPU).

The scan is the size of the JAX package's analyser tests (ih 360, iw 300,
220 frames).  Bounds:
- line tables, the atlas and its npz round trip, ``goto_shift``, the
  anchor position, the fitted circle and borders, the host recon: equal;
- ``auto_dispersion``: the same scale-grid index or the next one, the
  correlation within 1e-5 (float32 sums in another order; XLA:CPU fuses
  ``anchor + dx * scale``, ROADMAP C2);
- Y/X ratio and tilt: within 1e-9 relative (the same edge points, float64
  fits);
- disks: within 1 LSB (C2); ``mean_max``, spilling or not: equal to JAX
  ops/reduce.py;
- ``save(0)``: the corrected disk's 1-LSB differences (C2) move the CLAHE
  LUT of this 360 x 240 image by up to 15 levels (C4): _clahe within 15
  LSB with a mean under 2 LSB, _protus within 8 LSB on < 0.5% of pixels;
  ``preview(0)`` (the disk upscaled to 1000 rows, whose transversalium
  gains move with their input, C7): within 20 LSB, mean under 2 LSB;
- the bilinear resize: within 1 LSB of cv2.resize on < 1% of pixels.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.analyser import SpectralAnalyser as JaxAnalyser
from solex_ser_recon_en_tpu.analyser import atlas as jax_atlas
from solex_ser_recon_en_tpu.analyser import core as jax_core
from solex_ser_recon_en_tpu.config import Options as JaxOptions
from solex_ser_recon_en_tpu.ops import recon as jax_recon
from solex_ser_recon_en_tpu.ops import reduce as jax_reduce
from solex_ser_recon_en_torch.analyser import SpectralAnalyser, atlas, core
from solex_ser_recon_en_torch.cli import analyse
from solex_ser_recon_en_torch.config import Options
from solex_ser_recon_en_torch.io.png import read_png
from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
from solex_ser_recon_en_torch.ops import fused_cuda, recon
from solex_ser_recon_en_torch.ops.resize import resize_linear
from solex_ser_recon_en_torch.utils import placement

from torch_parity import lsb_diff, t

HALPHA = 6562.808
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scan_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("an") / "scan.ser")
    SyntheticScan(ih=360, iw=300, frames=220, depth=16,
                  line_poly=(150.0, 0.02, -1e-4, 0.0), disk_radius=100.0,
                  squash_y=1.08, noise=0.002, seed=4).write(p)
    return p


@pytest.fixture(scope="module")
def pair(scan_path):
    return JaxAnalyser(scan_path), SpectralAnalyser(scan_path, device="cpu")


def test_line_tables_equal():
    assert atlas.anchor_table() == jax_atlas.anchor_table()
    assert atlas.target_table() == jax_atlas.target_table()
    assert atlas.load_anchor_lines() == jax_atlas.load_anchor_lines()


def test_shipped_atlas_equal():
    a, b = atlas.load_atlas(), jax_atlas.load_atlas()
    assert (a.first, a.last, a.step) == (b.first, b.last, b.step)
    np.testing.assert_array_equal(a.intensity, b.intensity)
    assert len(a.intensity) == 700000


def test_atlas_npz_round_trip_equal(tmp_path):
    synth = atlas.SolarAtlas.synthetic(first=5000, last=5100, step=0.01)
    p = str(tmp_path / "a.npz")
    synth.to_npz(p)
    a, b = atlas.SolarAtlas.from_npz(p), jax_atlas.SolarAtlas.from_npz(p)
    assert (a.first, a.last, a.step) == (b.first, b.last, b.step) == (
        5000, 5100, 0.01)
    np.testing.assert_array_equal(a.intensity, b.intensity)
    assert np.abs(a.intensity - synth.intensity).max() < 1 / 255 + 1e-9


@pytest.mark.parametrize("true_disp,anchor_x,W", [(0.043, 150.0, 300),
                                                  (0.065, 120.0, 240),
                                                  (0.085, 97.3, 300),
                                                  (0.11, 60.0, 128)])
def test_auto_dispersion_matches_jax(true_disp, anchor_x, W):
    shipped = atlas.load_atlas()
    lam = HALPHA + (np.arange(W) - anchor_x) * true_disp
    spectrum = 40000 * np.interp(lam, shipped.wavelengths,
                                 shipped.intensity) + 200
    d, c = core.auto_dispersion(spectrum, anchor_x, HALPHA, shipped,
                                device="cpu")
    jd, jc = jax_core.auto_dispersion(spectrum, anchor_x, HALPHA,
                                      jax_atlas.load_atlas())
    grid = np.linspace(0.02, 0.12, 3 * W)
    assert abs(int(np.argmin(np.abs(grid - d)))
               - int(np.argmin(np.abs(grid - jd)))) <= 1
    assert abs(c - jc) <= 1e-5
    assert abs(d - true_disp) / true_disp < 0.01


@pytest.mark.parametrize("target,disp,curve,width", [
    (HALPHA + 1.0, 0.05, np.full(100, 50.0), 300),
    (7000.0, 0.05, np.full(100, 50.0), 300),
    (HALPHA, 0.05, np.linspace(-100, 250, 100), 300),
    (HALPHA - 3.3, 0.043, np.linspace(120, 180, 50), 300),
])
def test_goto_shift_equal(target, disp, curve, width):
    assert core.goto_shift(target, HALPHA, disp, curve, width) == \
        jax_core.goto_shift(target, HALPHA, disp, curve, width)


def test_analyser_state_matches_jax(pair):
    j, a = pair
    assert a.state.anchor_x == j.state.anchor_x
    assert a.state.circle == j.state.circle
    assert a.state.borders == j.state.borders
    assert a.state.backup_bounds == j.state.backup_bounds
    assert a.state.downscale_f == j.state.downscale_f
    np.testing.assert_array_equal(a.state.spectrum, j.state.spectrum)
    np.testing.assert_array_equal(a.state.spectrum2, j.state.spectrum2)
    np.testing.assert_array_equal(a.mean_img, j.mean_img)
    for k in ("ratio_fixe", "slant_fix"):
        got, want = getattr(a.options, k), getattr(j.options, k)
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12), k
    assert a.transfer_count == j.transfer_count == 1
    assert a._recon_mode == "device"
    assert {"read", "upload", "mean/max", "line fit", "spectrum", "recon",
            "ellipse fit"} <= set(a.timer.times)


@pytest.mark.parametrize("shift", [-7, 0, 10])
def test_analyser_disks_within_1_lsb_of_jax(pair, shift):
    j, a = pair
    mx, _ = lsb_diff(a._recon_at(shift).numpy(), np.asarray(j._recon_at(shift)))
    assert mx <= 1
    assert a.transfer_count == 1


def test_analyser_dispersion_and_goto_match_jax(pair):
    j, a = pair
    d, jd = a.find_dispersion(HALPHA), j.find_dispersion(HALPHA)
    step = 0.1 / (3 * a.iw - 1)                # one step of the scale grid
    assert abs(d - jd) <= step + 1e-6
    a.dispersion = jd
    assert a.shift_for(HALPHA - 1.0, HALPHA) == j.shift_for(HALPHA - 1.0, HALPHA)
    assert a.wavelength_of_shift(5, HALPHA) == j.wavelength_of_shift(5, HALPHA)


def test_analyser_save_within_bounds_of_jax(pair, tmp_path):
    j, a = pair
    base = str(tmp_path / "out")
    cc, pr = a.save(0, base)
    jc, jp = (np.asarray(x) for x in j.save(0))
    np.testing.assert_array_equal(read_png(base + "_clahe.png"), cc.numpy())
    np.testing.assert_array_equal(read_png(base + "_protus.png"), pr.numpy())
    assert cc.shape == jc.shape and pr.shape == jp.shape
    d = np.abs(cc.numpy().astype(int) - jc.astype(int))
    assert d.max() <= 15 and d.mean() < 2, (d.max(), d.mean())
    mx, frac = lsb_diff(pr.numpy(), jp)
    assert mx <= 8 and frac < 0.005, (mx, frac)
    assert a.transfer_count == 1


def test_analyser_preview_within_bounds_of_jax(pair):
    j, a = pair
    cc, pr = a.preview(0)
    jc, jp = (np.asarray(x) for x in j.preview(0))
    assert cc.shape == jc.shape and cc.shape[0] == 1000
    d = np.abs(cc.numpy().astype(int) - jc.astype(int))
    assert d.max() <= 20 and d.mean() < 2, (d.max(), d.mean())
    assert a.transfer_count == 1


def test_host_mode_matches_jax_host_mode_and_device_mode(scan_path, pair):
    _, dev = pair
    a = SpectralAnalyser(scan_path, Options(feed_mode="host"), device="cpu")
    j = JaxAnalyser(scan_path, JaxOptions(feed_mode="host"))
    assert a._recon_mode == "host" and a.transfer_count == 0
    for shift in (0, 2):
        host = a._recon_at(shift).numpy()
        np.testing.assert_array_equal(host, np.asarray(j._recon_at(shift)))
        assert lsb_diff(host, dev._recon_at(shift).numpy())[0] <= 1
    assert a.state.circle == j.state.circle
    cc, _ = a.save(0)
    assert cc.device == CPU and a.transfer_count == 0
    # the session's flags held for its calls and went back after them
    assert not placement.host_pipeline()


def test_placement_flags_hold_for_the_analyser_and_do_not_leak(pair,
                                                               monkeypatch):
    _, a = pair
    seen = []
    real = core.reconstruct

    def spy(*args, **kw):
        seen.append((placement.small_ops_on_host(), placement.host_pipeline()))
        return real(*args, **kw)

    monkeypatch.setattr(core, "reconstruct", spy)
    placement.set_small_ops_on_host(True)
    placement.set_host_pipeline(True)
    try:
        a.save(3)
        assert seen == [(False, False)]
        assert placement.small_ops_on_host() and placement.host_pipeline()
    finally:
        placement.set_small_ops_on_host(False)
        placement.set_host_pipeline(False)


@pytest.mark.parametrize("true_disp", [0.043, 0.085])
def test_dispersion_recovered_from_atlas_rendered_scan(tmp_path, true_disp):
    shipped = atlas.load_atlas()
    w, inten = shipped.wavelengths, shipped.intensity

    def spectrum(dpx):
        return np.interp(dpx * true_disp + HALPHA, w, inten)

    p = str(tmp_path / "atlas_scan.ser")
    SyntheticScan(ih=360, iw=300, frames=220, depth=16,
                  line_poly=(150.0, 0.0, 0.0, 0.0), disk_radius=100.0,
                  noise=0.002, seed=4, spectrum_fn=spectrum).write(p)
    a = SpectralAnalyser(p, atlas=shipped, device="cpu")
    d = a.find_dispersion(HALPHA)
    assert abs(d - true_disp) / true_disp < 0.01, d


@pytest.mark.parametrize("h,w,f", [(2048, 300, 1000 / 2048),
                                   (360, 220, 1000 / 360),
                                   (1100, 700, 1000 / 1100),
                                   (2000, 130, 0.5), (2001, 131, 0.5),
                                   (300, 999, 1 / 3)])
def test_resize_within_1_lsb_of_cv2(rng, h, w, f):
    img = (rng.random((h, w)) * 20000
           + np.linspace(0, 40000, w)[None, :]).astype(np.uint16)
    want = cv2.resize(img, (0, 0), fx=f, fy=f)
    got = resize_linear(t(img), f).numpy()
    assert got.shape == want.shape and got.dtype == np.uint16
    mx, frac = lsb_diff(got, want)
    assert mx <= 1 and frac < 0.01, (mx, frac)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_mean_max_equals_jax(rng, dtype):
    frames = rng.integers(0, np.iinfo(dtype).max + 1, (37, 20, 9)).astype(
        dtype)
    for got, want in zip(fused_cuda.mean_max(t(frames)),
                         jax_reduce.mean_max(frames)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mean_max_spills_every_window_exactly(rng, monkeypatch):
    """Past MAX_FRAMES frames the int32 sum spills to the int64 fold at
    each window's edge, and a launch never holds more than MAX_FRAMES
    frames (both shrunk here; the int32 sum of a 4-frame window of values
    near 65535 is what the real 2^15-frame window is to 2^31)."""
    frames = rng.integers(60000, 65536, (23, 6, 5)).astype(np.uint16)
    monkeypatch.setattr(fused_cuda, "SPILL_FRAMES", 4)
    monkeypatch.setattr(jax_reduce.MeanMaxAccumulator, "_SPILL", 4)
    monkeypatch.setattr(fused_cuda, "MAX_FRAMES", 3)
    launched = []
    real = fused_cuda.sum_max
    monkeypatch.setattr(fused_cuda, "sum_max", lambda c, s, m: (
        launched.append(c.shape[0]), real(c, s, m)))
    got = fused_cuda.mean_max(t(frames))
    assert max(launched) <= 3 and sum(launched) == 23
    jacc = jax_reduce.MeanMaxAccumulator()
    for a, b in ((0, 7), (7, 8), (8, 23)):
        jacc.update(frames[a:b])
    for g, want in zip(got, jacc.result()):
        np.testing.assert_array_equal(g.numpy(), want)
    exact = (frames.astype(np.uint64).sum(axis=0) / 23).astype(np.uint16)
    np.testing.assert_array_equal(got[0].numpy(), exact)


@pytest.mark.parametrize("jax_kernel", ["gather", "onehot", "pallas"])
def test_reconstruct_within_1_lsb_of_jax(rng, jax_kernel):
    """The port's recon (B3's plain version on a CPU tensor) against each
    of the JAX package's recons; the Pallas one runs interpreted."""
    F, ih, iw = 13, 40, 24
    frames = rng.integers(0, 65536, (F, ih, iw)).astype(np.uint16)
    curve = 10 + 3 * np.sin(np.arange(ih) / 7.0)
    floor = np.floor(curve).astype(np.int64)
    frac = curve - floor
    shifts = [-12, 0, 3, 15]
    got = recon.reconstruct(t(frames), floor, frac, shifts)
    want = np.asarray(jax_recon.reconstruct(frames, floor, frac, shifts,
                                            kernel=jax_kernel))
    assert got.shape == (4, ih, F) and got.dtype == torch.uint16
    assert lsb_diff(got.numpy(), want)[0] <= 1
    np.testing.assert_array_equal(
        recon.reconstruct(frames, floor, frac, shifts).numpy(), got.numpy())


def test_analyse_cli_runs_and_saves(scan_path, tmp_path, capsys):
    base = str(tmp_path / "cli")
    rc = analyse.main([scan_path, "--device", "cpu", "--dispersion", "0.05",
                       "--goto", "6562.0", "--save", base])
    assert rc == 0
    said = capsys.readouterr().out
    assert "GOTO 6562.0 Å: shift = -16 (ok)" in said
    assert os.path.exists(base + "_clahe.png")
    assert os.path.exists(base + "_protus.png")


@pytest.mark.parametrize("argv,rc,message", [
    (["--atlas", "no/such/atlas.npz", "--device", "cpu"], 2,
     "atlas 'no/such/atlas.npz' not found"),
    (["--device", "cpu", "--dispersion", "0.05", "--target", "Xx"], 1,
     "unknown target 'Xx'"),
    (["--device", "cpu", "--dispersion", "0.05", "--goto", "9000"], 1,
     "That line does not appear to be in image!"),
    (["--dispersion", "0.05"], 2, "CUDA is not available"),
])
def test_analyse_cli_exit_codes(scan_path, capsys, monkeypatch, argv, rc,
                                message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert analyse.main([scan_path] + argv) == rc
    assert message in capsys.readouterr().out
