"""The ``shg -c`` slice of the PyTorch port vs the JAX package (CPU).

Stage-isolated parity: each port stage is fed, through
solex_ser_recon_en_torch.interop, exactly what the JAX stage before it
produced.  Whole-slice parity: both packages run the same scan end to end;
the JAX side takes its device feed with the separable warp switched on (its
TPU gate; on the CPU it would take the four-term warp), so both run the
same algorithm.

Why the whole slice is looser than the stages: pass B differs from the JAX
recon by 1 LSB on ~0.01% of disk pixels (XLA:CPU contracts the lerp into an
FMA).  Those pixels nudge the transversalium gains (~1e-6 relative) and
with them a few corrected pixels.  Each such pixel moves its CLAHE tile's
CDF by one count, i.e. the tile's LUT by up to 65535/tile_area levels (5.1
on this 256 x 202 disk, 0.06 at full scale), and the stretch multiplies
that by its slope (1.19 here).  Measured: identical stretch levels (dark
147, bright 55072), PNG max 15 LSB on 25% of pixels, mean 1.15 LSB.  The
whole-slice bound is that measurement rounded up to three LUT steps times
the stretch slope, + 1 LSB.  The divergence comes from the disks alone,
shown both ways: the port's chain after the recon fed the JAX disks lands
on the JAX PNG, and the JAX chain fed the port's disks on the port's PNG,
each within one stretch slope + 1 LSB on >= 99.9% identical pixels
(measured: max 2 LSB on 0.031% and 0.033% of pixels).
"""

import dataclasses
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.config import Options as JaxOptions
from solex_ser_recon_en_tpu.geometry.linefit import (
    fit_spectral_line as jax_fit_spectral_line,
)
from solex_ser_recon_en_tpu.io.png import read_image
from solex_ser_recon_en_tpu.ops.warp_fast import unit_y_row, window_for
from solex_ser_recon_en_tpu.pipeline import run as jax_run
from solex_ser_recon_en_tpu.pipeline.products import (
    _products_core_gained as jax_products_core_gained,
)
from solex_ser_recon_en_tpu.pipeline.transversalium import (
    transversalium_gain as jax_transversalium_gain,
)
from solex_ser_recon_en_torch import interop
from solex_ser_recon_en_torch.cli.main import main as cli_main
from solex_ser_recon_en_torch.config import Options
from solex_ser_recon_en_torch.geometry.correct import (
    correct_image,
    correct_images_batched,
    ellipse_to_circle,
)
from solex_ser_recon_en_torch.geometry.linefit import fit_spectral_line
from solex_ser_recon_en_torch.io.png import read_png
from solex_ser_recon_en_torch.pipeline import products as port_products
from solex_ser_recon_en_torch.pipeline import run as port_run
from solex_ser_recon_en_torch.pipeline.transversalium import (
    transversalium_gain,
)

from torch_parity import lsb_diff, t

jax_correct = importlib.import_module("solex_ser_recon_en_tpu.geometry.correct")
CPU = torch.device("cpu")


def _tpu_warp_gate(mat3):
    """geometry/correct.py:_use_fast_warp without its TPU placement test."""
    return bool(unit_y_row(mat3) and window_for(mat3) > 0)


def _stretch_slopes(monkeypatch):
    """Record 65535/(hi-lo) of every stretch the port applies."""
    slopes = []
    orig = port_products._stretch

    def spy(img, lo, hi):
        slopes.append(65535.0 / float(hi - lo))
        return orig(img, lo, hi)

    monkeypatch.setattr(port_products, "_stretch", spy)
    return slopes


@pytest.fixture(scope="module")
def runs(basic_scan, tmp_path_factory):
    """JAX and port runs of the -c path on the basic synthetic scan."""
    path = basic_scan["path"]
    out_j = str(tmp_path_factory.mktemp("jax_out"))
    out_t = str(tmp_path_factory.mktemp("port_out"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_correct, "_use_fast_warp", _tpu_warp_gate)
        oj = JaxOptions(shift=[0], clahe_only=True, feed_mode="device",
                        output_dir=out_j)
        scan_j = jax_run.read_scan(path, oj)
        jax_run.process_scan(scan_j, oj)
        slopes = _stretch_slopes(mp)
        ot = Options(shift=[0], clahe_only=True, output_dir=out_t)
        scan_t = port_run.read_scan(path, ot, CPU)
        port_run.process_scan(scan_t, ot)
    return dict(oj=oj, ot=ot, scan_j=scan_j, scan_t=scan_t, slope=slopes[0],
                png_j=read_image(out_j + "/basic_shift=0_clahe.png"),
                png_t=read_png(out_t + "/basic_shift=0_clahe.png"))


# ---- whole slice ----------------------------------------------------------


def test_slice_mean_and_disks(runs):
    sj, st = runs["scan_j"], runs["scan_t"]
    np.testing.assert_array_equal(st.mean_img, sj.mean_img)
    assert st.shifts == sj.shifts == [10, 0]
    mx, frac = lsb_diff(st.disk_list.numpy(), np.asarray(sj.disk_list))
    assert mx <= 1 and frac < 0.001
    np.testing.assert_allclose(st.linefit.poly, sj.linefit.poly, rtol=1e-12)
    np.testing.assert_array_equal(st.linefit.floor, sj.linefit.floor)


def test_slice_geometry(runs):
    oj, ot = runs["oj"], runs["ot"]
    assert ot.ratio_fixe == pytest.approx(oj.ratio_fixe, rel=1e-9)
    assert ot.slant_fix == pytest.approx(oj.slant_fix, abs=1e-9)


def test_slice_clahe_png(runs):
    """Measured: max 15 LSB (2.5 LUT steps x slope), mean 1.15 LSB, 25% of
    pixels; asserted: 3 LUT steps x slope + 1, mean <= 2 LSB."""
    a, b = runs["png_j"], runs["png_t"]
    assert a.shape == b.shape and b.dtype == np.uint16
    h, w = a.shape
    lut_step = 65535 / (((h + h % 2) // 2) * ((w + w % 2) // 2))
    mx, _ = lsb_diff(b, a)
    assert mx <= math.ceil(3 * lut_step * runs["slope"]) + 1
    assert np.abs(b.astype(np.int64) - a.astype(np.int64)).mean() <= 2.0


def test_chain_after_recon_on_jax_disks(runs, tmp_path, monkeypatch):
    """process_scan of the port on the JAX read_scan result: the PNG within
    one stretch slope + 1 LSB, >= 99.9% of pixels identical."""
    slopes = _stretch_slopes(monkeypatch)
    opts = Options(shift=[0], clahe_only=True, output_dir=str(tmp_path))
    scan = interop.scan_result(runs["scan_j"], CPU)
    scan.basefich0 = str(tmp_path / "basic")
    port_run.process_scan(scan, opts)
    b = read_png(str(tmp_path / "basic_shift=0_clahe.png"))
    mx, frac = lsb_diff(b, runs["png_j"])
    assert mx <= math.ceil(slopes[0]) + 1
    assert frac <= 0.001
    assert opts.ratio_fixe == pytest.approx(runs["oj"].ratio_fixe, rel=1e-9)


def test_jax_chain_after_recon_on_port_disks(runs, tmp_path, monkeypatch):
    """The reverse witness: process_scan of the JAX package on the port's
    read_scan disks lands on the port's PNG within one stretch slope +
    1 LSB, >= 99.9% of pixels identical, so the 1-LSB recon differences
    are what the whole-slice bound absorbs."""
    monkeypatch.setattr(jax_correct, "_use_fast_warp", _tpu_warp_gate)
    opts = JaxOptions(shift=[0], clahe_only=True, feed_mode="device",
                      output_dir=str(tmp_path))
    scan = dataclasses.replace(
        runs["scan_j"], disk_list=jnp.asarray(runs["scan_t"].disk_list.numpy()),
        basefich0=str(tmp_path / "basic"))
    jax_run.process_scan(scan, opts)
    a = read_image(str(tmp_path / "basic_shift=0_clahe.png"))
    mx, frac = lsb_diff(a, runs["png_t"])
    assert mx <= math.ceil(runs["slope"]) + 1
    assert frac <= 0.001
    assert opts.ratio_fixe == pytest.approx(runs["ot"].ratio_fixe, rel=1e-9)


# ---- stages, through interop ----------------------------------------------


def test_stage_line_fit(basic_scan):
    frames = basic_scan["frames"]
    mean = (frames.sum(axis=0, dtype=np.int64) / frames.shape[0]).astype(np.uint16)
    mx = frames.max(axis=0)
    lf_j = interop.linefit(jax_fit_spectral_line(mean, mx))
    lf_t = fit_spectral_line(mean, mx)
    np.testing.assert_array_equal(lf_t.poly, lf_j.poly)
    np.testing.assert_array_equal(lf_t.floor, lf_j.floor)
    assert (lf_t.y1, lf_t.y2) == (lf_j.y1, lf_j.y2)


@pytest.fixture(scope="module")
def jax_geometry(runs):
    """JAX ellipse fit + warp of the shift-0 disk (separable warp)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_correct, "_use_fast_warp", _tpu_warp_gate)
        return jax_correct.ellipse_to_circle(runs["scan_j"].disk_list[1])


def test_stage_ellipse_fit_and_warp(runs, jax_geometry):
    geo_j = interop.geometry(jax_geometry)
    geo_t = ellipse_to_circle(interop.tensor(runs["scan_j"].disk_list[1]))
    assert geo_t.ratio == pytest.approx(geo_j.ratio, rel=1e-9)
    assert geo_t.phi == pytest.approx(geo_j.phi, abs=1e-9)
    np.testing.assert_allclose(geo_t.circle, geo_j.circle, atol=1e-6)
    np.testing.assert_allclose(geo_t.borders, geo_j.borders, atol=1e-6)
    np.testing.assert_allclose(geo_t.mat3, geo_j.mat3, atol=1e-12)
    mx, _ = lsb_diff(geo_t.image.numpy(), geo_j.image.numpy())
    assert mx <= 1


def test_stage_transversalium_gain(jax_geometry):
    """float32 row sums run in another order than XLA's: gains agree to
    1e-6 relative (measured 1.2e-8)."""
    frame = np.asarray(jax_geometry.image)
    c_j = jax_transversalium_gain(frame, jax_geometry.circle,
                                  jax_geometry.borders, 301)[0]
    c_t = transversalium_gain(t(frame), jax_geometry.circle,
                              jax_geometry.borders, 301)[0]
    np.testing.assert_allclose(c_t, interop.gains(c_j), rtol=1e-6)
    assert not np.allclose(c_j, 1.0)  # the correction is not a no-op


def test_stage_products(jax_geometry, monkeypatch):
    """Gain multiply, CLAHE and stretches on the same frame and gain."""
    frame = np.asarray(jax_geometry.image)
    gain = jax_transversalium_gain(frame, jax_geometry.circle,
                                   jax_geometry.borders, 301)[0]
    ref = [np.asarray(a) for a in jax_products_core_gained(
        jnp.asarray(frame), jnp.asarray(gain, dtype=jnp.float32))]
    slopes = _stretch_slopes(monkeypatch)
    ours = [a.numpy() for a in port_products._products_core_gained(
        t(frame), torch.tensor(gain, dtype=torch.float32), want=(True, True))]
    detrans, cl1, cc, hc, protus = zip(ours, ref)
    np.testing.assert_array_equal(*detrans)
    mx, frac = lsb_diff(*cl1)
    assert mx <= 1 and frac < 0.01
    for (a, b), slope in zip((cc, hc, protus), slopes):
        mx, frac = lsb_diff(a, b)
        assert mx <= math.ceil(slope) + 1 and frac < 0.01


# ---- command line ---------------------------------------------------------


def test_cli_runs_on_cpu(basic_scan, tmp_path):
    rc = cli_main(["-cw0", basic_scan["path"], "--device", "cpu",
                   "--output-dir", str(tmp_path)])
    assert rc == 0
    assert read_png(str(tmp_path / "basic_shift=0_clahe.png")).shape[0] == 256


def test_cli_cuda_missing_fails(basic_scan, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    rc = cli_main(["-cw0", basic_scan["path"], "--output-dir", str(tmp_path)])
    assert rc != 0
    assert "device 'cuda' requested but CUDA is not available" in \
        capsys.readouterr().out
    assert not (tmp_path / "basic_shift=0_clahe.png").exists()


def test_unported_options_raise(basic_scan, tmp_path, monkeypatch):
    """What still raises: ``flag_display``, a malformed ``mesh``, and
    figures where matplotlib is absent; the product modes and the mesh,
    which used to raise, run."""
    import sys

    import solex_ser_recon_en_torch.pipeline as pipeline_pkg

    with pytest.raises(NotImplementedError, match="flag_display"):
        port_run.read_scan(basic_scan["path"],
                           Options(clahe_only=True, flag_display=True), CPU)
    with pytest.raises(ValueError, match="mesh"):
        port_run.read_scan(basic_scan["path"],
                           Options(clahe_only=True, mesh="1x2",
                                   output_dir=str(tmp_path)), CPU)
    assert list(tmp_path.iterdir()) == []
    for kw in (dict(), dict(save_fit=True), dict(protus_only=True),
               dict(crop_width_square=True), dict(fixed_width=300),
               dict(stubborn_transversalium=True), dict(de_vignette=True),
               dict(mesh={"frame": 2})):
        port_run.check_supported(Options(**kw))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "solex_ser_recon_en_torch.pipeline.plots",
                        raising=False)
    monkeypatch.delattr(pipeline_pkg, "plots", raising=False)
    with pytest.raises(RuntimeError, match="matplotlib"):
        port_run.read_scan(basic_scan["path"],
                           Options(output_dir=str(tmp_path)), CPU)
    assert list(tmp_path.iterdir()) == []
    port_run.check_supported(Options(clahe_only=True))


def test_batched_warp_matches_per_image(runs):
    """A Doppler sweep's batched warp equals the per-shift warps."""
    disks = runs["scan_t"].disk_list
    phi, ratio = math.radians(runs["ot"].slant_fix), runs["ot"].ratio_fixe
    batch, circle, mat3 = correct_images_batched(disks, phi, ratio)
    for k in range(disks.shape[0]):
        one, circle1, mat31 = correct_image(disks[k], phi, ratio,
                                            np.array([-1.0, -1.0]), -1.0)
        np.testing.assert_array_equal(batch[k].numpy(), one.numpy())
    assert circle == circle1
    np.testing.assert_array_equal(mat3, mat31)


def test_doppler_sweep_matches_single_shift(basic_scan, tmp_path):
    """-w-3:3:3: every requested shift gets its product, in the reference's
    order, and the batched warp leaves shift 0 identical to a -w0 run."""
    sweep = Options(shift=[-3, 0, 3], clahe_only=True,
                    output_dir=str(tmp_path / "sweep"))
    (tmp_path / "sweep").mkdir()
    results = port_run.process_file(basic_scan["path"], sweep, CPU)
    assert [s for s, _ in results] == [0, -3, 3]
    (tmp_path / "one").mkdir()
    port_run.process_file(basic_scan["path"], Options(
        shift=[0], clahe_only=True, output_dir=str(tmp_path / "one")), CPU)
    for s in (-3, 3):
        assert (tmp_path / "sweep" / f"basic_shift={s}_clahe.png").exists()
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "sweep" / "basic_shift=0_clahe.png")),
        read_png(str(tmp_path / "one" / "basic_shift=0_clahe.png")))


def _frames_into_products(monkeypatch):
    """Record the circularised frame process_scan hands to the products."""
    frames = []
    orig = port_run.single_image_process

    def spy(frame, *a, **k):
        frames.append(frame)
        return orig(frame, *a, **k)

    monkeypatch.setattr(port_run, "single_image_process", spy)
    return frames


@pytest.mark.parametrize("fit_fails", [False, True])
def test_fit_shift_requested(runs, tmp_path, monkeypatch, fit_fails):
    """-w10 asks for the ellipse-fit shift itself: its frame is the fitted
    warp of ellipse_to_circle; when the fit fails the scan goes on with the
    identity geometry, as in the JAX package."""
    disks = runs["scan_t"].disk_list
    scan = dataclasses.replace(runs["scan_t"], shift_requested=[10],
                               basefich0=str(tmp_path / "basic"))
    if fit_fails:
        def no_fit(*a, **k):
            raise ValueError("could not find any edges")

        monkeypatch.setattr(port_run, "ellipse_to_circle", no_fit)
    frames = _frames_into_products(monkeypatch)
    opts = Options(shift=[10], clahe_only=True, _nolog=True)
    port_run.process_scan(scan, opts)
    assert len(frames) == 1
    if fit_fails:
        want = correct_image(disks[0], 0.0, 1.0, np.array([-1.0, -1.0]),
                             -1.0)[0]
        assert (opts.ratio_fixe, opts.slant_fix) == (1.0, 0.0)
    else:
        want = ellipse_to_circle(disks[0]).image
        assert opts.ratio_fixe == pytest.approx(runs["ot"].ratio_fixe,
                                                rel=1e-9)
    np.testing.assert_array_equal(frames[0].numpy(), want.numpy())


def test_streaming_pass_b_matches_resident(basic_scan, runs, monkeypatch):
    """Scans too big to stay resident re-read the file for pass B; the
    disks are identical to the resident path's."""
    monkeypatch.setattr(port_run, "RESIDENT_CAP_BYTES", 0)
    scan = port_run.read_scan(basic_scan["path"], Options(
        shift=[0], clahe_only=True, _nolog=True), CPU)
    np.testing.assert_array_equal(scan.disk_list.numpy(),
                                  runs["scan_t"].disk_list.numpy())


def test_mirror_flag_flips_disks(basic_scan, runs):
    """-m mirrors every disk along the frame axis, exactly."""
    scan = port_run.read_scan(basic_scan["path"], Options(
        shift=[0], clahe_only=True, flip_x=True, _nolog=True), CPU)
    np.testing.assert_array_equal(scan.disk_list.numpy(),
                                  runs["scan_t"].disk_list.numpy()[:, :, ::-1])


# ---- the host library on the slice's path ----------------------------------


def test_slice_through_native_library_equals_plain_routes(basic_scan, tmp_path,
                                                          monkeypatch):
    """-cw0 on the CPU reads, blurs and encodes through the native library
    (counted), and its products equal, byte for byte, those of the same
    run on the plain feed, the numpy blur and the stdlib encoder."""
    from solex_ser_recon_en_torch.geometry import linefit
    from solex_ser_recon_en_torch.io import feeder, native, png
    from solex_ser_recon_en_torch.ops import blur

    before = dict(native.CALLS)
    out_n, out_p = tmp_path / "native", tmp_path / "plain"
    assert cli_main(["-cw0", basic_scan["path"], "--device", "cpu",
                     "--output-dir", str(out_n)]) == 0
    called = {k: native.CALLS[k] - before[k] for k in before}
    assert called["ser_read"] >= 1 and called["ser_close"] == 1
    assert called["box_blur_u16_exact"] == 2        # detect_bord, the fit
    assert called["png_encode_stored_band"] == 8

    monkeypatch.setattr(port_run, "raw_device_chunks",
                        feeder.raw_device_chunks_plain)
    monkeypatch.setattr(linefit, "box_blur_u16_host",
                        blur.box_blur_u16_host_plain)
    monkeypatch.setattr(port_products, "write_png_streaming",
                        png.write_png_streaming_plain)
    before = dict(native.CALLS)
    assert cli_main(["-cw0", basic_scan["path"], "--device", "cpu",
                     "--output-dir", str(out_p)]) == 0
    assert native.CALLS == before
    names = sorted(p.name for p in out_n.iterdir())
    assert names == sorted(p.name for p in out_p.iterdir())
    assert "basic_shift=0_clahe.png" in names
    for name in names:
        if name.endswith(".png"):
            assert (out_n / name).read_bytes() == (out_p / name).read_bytes()


def test_read_scan_error_between_chunks_stops_the_feed(basic_scan,
                                                       monkeypatch):
    """An error in pass A leaves no producer thread and no open reader."""
    import threading

    from solex_ser_recon_en_torch.io import native
    from solex_ser_recon_en_torch.ops.fused import RawScanProcessor

    def accumulate(self, start, chunk, keep=True, shard=0):
        raise ValueError("pass A failed")

    monkeypatch.setattr(RawScanProcessor, "accumulate", accumulate)
    opened, closed = native.CALLS["ser_open"], native.CALLS["ser_close"]
    with pytest.raises(ValueError, match="pass A failed"):
        port_run.read_scan(basic_scan["path"], Options(
            shift=[0], clahe_only=True, frame_chunk=16, _nolog=True), CPU)
    assert native.CALLS["ser_open"] - opened == 1
    assert native.CALLS["ser_close"] - closed == 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("solex-torch-feed",
                                      "solex-torch-copy"))]
