"""The port's own copies of the JAX package's jax-free leaf modules (config,
SER I/O, synthetic scan, PNG encoder, FITS writer, run log, write pool and
figure lane, the three diagnostic plots, ``fix_edge_effect``) against the
originals: the same inputs give the same fields, bytes and arrays.  The
native host library's source is a copy too, held byte for byte, and so are
the page-cache pin, the host Canny and the host warp twins (io/pagecache.py,
ops/canny_host.py, ops/warp_host.py), the analyser's atlas module and its
four data files."""

import dataclasses
import os

import numpy as np
import pytest

from solex_ser_recon_en_tpu import config as jax_config
from solex_ser_recon_en_tpu.io import png as jax_png
from solex_ser_recon_en_tpu.io import ser as jax_ser
from solex_ser_recon_en_tpu.io.synthetic import SyntheticScan as JaxScan
from solex_ser_recon_en_tpu.utils.log import RunLog as JaxRunLog
from solex_ser_recon_en_torch import config
from solex_ser_recon_en_torch.io import png, ser, writers
from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
from solex_ser_recon_en_torch.utils.log import RunLog
from solex_ser_recon_en_torch.utils.timer import StageTimer


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_source_is_a_byte_for_byte_copy():
    """csrc/ser_io.cpp is native/ser_io.cpp: what the port needs beyond it
    goes into a second source, never into the copy."""
    with open(os.path.join(ROOT, "native", "ser_io.cpp"), "rb") as f:
        original = f.read()
    with open(os.path.join(ROOT, "solex_ser_recon_en_torch", "csrc",
                           "ser_io.cpp"), "rb") as f:
        assert f.read() == original
    assert len(original) > 50_000


@pytest.mark.parametrize("rel", [os.path.join("io", "pagecache.py"),
                                 os.path.join("ops", "canny_host.py"),
                                 os.path.join("ops", "warp_host.py"),
                                 os.path.join("analyser", "atlas.py"),
                                 os.path.join("data", "atlas.npz"),
                                 os.path.join("data", "anchor_candidates.txt"),
                                 os.path.join("data", "anchor_lines.txt"),
                                 os.path.join("data", "line_targets.txt")])
def test_whole_module_copies_are_byte_for_byte(rel):
    """numpy-only modules of the JAX package copied whole, and the
    analyser's data files, at the same relative path."""
    with open(os.path.join(ROOT, "solex_ser_recon_en_tpu", rel), "rb") as f:
        original = f.read()
    with open(os.path.join(ROOT, "solex_ser_recon_en_torch", rel), "rb") as f:
        assert f.read() == original


def test_pagecache_pin_copy_behaves_as_the_original(tmp_path, monkeypatch):
    """Small files are not pinned; a file over the floor is pinned (or
    refused by mlock) the same way by both copies."""
    from solex_ser_recon_en_tpu.io import pagecache as jax_pagecache
    from solex_ser_recon_en_torch.io import pagecache

    small = tmp_path / "small.bin"
    small.write_bytes(b"\0" * 4096)
    assert pagecache.pin(str(small)) is False
    assert jax_pagecache.pin(str(small)) is False
    big = tmp_path / "big.bin"
    big.write_bytes(b"\1" * (1 << 20))
    for mod in (pagecache, jax_pagecache):
        monkeypatch.setattr(mod, "_MIN_FILE", 1 << 16)
    try:
        got = pagecache.pin(str(big))
        assert got == jax_pagecache.pin(str(big))
        assert pagecache.pinned_bytes() == (1 << 20 if got else 0)
    finally:
        pagecache.clear()
        jax_pagecache.clear()
    monkeypatch.setenv("SOLEX_NO_PIN", "1")
    assert pagecache.pin(str(big)) is False


def test_native_library_is_not_the_jax_packages():
    """Two libraries of one source: the port loads only the file it built
    from its own csrc/ into its own directory."""
    from solex_ser_recon_en_tpu.io import native as jax_native
    from solex_ser_recon_en_torch.io import native

    native.get_lib()
    assert str(native.library_path()).startswith(str(native.build_dir()))
    assert os.path.abspath(jax_native._CACHE) != str(native.build_dir())
    assert native.SOURCE.parent.name == "csrc"
    assert native.SOURCE.parents[1].name == "solex_ser_recon_en_torch"


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
        else:
            out[f.name] = f.default
    return out


def test_options_fields_and_defaults_equal():
    assert _defaults(config.Options) == _defaults(jax_config.Options)
    assert config.Options().to_dict() == jax_config.Options().to_dict()


def test_options_round_trip_across_packages(tmp_path):
    path = str(tmp_path / "SHG_config.txt")
    opts = config.Options(shift=[-3, 0, 3], de_vignette=True, ratio_fixe=1.1,
                          trans_strength=151, output_dir="out")
    opts.save(path)
    assert jax_config.Options.load(path).to_dict() == \
        config.Options.load(path).to_dict()
    bad = config.Options(img_rotate=45)
    with pytest.raises(ValueError, match="img_rotate"):
        bad.validate()


@pytest.mark.parametrize("out_dir", ["", "  ", "/tmp/products", "rel/dir"])
def test_output_path_equal(out_dir):
    for path in ("scan_log.txt", "/data/night/scan_clahe.png"):
        assert config.output_path(path, config.Options(output_dir=out_dir)) \
            == jax_config.output_path(path,
                                      jax_config.Options(output_dir=out_dir))


@pytest.mark.parametrize("dtype,shape", [(np.uint16, (5, 7, 11)),
                                         (np.uint8, (3, 20, 9))])
def test_write_ser_same_bytes_and_reads_back(tmp_path, dtype, shape):
    rng = np.random.default_rng(2)
    frames = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    a, b = str(tmp_path / "port.ser"), str(tmp_path / "jax.ser")
    ser.write_ser(a, frames)
    jax_ser.write_ser(b, frames)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    ours, ref = ser.SerReader(a), jax_ser.SerReader(a)
    assert dataclasses.asdict(ours.header) == dataclasses.asdict(ref.header)
    assert (ours.frame_count, ours.flag_rotate, ours.ih, ours.iw) == \
        (ref.frame_count, ref.flag_rotate, ref.ih, ref.iw)
    np.testing.assert_array_equal(ours.raw_frames(), frames)
    np.testing.assert_array_equal(ours.read(1, 2), ref.read(1, 2))


def test_ser_reader_rejects_a_truncated_file(tmp_path):
    path = str(tmp_path / "short.ser")
    ser.write_ser(path, np.zeros((2, 4, 4), np.uint16))
    with open(path, "r+b") as f:
        f.truncate(ser.HEADER_SIZE + 10)
    with pytest.raises(ValueError, match="no complete frame"):
        ser.SerReader(path)


@pytest.mark.parametrize("kwargs", [
    dict(seed=5),
    dict(ih=64, iw=32, frames=50, depth=8, line_poly=(16.0, 0.01, 0.0, 0.0),
         trans_stripes=0.1, vignette=0.2, noise=0.003, seed=9),
    dict(ih=96, iw=40, frames=300, squash_y=1.08, shear=0.02, noise=0.002,
         seed=1),
])
def test_synthetic_scan_equal(kwargs, tmp_path):
    ours, ref = SyntheticScan(**kwargs), JaxScan(**kwargs)
    np.testing.assert_array_equal(ours.generate(), ref.generate())
    np.testing.assert_array_equal(ours.disk_brightness(), ref.disk_brightness())
    np.testing.assert_array_equal(ours.row_gain, ref.row_gain)
    a, b = str(tmp_path / "a.ser"), str(tmp_path / "b.ser")
    np.testing.assert_array_equal(ours.write(a, transpose_to_wide=True),
                                  ref.write(b, transpose_to_wide=True))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("case", ["u16", "u8", "float", "few_rows", "wide"])
def test_write_png_streaming_same_bytes(tmp_path, case):
    rng = np.random.default_rng(8)
    img = {
        "u16": lambda: rng.integers(0, 65536, (37, 53)).astype(np.uint16),
        "u8": lambda: rng.integers(0, 256, (20, 31)).astype(np.uint8),
        "float": lambda: rng.normal(3e4, 4e4, (17, 9)),
        "few_rows": lambda: rng.integers(0, 65536, (3, 40)).astype(np.uint16),
        # bands of more than 65535 bytes: several stored blocks per band
        "wide": lambda: rng.integers(0, 65536, (64, 5000)).astype(np.uint16),
    }[case]()
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    png.write_png_streaming(a, img)
    jax_png.write_png_streaming(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    want = img if img.dtype in (np.uint8, np.uint16) else \
        np.clip(img, 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(png.read_png(a), want)


def test_run_log_writes_the_same_lines(tmp_path):
    texts = []
    for cls, opts in ((RunLog, config.Options(output_dir=str(tmp_path))),
                      (JaxRunLog, jax_config.Options(output_dir=str(tmp_path)))):
        log = cls(str(tmp_path / "sub" / "scan"), opts)
        assert log.path == str(tmp_path / "scan_log.txt")
        log.clear()
        log("Pixel shift : [0]")
        log.complete()
        with open(log.path) as f:
            texts.append([line.split(":")[0] for line in f])
        os.remove(log.path)
    assert texts[0] == texts[1] == ["start time", "Pixel shift ", "end time"]
    quiet = RunLog(str(tmp_path / "q"), config.Options(_nolog=True))
    quiet.clear()
    quiet("nothing")
    assert not os.path.exists(quiet.path)


def test_stage_timer_accumulates():
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("a"):
            pass
    assert list(timer.times) == ["a"] and timer.times["a"] >= 0
    assert timer.summary().splitlines()[-1].startswith("  total:")


def test_write_pool_joins_and_reraises(tmp_path):
    done = []
    writers.submit(done.append, 1)
    writers.submit(done.append, 2)
    writers.barrier()
    assert sorted(done) == [1, 2]

    def boom():
        raise OSError("disk full")

    writers.submit(boom)
    writers.submit(done.append, 3)
    with pytest.raises(OSError, match="disk full"):
        writers.barrier()
    assert 3 in done
    writers.barrier()          # nothing left pending


# ---- FITS, the figure lane, the plots, fix_edge_effect ----------------------


def test_fits_module_copies_its_original(tmp_path):
    """io/fits.py: the same header dict, the same cards, the same bytes for
    every dtype the products use, and each reader reads the other's file
    (tests/test_torch_fits.py holds every dtype and both routes)."""
    from solex_ser_recon_en_tpu.io import fits as jax_fits
    from solex_ser_recon_en_torch.io import fits

    assert fits.make_header(2048, 300) == jax_fits.make_header(2048, 300)
    assert fits.BLOCK == jax_fits.BLOCK
    assert fits._DTYPE_TO_BITPIX == jax_fits._DTYPE_TO_BITPIX
    for key, value, comment in (("SIMPLE", True, "conforms"), ("N", 7, ""),
                                ("X", 1.5e-7, "f"), ("S", "it's", ""),
                                ("LONGKEYWORD", np.int32(3), "")):
        assert fits._card(key, value, comment) == \
            jax_fits._card(key, value, comment)
    rng = np.random.default_rng(6)
    for arr in (rng.integers(0, 65536, (20, 30)).astype(np.uint16),
                rng.normal(0, 1e4, (20, 30))):
        a, b = str(tmp_path / "a.fits"), str(tmp_path / "b.fits")
        fits.write_fits(a, arr, fits.make_header(30, 20))
        jax_fits.write_fits(b, arr, jax_fits.make_header(30, 20))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        np.testing.assert_array_equal(jax_fits.read_fits(a)[0],
                                      fits.read_fits(b)[0])


def test_fix_edge_effect_source_is_a_copy():
    """pipeline/transversalium.py:fix_edge_effect is the JAX function line
    for line (numpy only)."""
    import inspect

    from solex_ser_recon_en_tpu.pipeline import transversalium as jax_tr
    from solex_ser_recon_en_torch.pipeline import transversalium as tr

    for name in ("fix_edge_effect", "tukey_taper", "_row_band",
                 "_gain_from_mean_r"):
        ours = inspect.getsource(getattr(tr, name))
        ref = inspect.getsource(getattr(jax_tr, name))
        if name == "_gain_from_mean_r":      # the docstring's first line
            ours, ref = ours.split('"""')[2], ref.split('"""')[2]
        assert ours == ref, name


def _linefit_for_plot(ih=120, iw=60):
    from solex_ser_recon_en_torch.geometry.linefit import fit_spectral_line

    rng = np.random.default_rng(3)
    ys = np.arange(ih)
    line = 30 + 0.02 * ys
    mean = (20000 - 15000 * np.exp(-0.5 * ((np.arange(iw)[None, :]
                                            - line[:, None]) / 2.0) ** 2))
    mean[:15] = mean[-15:] = 50
    mean = (mean + rng.normal(0, 20, mean.shape)).clip(0, 65535).astype(
        np.uint16)
    return mean, fit_spectral_line(mean, mean)


def test_plots_write_the_same_png_bytes(tmp_path):
    """pipeline/plots.py: the three figures from the same inputs, byte for
    byte (matplotlib's Agg output is deterministic); the port's also take
    tensors."""
    import torch

    from solex_ser_recon_en_tpu.geometry.correct import (
        GeometryResult as JaxGeometry,
    )
    from solex_ser_recon_en_tpu.pipeline import plots as jax_plots
    from solex_ser_recon_en_torch import interop
    from solex_ser_recon_en_torch.pipeline import plots

    def same(name, ours, ref):
        ours(str(tmp_path / ("port_" + name)))
        ref(str(tmp_path / ("jax_" + name)))
        a = (tmp_path / ("port_" + name)).read_bytes()
        assert a == (tmp_path / ("jax_" + name)).read_bytes()
        assert a[:8] == b"\x89PNG\r\n\x1a\n" and len(a) > 5000

    c = 1 + 0.1 * np.sin(np.arange(300) / 9.0)
    same("t.png", lambda p: plots.save_transversalium_plot(p, c),
         lambda p: jax_plots.save_transversalium_plot(p, c))

    mean, lf = _linefit_for_plot()
    assert lf.sharp_min is not None and lf.mask_good is not None
    same("s.png", lambda p: plots.save_spectral_line_plot(p, mean, lf),
         lambda p: jax_plots.save_spectral_line_plot(p, mean, lf))

    rng = np.random.default_rng(4)
    image = rng.integers(0, 65536, (90, 110)).astype(np.uint16)
    th = np.linspace(0, 2 * np.pi, 50)
    pts = np.stack([45 + 30 * np.sin(th), 55 + 35 * np.cos(th)], axis=1)
    geo_j = JaxGeometry(image=image[:, ::-1].copy(), circle=(55.0, 45.0, 30.0),
                        ratio=1.1, phi=0.05, borders=[20.0, 15.0, 90.0, 75.0],
                        mat3=np.eye(3), raw_edges=pts + 1.0, kept_edges=pts,
                        ellipse_pts=pts * 1.01)
    geo_t = interop.geometry(geo_j)
    assert isinstance(geo_t.image, torch.Tensor)
    np.testing.assert_array_equal(geo_t.raw_edges, geo_j.raw_edges)
    same("e.png",
         lambda p: plots.save_ellipse_fit_plot(p, torch.from_numpy(image),
                                               geo_t),
         lambda p: jax_plots.save_ellipse_fit_plot(p, image, geo_j))
    # the banded fast pass A's figure: the full mean swept at render time
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan

    scan = str(tmp_path / "fig.ser")
    SyntheticScan(ih=96, iw=48, frames=30, seed=2).write(
        scan, transpose_to_wide=True)
    same("d.png", lambda p: plots.deferred_spectral_line_plot(p, scan, lf),
         lambda p: jax_plots.deferred_spectral_line_plot(p, scan, lf))


def test_figure_lane_defers_spills_and_reraises(monkeypatch):
    """io/writers.py's figure lane as in the original: nothing renders
    before ``figure_barrier``; beyond the queue depth the oldest entries
    spill to the background worker; the first error is re-raised after all
    were tried; SOLEX_SYNC_WRITES=1 runs everything inline."""
    from solex_ser_recon_en_tpu.io import writers as jax_writers

    assert writers._FIG_QUEUE_DEPTH == jax_writers._FIG_QUEUE_DEPTH
    monkeypatch.delenv("SOLEX_SYNC_WRITES", raising=False)
    for mod in (writers, jax_writers):
        # a lane of its own: figures other tests left queued stay queued
        monkeypatch.setattr(mod, "_fig_queue", [])
        monkeypatch.setattr(mod, "_pending_figs", [])
        done = []
        mod.submit_figure(done.append, "a")
        mod.submit_figure(done.append, "b")
        mod.barrier()                       # the data barrier renders none
        assert done == []
        mod.figure_barrier()
        assert done == ["a", "b"]

        n = mod._FIG_QUEUE_DEPTH + 3
        for k in range(n):
            mod.submit_figure(done.append, k)
        assert len(mod._fig_queue) == mod._FIG_QUEUE_DEPTH
        assert len(mod._pending_figs) == 3
        mod.figure_barrier()
        assert sorted(done[2:]) == list(range(n))
        assert mod._fig_queue == [] and mod._pending_figs == []

        def boom():
            raise OSError("no display")

        mod.submit_figure(boom)
        mod.submit_figure(done.append, "after")
        with pytest.raises(OSError, match="no display"):
            mod.figure_barrier()
        assert done[-1] == "after"
        mod.figure_barrier()

    monkeypatch.setenv("SOLEX_SYNC_WRITES", "1")
    done = []
    writers.submit_figure(done.append, 1)
    writers.submit(done.append, 2)
    assert done == [1, 2]
    assert writers._fig_queue == [] and writers._pending == []


def test_scan_write_groups_join_one_scans_writes():
    """io/writers.py's one addition to the original: writes submitted in
    ``scan_writes(futures)`` also go into ``futures``, and
    ``barrier(futures)`` joins those alone, with their error."""
    import threading

    gate = threading.Event()
    done = []

    def slow_fail():
        gate.wait(5)
        raise OSError("disk full")

    mine, theirs = [], []
    with writers.scan_writes(theirs):
        writers.submit(slow_fail)
    with writers.scan_writes(mine):
        writers.submit(done.append, "mine")
    writers.submit(done.append, "loose")         # in no scan
    writers.barrier(mine)                        # does not wait on theirs
    assert "mine" in done and mine == [] and len(theirs) == 1
    gate.set()
    with pytest.raises(OSError, match="disk full"):
        writers.barrier(theirs)
    writers.barrier()                            # joins the loose write
    assert "loose" in done


# ---- the session driver's copies ---------------------------------------------


@pytest.mark.parametrize("module,names", [
    ("parallel.distributed", ("assign_files", "shard_folder_batch")),
    ("io.video", ("VideoReader", "_SerVideo", "_parse_raw_gray_avi")),
    ("io.hostreduce", ("host_mean_max_frames",)),
    ("cli.main", ("read_ini", "write_ini", "precheck_files", "is_openable",
                  "folder_scan_files")),
    ("pipeline.batch", ("_group_key",)),
])
def test_session_sources_are_copies(module, names):
    """Functions of the session driver that the port copies line for line
    (pipeline/batch.py:_group_key and io/video.py's readers import the
    port's own modules)."""
    import importlib
    import inspect

    ours = importlib.import_module("solex_ser_recon_en_torch." + module)
    ref = importlib.import_module("solex_ser_recon_en_tpu." + module)
    for name in names:
        assert inspect.getsource(getattr(ours, name)) == \
            inspect.getsource(getattr(ref, name)), name


def test_avi_reader_differs_only_in_how_it_imports_cv2():
    """io/video.py's _AviVideo is the JAX class but for its import of
    OpenCV, which raises an error naming cv2 where it is absent."""
    import inspect

    from solex_ser_recon_en_tpu.io import video as jax_video
    from solex_ser_recon_en_torch.io import video

    ours = inspect.getsource(video._AviVideo).splitlines()
    ref = inspect.getsource(jax_video._AviVideo).splitlines()
    gone = [line for line in ref if line not in ours]
    added = [line for line in ours if line not in ref]
    assert [g.strip() for g in gone] == ["import cv2",
                                         "import cv2  # gated import"]
    assert [a.strip() for a in added] == ["cv2 = self._cv2",
                                          "cv2 = _import_cv2(path)"]
