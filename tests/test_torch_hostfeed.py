"""The ``band`` and ``host`` feeds of the PyTorch port against the JAX
package's, and the ``auto`` policy (CPU).

The host passes (io/hostreduce.py) come from the same C++ built with the
same flags, so pass A's mean and max, the fast pass A's fit and the
float64 disks are held bit for bit to the JAX functions, and each native
sweep to its numpy twin in the port (``hostreduce.NATIVE`` False).  The
``band`` feed uploads only the spectral band and runs kernel B3's plain
version on it here: its disks and ``_clahe.png`` equal the port's
``device`` feed's bit for bit.  Against the JAX ``band`` feed, whose
one-hot contraction on XLA:CPU contracts the lerp into an FMA (ROADMAP
C2), the disks agree within 1 LSB and ``_clahe.png`` within C4's bound.
The ``host`` feed runs the JAX package's host pipeline on both sides (its
host product core needs SOLEX_HOST_PRODUCTS=1 there): mean, max, fit,
disks and ``_clahe.png`` identical.
"""

import math
import os
import threading

import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.config import Options as JaxOptions
from solex_ser_recon_en_tpu.geometry.linefit import (
    fit_spectral_line_banded as jax_fit_banded,
)
from solex_ser_recon_en_tpu.io import hostreduce as jhr
from solex_ser_recon_en_tpu.io.fits import read_fits
from solex_ser_recon_en_tpu.io.png import read_image
from solex_ser_recon_en_tpu.io.ser import SerReader as JaxSerReader
from solex_ser_recon_en_tpu.pipeline import run as jax_run
from solex_ser_recon_en_torch.cli import main as cli_main
from solex_ser_recon_en_torch.config import Options
from solex_ser_recon_en_torch.geometry.linefit import (
    fit_spectral_line,
    fit_spectral_line_banded,
)
from solex_ser_recon_en_torch.io import feeder, hostreduce as hr, native
from solex_ser_recon_en_torch.io.png import read_png
from solex_ser_recon_en_torch.io.ser import SerReader
from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
from solex_ser_recon_en_torch.io.video import open_video
from solex_ser_recon_en_torch.ops import fused
from solex_ser_recon_en_torch.pipeline import products
from solex_ser_recon_en_torch.pipeline import run as port_run
from solex_ser_recon_en_torch.utils import placement

from torch_parity import lsb_diff

CPU = torch.device("cpu")


def _scan(tmp_path, wide=True, depth=16, name="fp.ser", frames=200):
    """The JAX tests' fast-pass-A scan: a spectral window wide enough that
    the recon band is a small part of it."""
    path = str(tmp_path / name)
    SyntheticScan(ih=320, iw=224, frames=frames, depth=depth,
                  line_poly=(112.0, 0.02, -1e-4, 0.0), noise=0.002,
                  seed=5).write(path, transpose_to_wide=wide)
    return path


@pytest.fixture(autouse=True)
def feed_threads_joined():
    """Every feed a test starts (the band source's copy threads, the
    producer) has ended by the test's end."""
    yield
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("solex-torch-copy", "solex-torch-feed"))]
    assert not alive, alive


@pytest.fixture
def fast_min(monkeypatch):
    """Both packages' fast pass A taken at any size (the JAX tests' way)."""
    monkeypatch.setenv("SOLEX_FASTPASSA_MIN_MB", "0")
    monkeypatch.setattr(hr, "FAST_PASSA_MIN_BYTES", 0)


# ---- native sweeps against their numpy twins and the JAX package ----------


@pytest.mark.parametrize("depth,wide", [(16, True), (16, False), (8, True)])
def test_host_mean_max_and_band_sweep(tmp_path, monkeypatch, depth, wide):
    path = _scan(tmp_path, wide=wide, depth=depth, frames=37)
    r, rj = SerReader(path), JaxSerReader(path)
    x0, x1 = 100, 131
    want = jhr.host_mean_max(rj)
    want_band = jhr.host_mean_max_band(rj, x0, x1)
    calls = dict(native.CALLS)
    got = hr.host_mean_max(r)
    got_band = hr.host_mean_max_band(r, x0, x1)
    assert native.CALLS["ser_mean_max"] == calls["ser_mean_max"] + 1
    assert native.CALLS["ser_mean_max_band"] == \
        calls["ser_mean_max_band"] + 1
    monkeypatch.setattr(hr, "NATIVE", False)
    twin = hr.host_mean_max(r)
    twin_band = hr.host_mean_max_band(r, x0, x1)
    for a, b, c in zip(got + got_band, want + want_band, twin + twin_band):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(got_band[2], hr.extract_band(
        r, x0, x1, 0, r.frame_count))
    np.testing.assert_array_equal(got_band[2], jhr.extract_band(
        rj, x0, x1, 0, r.frame_count))


@pytest.mark.parametrize("depth,wide", [(16, True), (16, False), (8, True)])
def test_native_sample_band_stats_and_mapping(tmp_path, depth, wide):
    path = _scan(tmp_path, wide=wide, depth=depth, frames=40)
    raw = SerReader(path).raw_frames()
    with native.NativeSerReader(path) as nr:
        np.testing.assert_array_equal(nr.frames(), raw)
        assert not nr.frames().flags.writeable
        s, m, n = nr.sample_stats(7)
        sub = raw[::7]
        assert n == sub.shape[0]
        np.testing.assert_array_equal(s, sub.astype(np.uint64).sum(axis=0))
        np.testing.assert_array_equal(m, sub.max(axis=0))
        H, W = raw.shape[1:]
        r0, r1, c0, c1 = H // 8, H - H // 8, W // 16, W - W // 16
        sb, mb = nr.band_stats(r0, r1, c0, c1)
        rect = raw[:, r0:r1, c0:c1]
        np.testing.assert_array_equal(sb, rect.astype(np.uint64).sum(axis=0))
        np.testing.assert_array_equal(mb, rect.max(axis=0))
        with pytest.raises(ValueError, match="outside"):
            nr.band_stats(0, H + 1, 0, W)


@pytest.mark.parametrize("depth,wide", [(16, True), (16, False), (8, True)])
def test_host_reconstruct_bit_identical(tmp_path, monkeypatch, depth, wide):
    """host_reconstruct, host_reconstruct_from_band and
    host_reconstruct_frames: the port's native loop = its numpy twin = the
    JAX package's (both native and numpy there)."""
    path = _scan(tmp_path, wide=wide, depth=depth, frames=61)
    r, rj = SerReader(path), JaxSerReader(path)
    mean, mx = hr.host_mean_max(r)
    lf = fit_spectral_line(mean, mx)
    shifts = [10, 0, -3]
    x0, x1 = hr.spectral_band(lf.floor, shifts, r.iw)
    assert (x0, x1) == jhr.spectral_band(lf.floor, shifts, r.iw)
    assert hr.band_covers(x0, x1, lf.floor, lf.frac, shifts, r.iw)
    assert not hr.band_covers(x0 + 3, x1, lf.floor, lf.frac, shifts, r.iw)
    band = hr.extract_band(r, x0, x1, 0, r.frame_count)
    frames = r.read()
    args = (lf.floor, lf.frac, shifts)
    got = [hr.host_reconstruct(r, *args, chunk_frames=16),
           hr.host_reconstruct_from_band(r, band, x0, *args, chunk_frames=16),
           hr.host_reconstruct_frames(frames, *args, chunk_frames=16)]
    want = [jhr.host_reconstruct(rj, *args),
            jhr.host_reconstruct_from_band(rj, band, x0, *args),
            jhr.host_reconstruct_frames(frames, *args)]
    monkeypatch.setattr(hr, "NATIVE", False)
    twin = [hr.host_reconstruct(r, *args),
            hr.host_reconstruct_from_band(r, band, x0, *args),
            hr.host_reconstruct_frames(frames, *args)]
    for a, b, c in zip(got, want, twin):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(got[0], got[1])


def test_recon_chunk_refuses_bad_input():
    src = np.zeros((4, 8, 8), np.uint16)
    out = np.zeros((1, 8, 4), np.uint16)
    w = np.full(8, 0.5)
    flat = np.arange(8, dtype=np.int64)[None, :] * 8
    native.recon_chunk(src, flat, 1, w, w, False, out, 0)
    with pytest.raises(ValueError, match="outside the frame"):
        native.recon_chunk(src, flat + 7, 1, w, w, False, out, 0)
    with pytest.raises(ValueError, match="cannot take frames"):
        native.recon_chunk(src, flat, 1, w, w, False, out, 1)
    with pytest.raises(TypeError):
        native.recon_chunk(src.astype(np.float32), flat, 1, w, w, False, out,
                           0)


# ---- fast pass A, the provisional band and the banded fit -----------------


@pytest.mark.parametrize("wide", [True, False])
def test_fast_passa_fit_bit_identical(tmp_path, fast_min, wide):
    path = _scan(tmp_path, wide=wide)
    r = SerReader(path)
    fast = hr.fast_passa(r, [10, 0])
    assert fast is not None, "verification gates must pass on a clean scan"
    lf, mean_band, max_band, x0, x1 = fast
    mean_img, max_img = hr.host_mean_max(r)
    lf_full = fit_spectral_line(mean_img, max_img)
    np.testing.assert_array_equal(lf.poly, lf_full.poly)
    np.testing.assert_array_equal(lf.curve, lf_full.curve)
    assert (lf.y1, lf.y2) == (lf_full.y1, lf_full.y2)
    np.testing.assert_array_equal(mean_band, mean_img[:, x0:x1])
    np.testing.assert_array_equal(max_band, max_img[:, x0:x1])
    jfast = jhr.fast_passa(JaxSerReader(path), [10, 0])
    for a, b in zip(fast[1:], jfast[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lf.poly, jfast[0].poly)
    np.testing.assert_array_equal(lf.min_blur, jfast[0].min_blur)


def test_fast_passa_gates(tmp_path, fast_min, monkeypatch, basic_scan):
    r = SerReader(_scan(tmp_path))
    miss = []
    monkeypatch.setattr(hr, "EXACT_PASSA", True)
    assert hr.fast_passa(r, [10, 0], miss=miss) is None
    monkeypatch.setattr(hr, "EXACT_PASSA", False)
    # a band covering a third or more of the frame is not worth the two-step
    rb = SerReader(basic_scan["path"])
    assert hr.fast_passa(rb, [10, 0], miss=miss) is None
    monkeypatch.setattr(hr, "FAST_PASSA_MIN_BYTES", 10**11)
    assert hr.fast_passa(r, [10, 0], miss=miss) is None
    assert [m.split()[0] for m in miss] == ["EXACT_PASSA", "the", "the"]
    assert "third" in miss[1] and "FAST_PASSA_MIN_BYTES" in miss[2]


def test_banded_fit_and_provisional_band_equal_jax(tmp_path):
    path = _scan(tmp_path)
    r, rj = SerReader(path), JaxSerReader(path)
    assert hr.provisional_spectral_band(r, [10, 0]) == \
        jhr.provisional_spectral_band(rj, [10, 0])
    mean, mx = hr.host_mean_max(r)
    lf_full = fit_spectral_line(mean, mx)
    sub = fit_spectral_line(mean[:, :], mx)
    for x0, wb in ((80, 64), (60, 120), (100, 20), (140, 60)):
        a = fit_spectral_line_banded(mean[:, x0:x0 + wb], mx[:, x0:x0 + wb],
                                     x0, r.iw, sub)
        b = jax_fit_banded(mean[:, x0:x0 + wb], mx[:, x0:x0 + wb], x0, r.iw,
                           sub)
        assert (a is None) == (b is None), x0
        if a is not None:
            np.testing.assert_array_equal(a.poly, b.poly)
            np.testing.assert_array_equal(a.poly, lf_full.poly)


# ---- the band source and kernel B3's band input ---------------------------


@pytest.mark.parametrize("wide,depth,threads,slab",
                         [(True, 16, 1, False), (True, 16, 4, False),
                          (False, 16, 2, False), (True, 8, 3, False),
                          (True, 16, 2, True), (False, 16, 3, True)])
def test_band_device_chunks(tmp_path, wide, depth, threads, slab):
    path = _scan(tmp_path, wide=wide, depth=depth, frames=53)
    r = SerReader(path)
    x0, x1 = 97, 130
    band = hr.extract_band(r, x0, x1, 0, r.frame_count)
    it, rotate, upscale = feeder.band_device_chunks(
        r, x0, x1, 10, CPU, slab=band if slab else None, threads=threads)
    got = list(it)
    assert (rotate, upscale) == (wide, depth == 8)
    assert [s for s, _, _ in got] == list(range(0, 53, 10))
    cat = torch.cat([c.view(torch.int16) if c.dtype == torch.uint16 else c
                     for _, c, _ in got]).numpy()
    np.testing.assert_array_equal(cat.view(band.dtype), band)
    assert feeder.FEED["chunks"] == 6 and feeder.FEED["threads"] == threads


def test_band_source_refuses_a_wrong_slab(tmp_path):
    r = SerReader(_scan(tmp_path, frames=12))
    with pytest.raises(ValueError, match="band slab"):
        feeder.band_device_chunks(r, 97, 130, 4, CPU,
                                  slab=np.zeros((12, 3, 3), np.uint16))


@pytest.mark.parametrize("wide,depth", [(True, 16), (False, 16), (True, 8)])
def test_reconstruct_band_equals_full_recon(tmp_path, wide, depth):
    """Kernel B3's plain version on band chunks (band-local taps) = on the
    whole raw chunks; a band that misses a tap raises."""
    path = _scan(tmp_path, wide=wide, depth=depth, frames=70)
    vid = open_video(path)
    r = vid._r
    mean, mx = hr.host_mean_max(r)
    lf = fit_spectral_line(mean, mx)
    shifts = [10, 0]
    it, rotate, upscale = feeder.raw_device_chunks(vid, 16, CPU)
    shape = (vid.Height, vid.Width) if rotate else (vid.ih, vid.iw)
    proc = fused.RawScanProcessor(*shape, rotate, upscale, CPU)
    for start, c, shard in it:
        proc.accumulate(start, c, shard=shard)
    full = proc.reconstruct(lf.floor, lf.frac, shifts)
    x0, x1 = hr.spectral_band(lf.floor, shifts, vid.iw)
    it, _, _ = feeder.band_device_chunks(r, x0, x1, 16, CPU)
    band = fused.reconstruct_band(it, lf.floor, lf.frac, shifts, vid.iw, x0,
                                  rotate, upscale, CPU, vid.frame_count)
    assert torch.equal(band.view(torch.int16), full.view(torch.int16))
    it, _, _ = feeder.band_device_chunks(r, x0 + 4, x1, 16, CPU)
    with pytest.raises(ValueError, match="does not hold the taps"):
        fused.reconstruct_band(it, lf.floor, lf.frac, shifts, vid.iw, x0 + 4,
                               rotate, upscale, CPU, vid.frame_count)


# ---- whole feeds ----------------------------------------------------------


def _port(path, out, feed, **kw):
    opts = Options(shift=[0], clahe_only=True, feed_mode=feed,
                   output_dir=str(out), **kw)
    os.makedirs(out, exist_ok=True)
    scan = port_run.read_scan(path, opts, CPU)
    port_run.process_scan(scan, opts)
    return scan, opts


def _jax(path, out, feed, **kw):
    opts = JaxOptions(shift=[0], clahe_only=True, feed_mode=feed,
                      output_dir=str(out), **kw)
    os.makedirs(out, exist_ok=True)
    scan = jax_run.read_scan(path, opts)
    jax_run.process_scan(scan, opts)
    return scan, opts


def _disks(scan):
    d = scan.disk_list
    if isinstance(d, list):
        return np.stack([np.asarray(x) for x in d])
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


@pytest.mark.parametrize("wide,fused_band", [(True, None), (False, None),
                                             (True, True)])
def test_band_feed_equals_device_feed(tmp_path, wide, fused_band,
                                      monkeypatch):
    """Disks and _clahe.png of ``--feed band`` = ``--feed device``, bit for
    bit, from the file and from the fused sweep's slab."""
    monkeypatch.setattr(port_run, "FUSED_BAND", fused_band)
    path = _scan(tmp_path, wide=wide)
    dev, _ = _port(path, tmp_path / "dev", "device")
    band, _ = _port(path, tmp_path / "band", "band")
    assert (dev.feed, band.feed) == ("device", "band")
    np.testing.assert_array_equal(band.mean_img, dev.mean_img)
    np.testing.assert_array_equal(_disks(band), _disks(dev))
    assert (tmp_path / "band" / "fp_shift=0_clahe.png").read_bytes() == \
        (tmp_path / "dev" / "fp_shift=0_clahe.png").read_bytes()
    log = (tmp_path / "band" / "fp_log.txt").read_text()
    assert "Feed : band (requested)" in log
    passa = "fused band sweep" if fused_band else "full host sweep"
    assert f"Pass A : {passa}" in log
    src = "slab" if fused_band else "file"
    assert "Pass B : kernel B3 on the band [" in log and f"({src})" in log


@pytest.mark.parametrize("kw", [{}, {"save_fit": True}], ids=["-c", "-cf"])
def test_host_feed_equals_jax_host_feed(tmp_path, fast_min, monkeypatch, kw):
    """Mean, max, LineFit, disks, geometry and every product file of the
    ``host`` feed identical to the JAX package's (its host product core
    on); ``-c`` takes the fast pass A on both sides, ``-f`` the full
    sweep."""
    monkeypatch.setenv("SOLEX_HOST_PRODUCTS", "1")
    path = _scan(tmp_path)
    sj, oj = _jax(path, tmp_path / "j", "host", **kw)
    st, ot = _port(path, tmp_path / "t", "host", **kw)
    assert st.host_pipeline and st.small_ops_host and st.feed == "host"
    assert st.disk_list.device.type == "cpu"
    np.testing.assert_array_equal(st.linefit.poly, sj.linefit.poly)
    np.testing.assert_array_equal(_disks(st), _disks(sj))
    if kw:
        np.testing.assert_array_equal(st.mean_img, np.asarray(sj.mean_img))
    else:
        assert st.mean_img is None and sj.mean_img is None
    assert (ot.ratio_fixe, ot.slant_fix) == (oj.ratio_fixe, oj.slant_fix)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    for name in names:
        if name.endswith(".png"):
            np.testing.assert_array_equal(read_png(str(tmp_path / "t" / name)),
                                          read_image(str(tmp_path / "j" / name)))
        elif name.endswith(".fits"):
            np.testing.assert_array_equal(
                read_fits(str(tmp_path / "t" / name))[0],
                read_fits(str(tmp_path / "j" / name))[0])
    log = (tmp_path / "t" / "fp_log.txt").read_text()
    assert ("Pass A : full host sweep" if kw else "Pass A : fast_passa") in log


def test_band_feed_against_jax_band_feed(tmp_path, monkeypatch):
    """The JAX band feed's one-hot contraction on XLA:CPU (ROADMAP C2):
    disks within 1 LSB on < 0.1% of pixels; _clahe.png within C4's bound
    (three CLAHE LUT steps times the stretch slope, + 1 LSB; measured 8
    LSB on 19% of pixels)."""
    path = _scan(tmp_path)
    sj, oj = _jax(path, tmp_path / "j", "band")
    slopes = []
    orig = products._stretch

    def spy(img, lo, hi):
        slopes.append(65535.0 / float(hi - lo))
        return orig(img, lo, hi)

    monkeypatch.setattr(products, "_stretch", spy)
    st, ot = _port(path, tmp_path / "t", "band")
    np.testing.assert_array_equal(st.mean_img, np.asarray(sj.mean_img))
    np.testing.assert_array_equal(st.linefit.poly, sj.linefit.poly)
    mx, frac = lsb_diff(_disks(st), _disks(sj))
    assert mx <= 1 and frac < 0.001
    a = read_image(str(tmp_path / "j" / "fp_shift=0_clahe.png"))
    b = read_png(str(tmp_path / "t" / "fp_shift=0_clahe.png"))
    h, w = a.shape
    lut_step = 65535 / (((h + h % 2) // 2) * ((w + w % 2) // 2))
    mx, _ = lsb_diff(b, a)
    assert mx <= math.ceil(3 * lut_step * slopes[0]) + 1


def test_host_feed_of_an_avi_equals_jax(tmp_path, monkeypatch):
    """The non-SER host feed: the frames read whole, the host mean/max and
    float64 recon of the frames in memory, on both sides."""
    from chip_smoke import write_y800_avi

    monkeypatch.setenv("SOLEX_HOST_PRODUCTS", "1")
    ser = _scan(tmp_path, depth=8, frames=90)
    avi = str(tmp_path / "fp.avi")
    write_y800_avi(avi, SerReader(ser).raw_frames())
    sj, _ = _jax(avi, tmp_path / "j", "host")
    st, _ = _port(avi, tmp_path / "t", "host")
    np.testing.assert_array_equal(st.mean_img, np.asarray(sj.mean_img))
    np.testing.assert_array_equal(_disks(st), _disks(sj))
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "t" / "fp_shift=0_clahe.png")),
        read_image(str(tmp_path / "j" / "fp_shift=0_clahe.png")))
    assert "Pass A : in-memory host pass" in \
        (tmp_path / "t" / "fp_log.txt").read_text()


def test_host_feed_sweep_batches_its_warp(tmp_path, monkeypatch):
    """A sweep on the ``host`` feed: one ``warp_u16_u16_batch`` call for
    its shifts, every PNG identical to the JAX package's host sweep."""
    monkeypatch.setenv("SOLEX_HOST_PRODUCTS", "1")
    path = _scan(tmp_path, frames=120)
    kw = dict(shift=[-2, 0, 2])
    oj = JaxOptions(clahe_only=True, feed_mode="host",
                    output_dir=str(tmp_path / "j"), **kw)
    os.makedirs(tmp_path / "j")
    jax_run.process_file(path, oj)
    before = dict(native.CALLS)
    rc = cli_main.main(["-cw-2:2:2", path, "--device", "cpu", "--feed",
                        "host", "--output-dir", str(tmp_path / "t")])
    assert rc == 0
    assert native.CALLS["warp_u16_u16_batch"] == \
        before["warp_u16_u16_batch"] + 1
    for s in (-2, 0, 2):
        name = f"fp_shift={s}_clahe.png"
        np.testing.assert_array_equal(read_png(str(tmp_path / "t" / name)),
                                      read_image(str(tmp_path / "j" / name)))


def test_fused_band_miss_takes_the_full_recon(tmp_path, monkeypatch):
    """A provisional band that misses the final fit's taps: the host
    feed's recon reads the file instead of the slab, and the run log says
    so; the disks are the same."""
    monkeypatch.setattr(port_run, "FUSED_BAND", True)
    monkeypatch.setattr(hr, "EXACT_PASSA", True)
    path = _scan(tmp_path)
    good, _ = _port(path, tmp_path / "good", "host")
    monkeypatch.setattr(port_run, "provisional_spectral_band",
                        lambda r, shifts: (0, 40))
    bad, _ = _port(path, tmp_path / "bad", "host")
    np.testing.assert_array_equal(_disks(good), _disks(bad))
    log = (tmp_path / "bad" / "fp_log.txt").read_text()
    assert "Pass A : fused band sweep (band [0, 40))" in log
    assert "Band slab does not cover" in log
    assert "Pass B : host float64 recon\n" in log
    assert "from the band slab" in (tmp_path / "good" / "fp_log.txt").read_text()


def test_fast_passa_miss_is_logged(tmp_path, monkeypatch):
    monkeypatch.setattr(hr, "FAST_PASSA_MIN_BYTES", 10**11)
    path = _scan(tmp_path, frames=60)
    _port(path, tmp_path / "o", "host")
    log = (tmp_path / "o" / "fp_log.txt").read_text()
    assert "Fast pass A not taken: the scan's" in log
    assert "Pass A : full host sweep" in log


def test_deferred_spectral_figure_byte_identical(tmp_path, fast_min,
                                                 monkeypatch):
    """The default mode on the host feed: the fast pass A leaves no full
    mean, so the spectral-line figure sweeps it on the figure lane; its
    bytes equal the full sweep's figure."""
    pytest.importorskip("matplotlib")
    path = _scan(tmp_path)
    outs = {}
    for name, fast in (("fast", True), ("classic", False)):
        monkeypatch.setattr(hr, "EXACT_PASSA", not fast)
        out = tmp_path / name
        rc = cli_main.main([path, "--device", "cpu", "--feed", "host",
                            "--output-dir", str(out)])
        assert rc == 0
        outs[name] = (out / "fp_spectral_line_data.png").read_bytes()
        passa = "fast_passa" if fast else "full host sweep"
        assert f"Pass A : {passa}" in (out / "fp_log.txt").read_text()
    assert outs["fast"] == outs["classic"]


# ---- auto, the probe and the placement -----------------------------------


@pytest.fixture
def fresh_probe(monkeypatch):
    monkeypatch.setattr(feeder, "_PROBE_CACHE", None)
    monkeypatch.setattr(feeder, "_SMALL_BYTES_SEEN", 0)


def test_auto_on_the_cpu_is_device(basic_scan, tmp_path):
    scan, _ = _port(basic_scan["path"], tmp_path, "auto")
    assert scan.feed == "device" and not scan.small_ops_host
    assert "Feed : device (auto on the CPU)" in \
        (tmp_path / "basic_log.txt").read_text()


def test_auto_policy_on_the_card(basic_scan, tmp_path, monkeypatch,
                                 fresh_probe):
    """The JAX package's rule on an accelerator, with the probe's reading
    replaced: a big SER probes once and goes ``host`` below 200 MB/s, a
    small one consults the cached reading, and an AVI goes ``device``."""
    from chip_smoke import write_y800_avi

    cuda = torch.device("cuda")
    vid = open_video(basic_scan["path"])
    probes = []

    def probe(device, rate=[150e6]):
        probes.append(device)
        feeder._PROBE_CACHE = (rate[0], 0.0)
        return rate[0]

    monkeypatch.setattr(port_run, "probe_transfer_rate", probe)
    monkeypatch.setattr(feeder, "PROBE_TTL_S", float("inf"))
    small = 10 * 1024**2
    assert port_run.auto_feed(vid, small, cuda) == \
        ("device", "auto, no link rate yet for a small scan")
    assert port_run.auto_feed(vid, 300 * 1024**2, cuda)[0] == "host"
    assert probes == [cuda]
    assert port_run.auto_feed(vid, small, cuda)[0] == "host"   # cached
    feeder._PROBE_CACHE = (5e9, 0.0)
    assert port_run.auto_feed(vid, small, cuda) == \
        ("device", "auto, link 5.000 GB/s")
    avi = str(tmp_path / "a.avi")
    write_y800_avi(avi, SerReader(basic_scan["path"]).raw_frames() >> 8)
    assert port_run.auto_feed(open_video(avi), 300 * 1024**2, cuda) == \
        ("device", "auto, not a SER")
    # small scans add up: past the threshold one probe pays for itself
    feeder._PROBE_CACHE = None
    for _ in range(25):
        port_run.auto_feed(vid, small, cuda)
    assert len(probes) == 2


def test_probe_is_memoised(fresh_probe):
    rate = feeder.probe_transfer_rate(CPU, sample_bytes=2 * 1024**2)
    assert rate > 0 and feeder.cached_probe_rate() == rate
    assert feeder.probe_transfer_rate(CPU) == rate
    assert feeder.note_small_scan(5) == 5 and feeder.note_small_scan(7) == 12


@pytest.mark.parametrize("over", [True, False])
def test_handle_files_probes_once_for_a_big_batch(basic_scan, tmp_path,
                                                  monkeypatch, over):
    calls = []
    monkeypatch.setattr(cli_main, "probe_transfer_rate", calls.append)
    size = os.path.getsize(basic_scan["path"])
    monkeypatch.setattr(cli_main, "PROBE_BATCH_BYTES",
                        2 * size - 1 if over else 2 * size)
    n = cli_main.handle_files([basic_scan["path"]] * 2,
                              Options(shift=[0], clahe_only=True,
                                      output_dir=str(tmp_path)), CPU)
    assert n == 2 and calls == ([CPU] if over else [])


def test_placement_flags_are_per_thread():
    placement.set_host_pipeline(True)
    placement.set_small_ops_on_host(True)
    seen = {}

    def other():
        seen["pipe"] = placement.host_pipeline()
        seen["small"] = placement.small_ops_on_host()
        seen["dev"] = placement.host_ops_device(torch.device("cuda"))

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen == {"pipe": False, "small": False,
                    "dev": torch.device("cuda")}
    assert placement.host_ops_device(torch.device("cuda")) == CPU
    assert placement.small_ops_device(torch.device("cuda")) == CPU
    placement.set_host_pipeline(False)
    placement.set_small_ops_on_host(False)


def test_session_keeps_each_scans_placement(tmp_path, monkeypatch):
    """Two scans of one session, the first ``host`` and the second
    ``device``: the pool thread post-processes each with its own flags
    (re-asserted from its ScanResult) while the main thread reads the
    other, and the products equal each scan run alone."""
    path = _scan(tmp_path, frames=60)
    other = str(tmp_path / "fp2.ser")
    os.link(path, other)
    feeds = {path: "host", other: "device"}
    real_read = cli_main.read_scan

    def read_scan(file, opts, device, timer=None):
        opts.feed_mode = feeds[file]
        return real_read(file, opts, device, timer)

    seen = []
    real_core = products._products_body
    real_host = products._host_core

    def body(*a, **k):
        seen.append(("device", placement.host_pipeline(),
                     placement.small_ops_on_host()))
        return real_core(*a, **k)

    def host_core(*a, **k):
        seen.append(("host", placement.host_pipeline(),
                     placement.small_ops_on_host()))
        return real_host(*a, **k)

    monkeypatch.setattr(cli_main, "read_scan", read_scan)
    monkeypatch.setattr(products, "_products_body", body)
    monkeypatch.setattr(products, "_host_core", host_core)
    out = tmp_path / "session"
    out.mkdir()
    n = cli_main.handle_files([path, other], Options(
        shift=[0], clahe_only=True, output_dir=str(out)), CPU)
    assert n == 2
    assert seen == [("host", True, True), ("device", False, False)]
    monkeypatch.undo()
    for file, feed in feeds.items():
        alone = tmp_path / f"alone_{feed}"
        _port(file, alone, feed)
        name = os.path.basename(file)[:-4] + "_shift=0_clahe.png"
        assert (out / name).read_bytes() == (alone / name).read_bytes()
