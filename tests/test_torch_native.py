"""The port's native host library (csrc/ser_io.cpp through io/native.py) and
what goes through it: the SER reader, the overlapped scan feed
(io/feeder.py), the line fit's host blur (ops/blur.py) and the PNG band
encoder (io/png.py), against their plain versions and the JAX package's
functions on the same inputs (numpy, seeded).

Tolerance: none.  Everything here is integers and bytes, and equal means
bit for bit.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.io import native as jax_native
from solex_ser_recon_en_tpu.io import png as jax_png
from solex_ser_recon_en_tpu.ops import blur as jax_blur
from solex_ser_recon_en_torch.io import feeder, native, png
from solex_ser_recon_en_torch.io.ser import HEADER_SIZE, SerReader, write_ser
from solex_ser_recon_en_torch.ops import blur

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _scan(tmp_path, rng, shape, depth=16, name="s.ser"):
    hi = 256 if depth == 8 else 65536
    frames = rng.integers(0, hi, shape).astype(
        np.uint8 if depth == 8 else np.uint16)
    path = str(tmp_path / name)
    write_ser(path, frames)
    return path, frames


def _feed_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("solex-torch-")
            and not t.name.startswith("solex-torch-write")]


def _no_feed_thread_left(timeout=2.0):
    end = time.time() + timeout
    while _feed_threads() and time.time() < end:
        time.sleep(0.02)
    return not _feed_threads()


# ---- the library and its reader -------------------------------------------


def test_library_builds_into_the_ports_directory():
    lib = native.get_lib()
    so = native.library_path()
    assert so.exists() and so.parent == native.build_dir()
    assert so.name.startswith("solex_torch_ser_io_")
    for name in native.CALLS:
        assert hasattr(lib, name)
    assert "g++" in native.compiler_version().lower() or \
        "gcc" in native.compiler_version().lower()


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("shape", [(12, 20, 16), (9, 6, 40)],
                         ids=["tall", "wide"])
def test_read_into_equals_python_and_jax_readers(tmp_path, rng, depth, shape):
    path, frames = _scan(tmp_path, rng, shape, depth)
    py = SerReader(path)
    ref = jax_native.NativeSerReader(path)
    with native.NativeSerReader(path) as r:
        assert (r.Width, r.Height, r.pixel_depth, r.frame_count) == \
            (shape[2], shape[1], depth, shape[0])
        assert r.frame_bytes == py.header.frame_bytes
        out = np.empty(shape, r.dtype)
        r.read_into(0, shape[0], out)
        np.testing.assert_array_equal(out, frames)
        np.testing.assert_array_equal(out, py.raw_frames())
        np.testing.assert_array_equal(out, ref.read(0, shape[0]))
        part = torch.empty((3,) + shape[1:],
                           dtype=torch.uint8 if depth == 8 else torch.uint16)
        r.read_into(5, 3, part)             # a tensor the caller owns
        np.testing.assert_array_equal(part.numpy(), frames[5:8])
        r.read_into(2, 2, out[4:6])         # a slice of a larger buffer
        np.testing.assert_array_equal(out[4:6], frames[2:4])
        r.prefetch(0, shape[0])             # a hint
        r.prefetch(shape[0] - 1, 100)       # clipped to the file's end
    ref.close()


def test_reader_clamps_a_truncated_file(tmp_path):
    frames = np.zeros((10, 8, 8), np.uint16)
    path = str(tmp_path / "t.ser")
    write_ser(path, frames)
    with open(path, "r+b") as f:
        f.truncate(HEADER_SIZE + 10 * 8 * 8 * 2 - 100)
    with native.NativeSerReader(path) as r:
        assert r.frame_count == 9 == SerReader(path).frame_count
        out = np.empty((10, 8, 8), np.uint16)
        with pytest.raises(RuntimeError, match="outside the 9 frames"):
            r.read_into(0, 10, out)
        r.read_into(0, 9, out[:9])
        with pytest.raises(RuntimeError, match="ser_prefetch"):
            r.prefetch(9, 1)


@pytest.mark.parametrize("content,why", [(b"short", "shorter than"),
                                         (None, "cannot open"),
                                         (b"\0" * 400, "bad header")])
def test_reader_raises_on_bad_files(tmp_path, content, why):
    path = tmp_path / "bad.ser"
    if content is not None:
        path.write_bytes(content)
    with pytest.raises(RuntimeError, match=why):
        native.NativeSerReader(str(path))


def test_read_into_checks_its_buffer(tmp_path, rng):
    path, frames = _scan(tmp_path, rng, (4, 6, 10))
    r = native.NativeSerReader(path)
    with pytest.raises(ValueError, match="bytes"):
        r.read_into(0, 2, np.empty((3, 6, 10), np.uint16))
    with pytest.raises(ValueError, match="contiguous"):
        r.read_into(0, 2, np.empty((2, 6, 20), np.uint16)[:, :, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        r.read_into(0, 2, torch.empty((2, 10, 6),
                                      dtype=torch.uint16).transpose(1, 2))
    with pytest.raises(TypeError):
        r.read_into(0, 2, bytearray(240))
    r.close()
    r.close()                               # closing twice is fine
    with pytest.raises(RuntimeError, match="closed"):
        r.read_into(0, 1, np.empty((1, 6, 10), np.uint16))


# ---- prefetch_iter and the feed --------------------------------------------


def test_prefetch_iter_keeps_order_and_ends():
    assert list(feeder.prefetch_iter(iter(range(50)), depth=3)) == \
        list(range(50))
    assert list(feeder.prefetch_iter(iter(()))) == []
    assert _no_feed_thread_left()


def test_prefetch_iter_raises_the_producers_exception():
    def gen():
        yield 1
        raise OSError("disk gone")

    it = feeder.prefetch_iter(gen())
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    assert _no_feed_thread_left()


def test_prefetch_iter_abandoned_stops_the_producer():
    made = []

    def gen():
        for i in range(10**6):
            made.append(i)
            yield i

    it = feeder.prefetch_iter(gen(), depth=2)
    assert next(it) == 0
    it.close()
    assert not _feed_threads()      # close() waited for the producer
    assert len(made) < 10


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ring", [3, 4])
@pytest.mark.parametrize("threads", [1, 2, 4])
def test_feed_equals_plain_feed_and_file(tmp_path, rng, threads, ring, depth):
    """50 frames in chunks of 7: eight chunks, the last of one frame."""
    path, frames = _scan(tmp_path, rng, (50, 12, 18), depth)
    reader = SerReader(path)
    it, rotate, upscale = feeder.raw_device_chunks(
        reader, 7, CPU, threads=threads, depth=ring)
    plain, rotate_p, upscale_p = feeder.raw_device_chunks_plain(reader, 7,
                                                               CPU)
    got, want = list(it), list(plain)
    assert (rotate, upscale) == (rotate_p, upscale_p) == (True, depth == 8)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(0, 50, 7))
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(
        torch.cat([c for _, c in got]).numpy(), frames)
    assert feeder.FEED["chunks"] == 8 and feeder.FEED["threads"] == threads
    assert feeder.FEED["bytes"] == frames.nbytes
    assert _no_feed_thread_left()


def test_feed_of_a_one_chunk_scan_and_default_constants(tmp_path, rng):
    path, frames = _scan(tmp_path, rng, (5, 16, 8))
    before = dict(native.CALLS)
    it, rotate, upscale = feeder.raw_device_chunks(SerReader(path), 256, CPU)
    got = list(it)
    assert len(got) == 1 and got[0][0] == 0 and not rotate and not upscale
    np.testing.assert_array_equal(got[0][1].numpy(), frames)
    assert feeder.FEED["threads"] == feeder.COPY_THREADS >= 1
    assert feeder.FEED["depth"] == feeder.RING_DEPTH >= 3
    called = {k: native.CALLS[k] - before[k] for k in before}
    assert called["ser_open"] == called["ser_close"] == 1
    assert called["ser_read"] == min(feeder.COPY_THREADS, 5)
    assert called["ser_prefetch"] == 0      # no next chunk to page in


def test_feed_chunks_are_fresh_tensors(tmp_path, rng):
    """A chunk the caller keeps is not a view of a staging buffer that the
    producer refills."""
    path, frames = _scan(tmp_path, rng, (40, 6, 10))
    it, _, _ = feeder.raw_device_chunks(SerReader(path), 4, CPU)
    kept = [c for _, c in it]
    np.testing.assert_array_equal(torch.cat(kept).numpy(), frames)


def test_feed_raises_the_producers_exception(tmp_path, rng, monkeypatch):
    path, _ = _scan(tmp_path, rng, (30, 6, 10))
    orig = native.NativeSerReader.read_into

    def read_into(self, start, count, out):
        if start >= 12:
            raise OSError("read failed at frame 12")
        orig(self, start, count, out)

    monkeypatch.setattr(native.NativeSerReader, "read_into", read_into)
    closed = native.CALLS["ser_close"]
    it, _, _ = feeder.raw_device_chunks(SerReader(path), 4, CPU, threads=2)
    with pytest.raises(OSError, match="read failed at frame 12"):
        list(it)
    assert native.CALLS["ser_close"] == closed + 1
    assert _no_feed_thread_left()


def test_closing_the_feed_early_stops_the_producer(tmp_path, rng):
    path, frames = _scan(tmp_path, rng, (200, 6, 10))
    closed = native.CALLS["ser_close"]
    reads = native.CALLS["ser_read"]
    it, _, _ = feeder.raw_device_chunks(SerReader(path), 2, CPU, threads=2)
    start, chunk = next(it)
    np.testing.assert_array_equal(chunk.numpy(), frames[:2])
    it.close()
    assert not _feed_threads()
    assert native.CALLS["ser_close"] == closed + 1
    # the producer ran ahead by the ring, not through the 100 chunks
    assert native.CALLS["ser_read"] - reads <= 2 * (feeder.RING_DEPTH + 2)


def test_feed_refuses_a_scan_that_changed_under_it(tmp_path, rng):
    path, _ = _scan(tmp_path, rng, (10, 6, 10))
    reader = SerReader(path)
    with open(path, "r+b") as f:
        f.truncate(HEADER_SIZE + 7 * 6 * 10 * 2)
    it, _, _ = feeder.raw_device_chunks(reader, 4, CPU)
    with pytest.raises(RuntimeError, match="disagree"):
        next(it)
    assert _no_feed_thread_left()


# ---- the host blur ----------------------------------------------------------


def test_blur_through_the_library_equals_numpy_and_jax(rng):
    """Fuzzed shapes and windows inside the native domain."""
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        kx = int(rng.integers(1, min(2 * w - 1, 40) + 1))
        ky = int(rng.integers(1, min(2 * h - 1, 40) + 1))
        if not native.box_blur_u16_fits((h, w), kx, ky):
            continue
        img = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        before = native.CALLS["box_blur_u16_exact"]
        f32 = blur.box_blur_host(img, kx, ky)
        u16 = blur.box_blur_u16_host(img, kx, ky)
        assert native.CALLS["box_blur_u16_exact"] == before + 2
        assert f32.dtype == np.float32 and u16.dtype == np.uint16
        np.testing.assert_array_equal(f32, blur.box_blur_host_plain(img, kx, ky))
        np.testing.assert_array_equal(
            u16, blur.box_blur_u16_host_plain(img, kx, ky))
        np.testing.assert_array_equal(f32, jax_blur.box_blur_host(img, kx, ky))
        np.testing.assert_array_equal(u16,
                                      jax_blur.box_blur_u16_host(img, kx, ky))


@pytest.mark.parametrize("shape,kx,ky,fits", [
    ((8, 6), 11, 3, True),       # lo = 5 = w - 1: the last window that fits
    ((8, 6), 12, 3, False),      # lo = 6 > w - 1
    ((8, 6), 13, 3, False),
    ((4, 30), 3, 7, True),       # lo = 3 = h - 1
    ((4, 30), 3, 8, False),
    ((300, 300), 181, 181, True),     # 32761 <= 32767
    ((300, 300), 182, 181, False),    # 32942: int32 window sums would wrap
    ((1, 1), 1, 1, True),
    ((5, 5), 0, 1, False),
])
def test_blur_domain_edges(rng, shape, kx, ky, fits):
    """The one numpy branch left: exactly outside ``box_blur_u16_fits``."""
    assert native.box_blur_u16_fits(shape, kx, ky) == fits
    img = rng.integers(0, 65536, shape).astype(np.uint16)
    before = native.CALLS["box_blur_u16_exact"]
    if kx < 1:
        with pytest.raises(ValueError):
            native.box_blur_u16(img, kx, ky, "u16")
        return
    out = blur.box_blur_u16_host(img, kx, ky)
    assert native.CALLS["box_blur_u16_exact"] == before + int(fits)
    if kx * ky <= 32767:    # past it the int32 sums wrap: no second opinion
        np.testing.assert_array_equal(
            out, blur.box_blur_u16_host_plain(img, kx, ky))
        np.testing.assert_array_equal(
            out, jax_blur.box_blur_u16_host(img, kx, ky))
    if not fits:
        with pytest.raises(ValueError, match="domain"):
            native.box_blur_u16(img, kx, ky, "u16")


def test_blur_other_inputs_take_numpy_or_raise(rng):
    before = native.CALLS["box_blur_u16_exact"]
    img8 = rng.integers(0, 256, (9, 9)).astype(np.uint8)
    np.testing.assert_array_equal(blur.box_blur_host(img8, 3, 3),
                                  jax_blur.box_blur_host(img8, 3, 3))
    stack = rng.integers(0, 65536, (2, 9, 9)).astype(np.uint16)
    np.testing.assert_array_equal(blur.box_blur_u16_host(stack, 3, 5),
                                  jax_blur.box_blur_u16_host(stack, 3, 5))
    assert native.CALLS["box_blur_u16_exact"] == before
    with pytest.raises(TypeError, match="integer"):
        blur.box_blur_host(np.zeros((4, 4), np.float32), 3, 3)
    with pytest.raises(TypeError):
        native.box_blur_u16(img8, 3, 3, "u16")
    with pytest.raises(ValueError, match="want"):
        native.box_blur_u16(stack[0], 3, 3, "f64")


# ---- the PNG encoder --------------------------------------------------------


PNG_CASES = {
    "u16": lambda r: r.integers(0, 65536, (37, 53)).astype(np.uint16),
    "u8": lambda r: r.integers(0, 256, (20, 31)).astype(np.uint8),
    "float": lambda r: r.normal(3e4, 4e4, (17, 9)),
    "few_rows": lambda r: r.integers(0, 65536, (3, 40)).astype(np.uint16),
    "one_pixel": lambda r: r.integers(0, 256, (1, 1)).astype(np.uint8),
    # bands of more than 65535 bytes: several stored blocks a band, and a
    # block boundary that falls inside a row and inside a sample
    "wide": lambda r: r.integers(0, 65536, (64, 5000)).astype(np.uint16),
    "wide_u8": lambda r: r.integers(0, 256, (40, 30001)).astype(np.uint8),
}


@pytest.mark.parametrize("case", list(PNG_CASES))
def test_png_through_the_library_equals_plain_and_jax(tmp_path, rng, case):
    img = PNG_CASES[case](rng)
    a, b, c = (str(tmp_path / n) for n in ("port.png", "plain.png", "jax.png"))
    before = native.CALLS["png_encode_stored_band"]
    png.write_png_streaming(a, img)
    assert native.CALLS["png_encode_stored_band"] - before == \
        len(png.band_bounds(img.shape[0])) == min(8, img.shape[0])
    png.write_png_streaming_plain(b, img)
    jax_png.write_png_streaming(c, img)
    data = [open(p, "rb").read() for p in (a, b, c)]
    assert data[0] == data[1] == data[2]
    want = img if img.dtype in (np.uint8, np.uint16) else \
        np.clip(img, 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(png.read_png(a), want)


def test_png_bands_are_checked(tmp_path, rng):
    img = rng.integers(0, 65536, (16, 5)).astype(np.uint16)
    bounds = png.band_bounds(16)
    path = str(tmp_path / "x.png")
    with pytest.raises(ValueError, match="bands came"):
        png.write_png_bands(path, img.shape, img.dtype,
                            (img[a:b] for a, b in bounds[:-1]))
    with pytest.raises(ValueError, match="band 1"):
        png.write_png_bands(path, img.shape, img.dtype, iter([img[0:3]]))
    with pytest.raises(ValueError, match="band 9"):
        png.write_png_bands(path, img.shape, img.dtype,
                            (img[a:b] for a, b in bounds + bounds[:1]))
    with pytest.raises(TypeError, match="uint8 or uint16"):
        png.write_png_bands(path, img.shape, np.float32, iter(()))


def test_png_pack_equals_numpy(rng):
    for dt in (np.uint8, np.uint16):
        rows = rng.integers(0, np.iinfo(dt).max + 1, (7, 13)).astype(dt)
        want = np.zeros((7, 1 + 13 * rows.itemsize), np.uint8)
        want[:, 1:] = rows.astype(rows.dtype.newbyteorder(">")).view(
            np.uint8).reshape(7, -1)
        np.testing.assert_array_equal(native.png_pack(rows), want.ravel())
        np.testing.assert_array_equal(native.png_pack(rows),
                                      jax_native.native_png_pack(rows))
    with pytest.raises(TypeError):
        native.png_pack(np.zeros((3, 3), np.float32))
    with pytest.raises(TypeError):
        native.png_encode_band(np.zeros((0, 3), np.uint8), True, True, 1, 0)


# ---- no fallback ------------------------------------------------------------


@pytest.fixture
def unbuilt(tmp_path, monkeypatch):
    """The library not loaded yet, building into an empty directory."""
    monkeypatch.setenv("SOLEX_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "build"


def test_no_compiler_raises_everywhere(unbuilt, tmp_path, rng, monkeypatch):
    """With no compiler there is no reader, no feed, no blur and no
    encoder: nothing returns None and nothing carries on in numpy."""
    path, _ = _scan(tmp_path, rng, (4, 6, 10))
    img = rng.integers(0, 65536, (12, 12)).astype(np.uint16)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot be run"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="cannot be run"):
        native.NativeSerReader(path)
    it, _, _ = feeder.raw_device_chunks(SerReader(path), 2, CPU)
    with pytest.raises(RuntimeError, match="cannot be run"):
        next(it)
    with pytest.raises(RuntimeError, match="cannot be run"):
        blur.box_blur_u16_host(img, 3, 3)
    with pytest.raises(RuntimeError, match="cannot be run"):
        blur.box_blur_host(img, 3, 3)
    with pytest.raises(RuntimeError, match="cannot be run"):
        png.write_png_streaming(str(tmp_path / "x.png"), img)
    assert not unbuilt.exists() or not list(unbuilt.iterdir())


def test_failed_build_raises_with_the_compilers_words(unbuilt, tmp_path,
                                                      monkeypatch):
    broken = tmp_path / "ser_io.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="failed.*error"):
        native.get_lib()
    assert not list(unbuilt.glob("*.so")) and not list(unbuilt.glob("*.tmp"))


def test_missing_entry_point_raises(unbuilt, tmp_path, monkeypatch):
    partial = tmp_path / "ser_io.cpp"
    partial.write_text('extern "C" int ser_read() { return -1; }\n')
    monkeypatch.setattr(native, "SOURCE", partial)
    with pytest.raises(RuntimeError, match="no entry point ser_open"):
        native.get_lib()


def test_stale_library_never_shadows_a_new_source(unbuilt, tmp_path,
                                                  monkeypatch):
    """A library built from an older source, whatever its date, is not
    loaded once the source has changed: the name is keyed to the content
    (the JAX package's test of the same name in tests/test_native.py)."""
    old_src = tmp_path / "ser_io.cpp"
    old_src.write_text('extern "C" int ser_read() { return -1; }\n')
    unbuilt.mkdir()
    with monkeypatch.context() as mp:
        mp.setattr(native, "SOURCE", old_src)
        stale = native.build()
    assert stale.exists()
    future = time.time() + 10**6
    os.utime(stale, (future, future))
    fresh = native.library_path()
    assert fresh != stale and not fresh.exists()
    lib = native.get_lib()
    assert fresh.exists()
    assert all(hasattr(lib, name) for name in native.CALLS)
    # a changed flag recipe is a new library too
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-DX=1"])
    assert native.library_path() not in (fresh, stale)


BUILD_SCRIPT = r"""
import numpy as np
from solex_ser_recon_en_torch.io import native
img = np.arange(64, dtype=np.uint16).reshape(8, 8)
print(int(native.box_blur_u16(img, 3, 3, "u16").sum()), native.library_path())
"""


def test_processes_that_build_at_once_load_whole_libraries(tmp_path):
    """Three processes find the build directory empty together: each
    builds under a name of its own and renames, so all load a whole file
    and one library is left."""
    env = dict(os.environ, SOLEX_TORCH_BUILD_DIR=str(tmp_path / "b"),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert len({o[0] for o in outs}) == 1
    left = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert len(left) == 1 and left[0].endswith(".so"), left
