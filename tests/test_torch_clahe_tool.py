"""The port's CLAHE tool (``shg-torch-clahe``, cli/clahe_tool.py), its image
reader (io/png.py:read_image, read_png) and ops/stretch.py against the JAX
package and OpenCV (CPU).

Bounds:
- ``read_png`` / ``read_image`` of a PNG equal ``cv2.imread(ANYDEPTH |
  ANYCOLOR)`` + ``COLOR_BGR2GRAY`` exactly (bound 0): every scanline
  filter, grey, grey + alpha, RGB and RGBA, 8 and 16 bits.  OpenCV's grey
  is fixed point, ``(9798 R + 19235 G + 3735 B + 16384) >> 15``, which
  ``to_grey`` reproduces for every 8-bit triple.
- ``apply_clahe`` against the JAX tool: CLAHE within 1 LSB on < 2% of
  pixels (the JAX package's own bound against cv2, tests/test_clahe.py;
  ROADMAP C3), the stretched image within the stretch's slope x 1 LSB + 1.
- ``rescale_brightness`` equals the JAX function on the same image.
Every test runs in its own working directory (``clahe_config.txt``).
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.cli import clahe_tool as jax_tool
from solex_ser_recon_en_tpu.ops import stretch as jax_stretch
from solex_ser_recon_en_torch.cli import clahe_tool
from solex_ser_recon_en_torch.io import png
from solex_ser_recon_en_torch.ops import stretch

from torch_parity import lsb_diff, t


@pytest.fixture(autouse=True)
def _cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def cv2_grey(path):
    img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_filtered_png(path, pix, types):
    """A PNG of ``pix`` ((h, w) or (h, w, c) uint8/uint16) whose row r uses
    filter type types[r]."""
    h, w = pix.shape[:2]
    ch = 1 if pix.ndim == 2 else pix.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    be = pix.astype(">u2" if pix.dtype == np.uint16 else "u1")
    raw = np.ascontiguousarray(be).view(np.uint8).reshape(h, -1).astype(
        np.int64)
    bpp = ch * pix.dtype.itemsize
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    preds = [0 * raw, left, up, (left + up) >> 1, _paeth(left, up, upleft)]
    rows = [np.concatenate([[k], (raw[r] - preds[k][r]) & 0xFF])
            for r, k in enumerate(types)]
    data = np.array(rows, np.uint8).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h,
                                            8 * pix.dtype.itemsize, color,
                                            0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(data, 6)))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", ["each", "mixed"])
def test_read_png_every_filter_and_colour_type_equals_cv2(
        rng, tmp_path, dtype, channels, filters):
    h, w = 23, 17
    shape = (h, w) if channels == 1 else (h, w, channels)
    pix = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    types = ([r % 5 for r in range(h)] if filters == "mixed"
             else [min(r // 5, 4) for r in range(h)])
    path = str(tmp_path / "f.png")
    write_filtered_png(path, pix, types)
    want = cv2_grey(path)
    got = png.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.read_image(path), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(40, 57), (40, 57, 3), (40, 57, 4)])
@pytest.mark.parametrize("level", [0, 3, 9])
def test_read_png_of_cv2_written_files_equals_cv2(rng, tmp_path, dtype,
                                                  shape, level):
    """OpenCV writes with libpng's adaptive filters."""
    ramp = np.linspace(0, np.iinfo(dtype).max // 2, shape[1])
    ramp = ramp.reshape((1, shape[1]) + (1,) * (len(shape) - 2))
    noise = rng.integers(0, np.iinfo(dtype).max // 2, shape)
    pix = (ramp + noise).astype(dtype)
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, pix, [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(png.read_png(path), cv2_grey(path))


def test_grey_conversion_is_cv2s_for_every_8bit_triple():
    v = np.arange(1 << 24, dtype=np.int64)
    bgr = np.stack([v & 255, (v >> 8) & 255, v >> 16], -1).astype(np.uint8)
    want = cv2.cvtColor(bgr.reshape(4096, 4096, 3), cv2.COLOR_BGR2GRAY)
    got = png.to_grey(bgr[:, ::-1].reshape(4096, 4096, 3))
    np.testing.assert_array_equal(got, want)


def test_grey_conversion_is_cv2s_on_16bit(rng):
    bgr = rng.integers(0, 65536, (512, 512, 3)).astype(np.uint16)
    np.testing.assert_array_equal(png.to_grey(bgr[..., ::-1]),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


def test_read_png_refuses_what_it_cannot_decode(tmp_path):
    p = str(tmp_path / "pal.png")
    cv2.imwrite(p, np.zeros((4, 4), np.uint8))
    data = bytearray(open(p, "rb").read())
    data[25] = 3                       # colour type: palette
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="colour type 3"):
        png.read_png(p)
    data[25] = 0
    data[28] = 1                       # Adam7 interlace
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlace 1"):
        png.read_png(p)
    data[16] ^= 1                      # corrupt IHDR
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(p)


@pytest.mark.parametrize("reader", ["cv2", "PIL", "none"])
def test_tif_goes_through_cv2_or_pil_or_raises(rng, tmp_path, monkeypatch,
                                               reader):
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    p = str(tmp_path / "x.tif")
    cv2.imwrite(p, img)
    want = cv2_grey(p)
    real = png.importlib.import_module

    def only(name):
        if name.split(".")[0] in ({"cv2", "PIL"} - {reader}):
            raise ImportError(name)
        return real(name)

    monkeypatch.setattr(png.importlib, "import_module", only)
    if reader == "none":
        with pytest.raises(ImportError, match="x.tif"):
            png.read_image(p)
        return
    np.testing.assert_array_equal(png.read_image(p), want)


def _image(rng, dtype, shape=(180, 203)):
    top = np.iinfo(dtype).max
    y, x = np.mgrid[:shape[0], :shape[1]]
    disk = ((y - 90) ** 2 + (x - 100) ** 2 < 70 ** 2) * 0.6 * top
    noise = rng.normal(0, 0.05 * top, shape)
    return np.clip(disk + 0.2 * top + noise, 0, top).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("tile", [1, 2, 3, 4])
@pytest.mark.parametrize("do_stretch", [False, True])
def test_apply_clahe_matches_the_jax_tool(rng, tmp_path, dtype, tile,
                                          do_stretch):
    img = _image(rng, dtype)
    path = str(tmp_path / "im.png")
    png.write_png_streaming(path, img)
    opts = dict(clahe_tool.DEFAULTS, tile_size=tile, do_stretch=do_stretch,
                lo=5, hi=99, sat=90)
    want = jax_tool.apply_clahe(path, opts, write_file=False)
    got = clahe_tool.apply_clahe(path, opts, device="cpu")
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "im_clahe.png")),
                                  got)
    mx, frac = lsb_diff(got, want)
    if do_stretch:
        sat = np.iinfo(dtype).max
        slope = sat * 0.9 / (np.percentile(img, 99) - np.percentile(img, 5))
        assert mx <= slope + 1, (mx, slope)
    else:
        assert mx <= 1 and frac < 0.02, (mx, frac)


def test_main_writes_config_and_refuses_hi_below_lo(rng, tmp_path, capsys):
    img = _image(rng, np.uint16, (40, 50))
    path = str(tmp_path / "a.png")
    png.write_png_streaming(path, img)
    assert clahe_tool.main([path, "--stretch", "--lo", "50", "--hi", "40",
                            "--device", "cpu"]) == 1
    assert "low percentile must be less" in capsys.readouterr().out
    assert not os.path.exists(clahe_tool.CONFIG_NAME)
    assert clahe_tool.main([path, "--tile", "3", "--device", "cpu"]) == 0
    opts = clahe_tool.read_ini()
    assert opts["tile_size"] == 3 and opts["workDir"] == str(tmp_path)
    assert os.path.exists(str(tmp_path / "a_clahe.png"))
    with open(clahe_tool.CONFIG_NAME, "w") as f:
        f.write("{not json")
    assert clahe_tool.read_ini() == jax_tool.read_ini() == clahe_tool.DEFAULTS


def test_main_needs_cuda_unless_asked_for_the_cpu(tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert clahe_tool.main([str(tmp_path / "a.png")]) == 2
    assert "CUDA is not available" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("lo,hi,alpha", [(10.0, 200.0, 0.8),
                                         (0.0, 255.0, 1.0),
                                         (123.4, 240.7, 0.37)])
def test_rescale_brightness_matches_jax(rng, dtype, lo, hi, alpha):
    img = rng.integers(0, np.iinfo(dtype).max + 1, (64, 48)).astype(dtype)
    scale = 1 if dtype == np.uint8 else 257
    args = (lo * scale, hi * scale, alpha)
    want = np.asarray(jax_stretch.rescale_brightness(img, *args))
    got = stretch.rescale_brightness(t(img), *args).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        stretch.rescale_brightness(t(img), 5.0, 5.0)


@pytest.mark.parametrize("shape", [(400, 301), (301, 400), (120, 91)])
def test_one_odd_side_follows_the_jax_package_not_cv2(rng, shape):
    """OpenCV pads both axes by ``tiles - n % tiles`` as soon as one axis
    does not divide (a whole extra tile's worth on the axis that does);
    the JAX package and the port pad only the axis that needs it (ROADMAP
    C13).  The port agrees with the JAX package; cv2 equals itself on its
    own extension."""
    from solex_ser_recon_en_tpu.ops.clahe import clahe as jax_clahe
    from solex_ser_recon_en_torch.ops.clahe import clahe

    h, w = shape
    img = (rng.random(shape) * 3000
           + np.linspace(0, 30000, w)[None, :]).astype(np.uint16)
    got = clahe(t(img), 0.8, (2, 2)).numpy()
    mx, frac = lsb_diff(got, np.asarray(jax_clahe(img, 0.8, (2, 2))))
    assert mx <= 1 and frac < 0.01
    cl = cv2.createCLAHE(clipLimit=0.8, tileGridSize=(2, 2))
    ext = cv2.copyMakeBorder(img, 0, 2 - h % 2, 0, 2 - w % 2,
                             cv2.BORDER_REFLECT_101)
    np.testing.assert_array_equal(cl.apply(ext)[:h, :w], cl.apply(img))
    assert lsb_diff(got, cl.apply(img))[0] > 10
