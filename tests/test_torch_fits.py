"""The port's FITS writer and reader (io/fits.py) against the JAX package's:
the same array and header give the same bytes, on the native payload route
(``write_fits``, uint16 through ``fits_pack_u16``) and on the numpy route
(``write_fits_plain``); tolerance: none, bytes are compared."""

import numpy as np
import pytest

from solex_ser_recon_en_tpu.io import fits as jax_fits
from solex_ser_recon_en_torch.io import fits, native

DTYPES = ["uint16", "int16", "int32", "uint32", "uint8", "float32", "float64",
          "bool", "int64"]


def _array(dtype, shape, seed=3):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype.startswith("float"):
        return rng.normal(3e4, 4e4, shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, shape,
                        dtype=np.int64 if dtype != "uint32" else np.uint64
                        ).astype(dtype)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("with_header", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_write_fits_bytes_equal_on_both_routes(tmp_path, dtype, with_header):
    data = _array(dtype, (37, 53))
    hdr = fits.make_header(53, 37) if with_header else None
    if with_header:
        assert hdr == jax_fits.make_header(53, 37)
        hdr["OBSERVER"] = "it's me"
        hdr["GAIN"] = 1.5
        hdr["FLAG"] = True
    paths = [str(tmp_path / n) for n in ("port.fits", "plain.fits", "jax.fits")]
    fits.write_fits(paths[0], data, hdr)
    fits.write_fits_plain(paths[1], data, hdr)
    jax_fits.write_fits(paths[2], data, hdr)
    assert _bytes(paths[0]) == _bytes(paths[1]) == _bytes(paths[2])
    assert len(_bytes(paths[0])) % fits.BLOCK == 0
    ours, h1 = fits.read_fits(paths[0])
    ref, h2 = jax_fits.read_fits(paths[2])
    assert h1 == h2
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    if dtype in ("uint16", "int32", "float64", "uint8"):
        np.testing.assert_array_equal(ours, data)
        assert ours.dtype == data.dtype


@pytest.mark.parametrize("shape", [(1, 1), (5, 1440), (3, 4, 5), (7,)])
def test_write_fits_u16_shapes_and_views(tmp_path, shape):
    """Padding to the 2880-byte block at every payload size, and a
    non-contiguous input (a slice of a stack, a flipped view)."""
    data = _array("uint16", shape)
    views = [data, data[..., ::-1]]
    if data.ndim == 3:
        views.append(data[1])
    for k, v in enumerate(views):
        a, b = str(tmp_path / f"a{k}.fits"), str(tmp_path / f"b{k}.fits")
        fits.write_fits(a, v, {"NAXIS1": 99})
        jax_fits.write_fits(b, v, {"NAXIS1": 99})
        assert _bytes(a) == _bytes(b)
        back, hdr = fits.read_fits(a)
        np.testing.assert_array_equal(back, v)
        assert hdr["NAXIS1"] == v.shape[-1] and hdr["BZERO"] == 32768


def test_write_fits_u16_goes_through_the_native_library(tmp_path, monkeypatch):
    """uint16 data is packed by ``fits_pack_u16`` (counted), other dtypes
    and the plain writer are not; a library that cannot be built raises,
    numpy never stands in."""
    data = _array("uint16", (9, 11))
    before = native.CALLS["fits_pack_u16"]
    fits.write_fits(str(tmp_path / "a.fits"), data)
    assert native.CALLS["fits_pack_u16"] == before + 1
    fits.write_fits(str(tmp_path / "b.fits"), data.astype(np.int32))
    fits.write_fits_plain(str(tmp_path / "c.fits"), data)
    assert native.CALLS["fits_pack_u16"] == before + 1
    np.testing.assert_array_equal(
        native.fits_pack_u16(data).view(np.uint8),
        (data.astype(np.int32) - 32768).astype(">i2").ravel().view(np.uint8))
    with pytest.raises(TypeError, match="uint16"):
        native.fits_pack_u16(data.astype(np.int16))

    def no_lib():
        raise RuntimeError("C++ compiler 'g++' cannot be run")

    monkeypatch.setattr(native, "get_lib", no_lib)
    with pytest.raises(RuntimeError, match="cannot be run"):
        fits.write_fits(str(tmp_path / "d.fits"), data)
    assert not (tmp_path / "d.fits").exists()
    fits.write_fits_plain(str(tmp_path / "d.fits"), data)


def test_read_fits_across_packages(tmp_path):
    """Each package reads the other's file; a file with no END card is
    refused by both."""
    data = _array("uint16", (12, 20))
    a, b = str(tmp_path / "a.fits"), str(tmp_path / "b.fits")
    fits.write_fits(a, data, fits.make_header(20, 12))
    jax_fits.write_fits(b, data, jax_fits.make_header(20, 12))
    for path in (a, b):
        for mod in (fits, jax_fits):
            back, hdr = mod.read_fits(path)
            np.testing.assert_array_equal(back, data)
            assert (hdr["BIN1"], hdr["BIN2"], hdr["EXPTIME"]) == (1, 1, 0)
    bad = str(tmp_path / "bad.fits")
    with open(bad, "wb") as f:
        f.write(b"SIMPLE  =                    T".ljust(2880))
    for mod in (fits, jax_fits):
        with pytest.raises(ValueError, match="END"):
            mod.read_fits(bad)
