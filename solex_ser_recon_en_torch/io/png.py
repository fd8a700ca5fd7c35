"""Grayscale PNG encode and decode.

Counterpart of the streaming encoder of solex_ser_recon_en_tpu/io/png.py
at compression 0 (without its OpenCV, PIL and zlib-compressed branches):
8/16-bit grayscale, filter type 0 scanlines, zlib level 0 in stored
blocks, as the reference's ``cv2.imwrite`` compression-0 products
(solex_util.py:556-566).  The image is cut into 8 row bands, each its own
IDAT chunk.

- ``write_png_bands`` takes the bands one by one (pipeline/products.py
  hands them over as they come down from the card) and frames each with
  the native library's ``png_encode_stored_band`` (io/native.py): scanline
  pack, stored blocks, adler32 and chunk CRC in one pass.
- ``write_png_streaming`` is the same for an image on the host.
- ``write_png_streaming_plain`` is the plain version: the same bytes from
  numpy, ``struct`` and ``zlib`` alone.

The bytes of all three equal the JAX package's.  ``read_png`` decodes such
files, so the checks of the products need neither OpenCV nor PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .native import png_encode_band

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: row bands of the image, each framed as its own run of stored blocks (the
#: JAX encoder's default, which fixes the byte layout of the file)
_BANDS = 8


def _png_chunk(f, tag: bytes, parts) -> None:
    """One PNG chunk assembled from buffer pieces (length prefix and CRC
    computed over the pieces, no joining copy)."""
    f.write(struct.pack(">I", sum(len(p) for p in parts)))
    f.write(tag)
    crc = zlib.crc32(tag)
    for p in parts:
        f.write(p)
        crc = zlib.crc32(p, crc)
    f.write(struct.pack(">I", crc & 0xFFFFFFFF))


def _stored_parts(payload: bytes, first: bool, final: bool, adler: int):
    """zlib stored-block framing of one band's scanlines: blocks of at most
    65535 bytes, the stream header on the first band, BFINAL on the image's
    last block and the adler32 trailer after it."""
    mv = memoryview(payload)
    n = len(mv)
    parts = [b"\x78\x01"] if first else []
    pos = 0
    while True:
        blk = min(65535, n - pos)
        last = final and pos + blk == n
        parts.append(struct.pack("<BHH", 1 if last else 0, blk, blk ^ 0xFFFF))
        parts.append(mv[pos:pos + blk])
        pos += blk
        if pos >= n:
            break
    if final:
        parts.append(struct.pack(">I", adler & 0xFFFFFFFF))
    return parts


def band_bounds(h: int) -> list:
    """(first row, end row) of each row band of an image of ``h`` rows."""
    nb = max(1, min(_BANDS, h))
    return [(h * k // nb, h * (k + 1) // nb) for k in range(nb)]


def _as_png_image(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        img = np.clip(img, 0, 65535).astype(np.uint16)
    return img


def write_png_bands(path: str, shape, dtype, bands) -> None:
    """Write an (h, w) uint8 or uint16 image whose row bands (host arrays,
    cut at ``band_bounds(h)``) come from the iterable ``bands`` in order;
    each band is encoded as soon as the iterable yields it."""
    h, w = shape
    dtype = np.dtype(dtype)
    if dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG bands must be uint8 or uint16, not {dtype}")
    bounds = band_bounds(h)
    adler, k = 1, 0
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        _png_chunk(f, b"IHDR", [struct.pack(">IIBBBBB", w, h,
                                            8 * dtype.itemsize, 0, 0, 0, 0)])
        for k, rows in enumerate(bands, 1):
            if k > len(bounds) or rows.dtype != dtype or rows.shape != (
                    bounds[k - 1][1] - bounds[k - 1][0], w):
                raise ValueError(f"band {k} of {path} is not the "
                                 f"{dtype} rows {bounds[k - 1:k]} x {w}")
            body, adler, crc = png_encode_band(
                rows, k == 1, k == len(bounds), adler, zlib.crc32(b"IDAT"))
            f.write(struct.pack(">I", len(body)))
            f.write(b"IDAT")
            f.write(body)
            f.write(struct.pack(">I", crc))
        if k != len(bounds):
            raise ValueError(f"{path}: {k} bands came, not {len(bounds)}")
        _png_chunk(f, b"IEND", [b""])


def write_png_streaming(path: str, img: np.ndarray) -> None:
    """Write a host (h, w) image as an 8-bit (uint8) or 16-bit grayscale PNG
    (other dtypes are clipped to [0, 65535] and stored as uint16)."""
    img = _as_png_image(img)
    write_png_bands(path, img.shape, img.dtype,
                    (img[a:b] for a, b in band_bounds(img.shape[0])))


def write_png_streaming_plain(path: str, img: np.ndarray) -> None:
    """The plain version of ``write_png_streaming``: the same file from
    numpy and the standard library."""
    img = _as_png_image(img)
    depth, be = (8, "|u1") if img.dtype == np.uint8 else (16, ">u2")
    h, w = img.shape
    nb = len(band_bounds(h))
    adler = 1
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        _png_chunk(f, b"IHDR",
                   [struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)])
        for k, (a, b) in enumerate(band_bounds(h)):
            rows = img[a:b]
            line = np.ascontiguousarray(rows).astype(be, copy=False)
            raw = np.zeros((rows.shape[0], 1 + w * line.itemsize), np.uint8)
            raw[:, 1:] = line.view(np.uint8).reshape(rows.shape[0], -1)
            payload = raw.tobytes()
            adler = zlib.adler32(payload, adler)
            _png_chunk(f, b"IDAT", _stored_parts(payload, k == 0,
                                                  k == nb - 1, adler))
        _png_chunk(f, b"IEND", [b""])


def read_png(path: str) -> np.ndarray:
    """Decode a grayscale PNG whose scanlines all use filter type 0."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = len(_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    w, h, depth, color = hdr[0], hdr[1], hdr[2], hdr[3]
    if color != 0 or depth not in (8, 16):
        raise ValueError(f"{path}: only 8/16-bit grayscale PNGs are read")
    dt = np.dtype(">u2") if depth == 16 else np.dtype("u1")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * dt.itemsize)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines are not supported")
    return raw[:, 1:].copy().view(dt).reshape(h, w).astype(dt.newbyteorder("="))
