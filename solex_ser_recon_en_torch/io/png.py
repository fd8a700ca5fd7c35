"""PNG encode and decode.

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

The bytes of all three equal the JAX package's.  ``read_png`` decodes
these files and any other 8/16-bit grey or RGB(A) PNG (every scanline
filter), so neither the product checks nor ``read_image`` (the CLAHE
tool's reader) need OpenCV or PIL for a PNG.
"""

from __future__ import annotations

import importlib
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


#: PNG colour type -> samples a pixel: grey, RGB, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters (types 0-4) of ``raw`` (h, 1 + stride)
    -> (h, stride) uint8.

    Filter types Average (3) and Paeth (4) make each pixel depend on the
    reconstructed pixel to its left and the two above it, so the pixels
    are reconstructed along anti-diagonals, each row applying its own
    filter: the image is sheared so that diagonal d is row d of ``rec``
    (pixel (r, x) at rec[r + x + 2, r + 1]; column 0 and the unset cells
    are the zeros the filters see beyond the image's edges), and one numpy
    step of contiguous slices does a diagonal, h + w steps in all."""
    types = raw[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(types.max())} is not 0-4")
    filt = raw[:, 1:]
    if not types.any():
        return filt.copy()
    w = stride // bpp
    rows = np.arange(h)[:, None]
    diag = rows + np.arange(w)[None, :]
    sheared = np.zeros((h + w, h, bpp), np.int16)
    sheared[diag, rows] = filt.reshape(h, w, bpp)
    rec = np.zeros((h + w + 2, h + 1, bpp), np.int16)
    kind = [(types == k)[:, None].astype(np.int16) for k in range(5)]
    paeth_rows = np.concatenate([[0], np.cumsum(types == 4)])
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)    # rows on diagonal d
        a = rec[d + 1, lo + 1:hi + 1]                # left
        b = rec[d + 1, lo:hi]                        # above
        pred = kind[1][lo:hi] * a + kind[2][lo:hi] * b
        pred += kind[3][lo:hi] * ((a + b) >> 1)
        if paeth_rows[hi] > paeth_rows[lo]:
            c = rec[d, lo:hi]                        # above left
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            best = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
            pred += kind[4][lo:hi] * best
        rec[d + 2, lo + 1:hi + 1] = (sheared[d, lo:hi] + pred) & 0xFF
    out = rec[diag + 2, rows + 1]
    return out.astype(np.uint8).reshape(h, stride)


def to_grey(pix: np.ndarray) -> np.ndarray:
    """(h, w, 3) R, G, B samples (uint8 or uint16) -> grey of the same
    dtype, as OpenCV's ``COLOR_BGR2GRAY`` of the image it reads: fixed
    point with 15-bit coefficients, rounded half up."""
    r, g, b = (pix[..., k].astype(np.int64) for k in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).astype(pix.dtype)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to a grey uint8/uint16 image, as ``cv2.imread(path,
    IMREAD_ANYDEPTH | IMREAD_ANYCOLOR)`` then ``COLOR_BGR2GRAY`` gives it:
    8 or 16 bits, colour types grey, grey + alpha, RGB and RGBA (the
    alpha dropped), every scanline filter, no interlace."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = len(_SIGNATURE), [], None
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if tag in (b"IHDR", b"IDAT") and zlib.crc32(tag + body) != crc:
            raise ValueError(f"{path}: {tag.decode()} chunk CRC mismatch")
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: colour type {color}, {depth} bits, "
                         f"interlace {interlace}; only 8/16-bit grey, grey + "
                         "alpha, RGB and RGBA without interlace are read")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of scanlines, not "
                         f"{h * (1 + w * bpp)}")
    rows = _unfilter(raw.reshape(h, 1 + w * bpp), h, w * bpp, bpp)
    dt = np.dtype(">u2") if depth == 16 else np.dtype("u1")
    pix = rows.view(dt).reshape(h, w, ch).astype(dt.newbyteorder("="))
    if ch >= 3:
        return to_grey(pix[..., :3])
    return np.ascontiguousarray(pix[..., 0])


def read_image(path: str) -> np.ndarray:
    """Read a PNG or TIF image preserving its bit depth, converted to grey.

    Counterpart of solex_ser_recon_en_tpu/io/png.py:read_image (reference:
    clahe_apply.py:244-246, ``imread`` ANYDEPTH + BGR2GRAY).  A PNG always
    goes through ``read_png``, so every machine reads the same values.
    Anything else needs OpenCV or PIL, loaded by name where one imports;
    without either it raises an ImportError naming the file.  PIL's colour
    images go through ``to_grey`` (OpenCV's conversion)."""
    with open(path, "rb") as f:
        if f.read(len(_SIGNATURE)) == _SIGNATURE:
            return read_png(path)
    try:
        cv2 = importlib.import_module("cv2")
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
        if img is None:
            raise IOError(f"cannot read image {path}")
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return img
    try:
        image = importlib.import_module("PIL.Image")
    except ImportError:
        raise ImportError(f"{path}: only PNG is read without OpenCV or PIL, "
                          "and neither cv2 nor PIL imports here") from None
    img = np.asarray(image.open(path))
    return to_grey(img[..., :3]) if img.ndim == 3 else img
