"""Grayscale PNG decode without OpenCV or PIL.

The products are written by the JAX package's stdlib encoder
(solex_ser_recon_en_tpu/io/png.py:write_png_streaming, jax-free), which
stores filter type 0 scanlines; ``read_png`` decodes such files, so the
checks of the products need neither OpenCV nor PIL either.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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
