"""Minimal FITS image reader/writer (astropy is not required).

The port's own copy of solex_ser_recon_en_tpu/io/fits.py (``make_header``,
``write_fits``, ``read_fits``; the same bytes for the same array and header).
Where the original tries the native payload pack and quietly falls back to
numpy, ``write_fits`` here always packs uint16 data natively and
``write_fits_plain`` is the numpy route beside it.

The reference writes its five intermediate/final products as single-HDU FITS
files via astropy (`_mean`, `_raw`, `_circular`, `_detransversaliumed`,
`_clahe`; reference: solex_util.py:147-161,204-206,584-587 and
Solex_recon.py:80-82,137-139,150-152).  We emit standards-compliant FITS with
the same semantics: uint16 data is stored as BITPIX=16 with BZERO=32768
(exactly what astropy does with unsigned data), headers carry the same extra
cards as the reference's ``make_header`` (solex_util.py:147-161).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

BLOCK = 2880


def make_header(iw: int, ih: int) -> Dict[str, object]:
    """Header cards equivalent to reference make_header (solex_util.py:147-161).

    BITPIX/NAXIS* are recomputed at write time from the data (as astropy
    does); the informational cards are preserved verbatim.
    """
    return {
        "NAXIS1": int(iw),
        "NAXIS2": int(ih),
        "BIN1": 1,
        "BIN2": 1,
        "EXPTIME": 0,
    }


def _card(key: str, value, comment: str = "") -> bytes:
    key_f = f"{key:<8}"[:8]
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key_f}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key_f}= {int(value):>20}"
    elif isinstance(value, (float, np.floating)):
        body = f"{key_f}= {float(value):>20G}"
    else:
        s = str(value).replace("'", "''")
        body = f"{key_f}= '{s:<8}'"
    if comment:
        body += f" / {comment}"
    return body[:80].ljust(80).encode("ascii")


_DTYPE_TO_BITPIX = {
    np.dtype(np.uint8): (8, 0),
    np.dtype(np.int16): (16, 0),
    np.dtype(np.uint16): (16, 32768),
    np.dtype(np.int32): (32, 0),
    np.dtype(np.uint32): (32, 2147483648),
    np.dtype(np.int64): (64, 0),
    np.dtype(np.float32): (-32, 0),
    np.dtype(np.float64): (-64, 0),
}


def _header_and_layout(data: np.ndarray, header):
    """(data as a writable dtype, header block bytes, bitpix, bzero)."""
    data = np.asarray(data)
    if data.dtype not in _DTYPE_TO_BITPIX:
        data = data.astype(np.float32)
    bitpix, bzero = _DTYPE_TO_BITPIX[data.dtype]

    cards = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", bitpix, "array data type"),
        _card("NAXIS", data.ndim, "number of array dimensions"),
    ]
    for i, n in enumerate(reversed(data.shape)):
        cards.append(_card(f"NAXIS{i+1}", n))
    if bzero:
        cards.append(_card("BZERO", bzero))
        cards.append(_card("BSCALE", 1))
    skip = {"SIMPLE", "BITPIX", "NAXIS", "BZERO", "BSCALE"} | {
        f"NAXIS{i+1}" for i in range(data.ndim)
    }
    for k, v in (header or {}).items():
        if k.upper() not in skip:
            cards.append(_card(k.upper(), v))
    cards.append(b"END" + b" " * 77)
    hdr = b"".join(cards)
    hdr += b" " * (-len(hdr) % BLOCK)
    return data, hdr, bitpix, bzero


def _payload_plain(data: np.ndarray, bitpix: int, bzero: int) -> np.ndarray:
    """Big-endian payload in numpy: the offset, then one byte swap."""
    if bzero:
        signed = {16: np.int16, 32: np.int32}[bitpix]
        if data.dtype == np.uint16:
            # exact single-pass offset: (x - 32768) mod 2^16 viewed as
            # int16 equals x - 32768 for every uint16 x (two's complement)
            raw = (data - np.uint16(32768)).view(np.int16)
        elif data.dtype == np.uint32:
            raw = (data - np.uint32(2147483648)).view(np.int32)
        else:
            raw = (data.astype(np.int64) - bzero).astype(signed)
    else:
        raw = data
    raw = np.ascontiguousarray(raw)
    if raw.dtype != raw.dtype.newbyteorder(">"):
        raw = raw.byteswap()  # one pass; the write below takes the buffer
    return raw


def _write(path: str, hdr: bytes, raw: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(raw)  # buffer protocol: no tobytes copy
        f.write(b"\0" * (-raw.nbytes % BLOCK))


def write_fits(path: str, data: np.ndarray, header: Dict[str, object] | None = None) -> None:
    """Write a single-HDU FITS image.  uint16 data takes the native
    library's one-pass payload (io/native.py:fits_pack_u16; a library that
    cannot be built raises), every other dtype the numpy payload."""
    data, hdr, bitpix, bzero = _header_and_layout(data, header)
    if data.dtype == np.uint16:
        from .native import fits_pack_u16

        _write(path, hdr, fits_pack_u16(data))
    else:
        _write(path, hdr, _payload_plain(data, bitpix, bzero))


def write_fits_plain(path: str, data: np.ndarray, header: Dict[str, object] | None = None) -> None:
    """The plain (numpy only) version of ``write_fits``: the same bytes."""
    data, hdr, bitpix, bzero = _header_and_layout(data, header)
    _write(path, hdr, _payload_plain(data, bitpix, bzero))


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("'"):
        return raw.strip("'").strip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        return int(raw)
    except ValueError:
        return float(raw)


def read_fits(path: str) -> Tuple[np.ndarray, Dict[str, object]]:
    """Read a simple single-HDU FITS image."""
    with open(path, "rb") as f:
        raw = f.read()
    header: Dict[str, object] = {}
    pos = 0
    while True:
        block = raw[pos : pos + BLOCK]
        pos += BLOCK
        done = False
        for i in range(0, BLOCK, 80):
            card = block[i : i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" in card[8:10]:
                val = card[10:].split(" / ")[0]
                header[key] = _parse_value(val)
        if done:
            break
        if pos >= len(raw):
            raise ValueError("no END card found")
    bitpix = int(header["BITPIX"])
    naxis = int(header["NAXIS"])
    shape = tuple(int(header[f"NAXIS{i+1}"]) for i in range(naxis))[::-1]
    dt = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}[bitpix]
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=dt, count=count, offset=pos).reshape(shape)
    bzero = header.get("BZERO", 0)
    bscale = header.get("BSCALE", 1)
    if bzero == 32768 and bitpix == 16:
        data = (data.astype(np.int32) + 32768).astype(np.uint16)
    elif bzero == 2147483648 and bitpix == 32:
        data = (data.astype(np.int64) + 2147483648).astype(np.uint32)
    elif bzero != 0 or bscale != 1:
        # int64 accumulate: a python-int bzero beyond the payload dtype's
        # range would otherwise overflow the scalar promotion (NEP 50)
        data = data.astype(np.int64) * bscale + bzero
    else:
        data = data.astype(data.dtype.newbyteorder("="))
    return data, header
