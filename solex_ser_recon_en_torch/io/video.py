"""Unified video access for SER and AVI scans.

The port's own copy of solex_ser_recon_en_tpu/io/video.py (numpy only,
OpenCV on demand).  reference: video_reader.py:10-126.

An uncompressed 8-bit grey-scale AVI (FOURCC Y800/GREY) is indexed once
(``_parse_raw_gray_avi``, OpenDML ``RIFF AVIX`` segments and truncated
captures included) and its planes are read straight off a memmap; the
device feed (io/feeder.py) copies those u8 planes into its pinned ring
as it copies an 8-bit SER's frames.  Any other AVI is decoded by OpenCV,
as the reference does (video_reader.py:68-80, 111-113).  Where cv2
cannot be imported (the GPU machine has none), opening such an AVI raises
an error that names cv2; there is no other decoder to fall back to.
"""

from __future__ import annotations

import importlib
import os
from typing import Iterator, Tuple

import numpy as np

from .ser import SerReader


def _import_cv2(path: str):
    """OpenCV, or an error naming cv2 for the compressed AVI ``path``."""
    try:
        return importlib.import_module("cv2")
    except ImportError as e:
        raise RuntimeError(
            f"{path}: not an uncompressed 8-bit grey-scale AVI (Y800/GREY); "
            f"decoding it needs OpenCV (cv2), which cannot be imported ({e})"
        ) from e


class VideoReader:
    """Common interface: .ih/.iw/.frame_count/.read()/.chunks()."""

    ih: int
    iw: int
    frame_count: int
    Width: int
    Height: int
    pixel_depth: int

    def read(self, start: int = 0, count: int | None = None) -> np.ndarray:
        raise NotImplementedError

    def read_all(self) -> np.ndarray:
        return self.read(0, self.frame_count)

    def chunks(self, chunk: int) -> Iterator[Tuple[int, np.ndarray]]:
        for start in range(0, self.frame_count, chunk):
            n = min(chunk, self.frame_count - start)
            yield start, self.read(start, n)


class _SerVideo(VideoReader):
    def __init__(self, path: str):
        self._r = SerReader(path)
        self.ih, self.iw = self._r.ih, self._r.iw
        self.frame_count = self._r.frame_count
        self.Width, self.Height = self._r.Width, self._r.Height
        self.pixel_depth = self._r.pixel_depth

    def read(self, start: int = 0, count: int | None = None) -> np.ndarray:
        return self._r.read(start, count)


def _parse_raw_gray_avi(path: str):
    """Index an uncompressed 8-bit grayscale AVI (FOURCC Y800/GREY).

    Returns ``(width, height, [frame_offsets])`` when every video chunk in
    the 'movi' list is a raw width*height grayscale plane, else ``None``
    (caller falls back to OpenCV).  Planewise-capture AVIs are exactly what
    the reference's sources produce; for them cv2's decode is a pure
    Y→BGR→Y round-trip (value-exact: the fixed-point BGR2GRAY weights sum
    to 1.0), so reading the planes straight off the container is
    bit-identical and skips the per-frame decoder entirely.
    """
    import struct

    try:
        fsize = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
                return None
            w = h = None
            offsets = []
            ok_fmt = False
            truncated = False

            def walk(end: int) -> bool:
                nonlocal w, h, ok_fmt, truncated
                while f.tell() + 8 <= end:
                    hdr = f.read(8)
                    if len(hdr) < 8:
                        return False
                    fourcc = hdr[:4]
                    size = struct.unpack("<I", hdr[4:])[0]
                    nxt = f.tell() + size + (size & 1)
                    if fourcc in (b"LIST", b"RIFF"):
                        ltype = f.read(4)
                        if ltype == b"movi" and not ok_fmt:
                            return False  # format must precede frames
                        if not walk(f.tell() - 4 + size):
                            return False
                    elif fourcc == b"strf" and w is None and size >= 40:
                        bmi = f.read(40)
                        if len(bmi) < 40:
                            return False
                        w, h = struct.unpack("<ii", bmi[4:12])
                        bitcount = struct.unpack("<H", bmi[14:16])[0]
                        comp = bmi[16:20]
                        # top-down unpadded planes only; BI_RGB DIBs are
                        # bottom-up + 4-byte row padding -> cv2 fallback
                        ok_fmt = (bitcount == 8 and h > 0 and w > 0
                                  and comp in (b"Y800", b"y800", b"GREY"))
                        if not ok_fmt:
                            return False
                    elif fourcc[2:4] in (b"db", b"dc") and fourcc[:2] == b"00":
                        if not ok_fmt or size != w * h:
                            return False  # a compressed/odd chunk: bail out
                        if f.tell() + size > fsize:
                            # interrupted capture: the header landed but the
                            # plane was cut short.  Keep the complete frames
                            # (cv2 decodes exactly those) and stop indexing.
                            truncated = True
                            return True
                        offsets.append(f.tell())
                    f.seek(nxt)
                    if truncated:
                        return True
                return True

            # OpenDML: captures >1 GB continue in 'RIFF AVIX' segments after
            # the first 'RIFF AVI ' segment — walk every segment, or the
            # index silently covers only the first gigabyte of frames
            seg_start = 0
            seg_end = min(seg_start + 8 + struct.unpack("<I", head[4:8])[0],
                          fsize)
            while True:
                f.seek(seg_start + 12)
                if not walk(seg_end):
                    return None
                if truncated or seg_end + 12 > fsize:
                    break
                f.seek(seg_end + (seg_end & 1))
                nxt_head = f.read(12)
                if len(nxt_head) < 12 or nxt_head[:4] != b"RIFF" or \
                        nxt_head[8:12] != b"AVIX":
                    break
                seg_start = f.tell() - 12
                seg_end = min(
                    seg_start + 8 + struct.unpack("<I", nxt_head[4:8])[0],
                    fsize)
            if not (ok_fmt and offsets):
                return None
            return w, h, offsets
    except (OSError, struct.error):
        return None


class _AviVideo(VideoReader):
    """AVI frames, grayscale and forced to 8-bit depth (upscaled x256 to
    uint16), matching video_reader.py:68-80,111-122.

    Uncompressed grayscale containers (Y800/GREY) are indexed once and the
    planes are sliced straight off a memmap — bit-identical to cv2's decode
    (see _parse_raw_gray_avi) at memory-copy speed.  Anything else decodes
    through OpenCV's demuxer exactly as the reference does."""

    def __init__(self, path: str):
        self._path = path
        self._cv2 = None
        self._cap = None
        raw = _parse_raw_gray_avi(path)
        if raw is not None:
            w, h, offsets = raw
            self._raw = np.asarray(offsets, dtype=np.int64)
            self._mm = np.memmap(path, dtype=np.uint8, mode="r")
            # planewise writers space the '00dc' chunks uniformly; a single
            # strided view then replaces the per-frame slice loop
            d = np.diff(self._raw)
            self._stride = int(d[0]) if len(d) and (d == d[0]).all() else None
            self.Width, self.Height = w, h
            self.frame_count = len(offsets)
        else:
            self._raw = None
            self._mm = None
            cap = self._open_cv2(path)
            cv2 = self._cv2
            self.Width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.Height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.pixel_depth = 8
        self._rotate = self.Width > self.Height
        self.ih = max(self.Width, self.Height)
        self.iw = min(self.Width, self.Height)
        self._pos = 0

    def _open_cv2(self, path: str):
        cv2 = _import_cv2(path)
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open AVI file {path}")
        return self._cap

    def read(self, start: int = 0, count: int | None = None) -> np.ndarray:
        if count is None:
            count = self.frame_count - start
        if self._raw is not None:
            return self._read_raw(start, count)
        return self._read_cv2(start, count)

    def _read_raw(self, start: int, count: int) -> np.ndarray:
        count = max(0, min(count, self.frame_count - start))
        h, w = self.Height, self.Width
        out = np.empty((count, self.ih, self.iw), dtype=np.uint16)
        mm = self._mm
        if self._stride is not None and count:
            base = int(self._raw[start])
            src = np.lib.stride_tricks.as_strided(
                mm[base:], shape=(count, h, w), strides=(self._stride, w, 1))
            if self._rotate:
                src = np.rot90(src, axes=(1, 2))
            np.multiply(src, np.uint16(256), out=out, casting="unsafe")
            return out
        for i, off in enumerate(self._raw[start:start + count]):
            img = mm[off:off + h * w].reshape(h, w)
            if self._rotate:
                img = np.rot90(img)
            np.multiply(img, np.uint16(256), out=out[i], casting="unsafe")
        return out

    def _read_cv2(self, start: int, count: int) -> np.ndarray:
        cv2 = self._cv2
        if start != self._pos:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, start)
            self._pos = start
        out = np.empty((count, self.ih, self.iw), dtype=np.uint16)
        for i in range(count):
            ok, img = self._cap.read()
            if not ok:
                out = out[:i]
                break
            if img.ndim == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            if self._rotate:
                img = np.rot90(img)
            out[i] = img.astype(np.uint16) << 8
        self._pos = start + out.shape[0]
        return out


def open_video(path: str) -> VideoReader:
    """Open a SER or AVI scan (reference: video_reader.py:18-26)."""
    upper = path.upper()
    if upper.endswith(".SER"):
        return _SerVideo(path)
    if upper.endswith(".AVI"):
        return _AviVideo(path)
    raise ValueError(f"input file {path} is neither SER nor AVI")
