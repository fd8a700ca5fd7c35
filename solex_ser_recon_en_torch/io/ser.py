"""SER video container demuxer and muxer.

The port's own copy of solex_ser_recon_en_tpu/io/ser.py (numpy only).

The SER format (Lucam recorder) has a fixed 178-byte header followed by raw
frames; the fields the pipeline needs sit at fixed little-endian offsets:

    offset  0  FileID        14 bytes (ASCII "LUCAM-RECORDER")
    offset 14  LuID          u32
    offset 18  ColorID       u32   (0 = MONO)
    offset 22  littleEndian  u32
    offset 26  Width         u32
    offset 30  Height        u32
    offset 34  PixelDepthPerPlane u32 (8 or 16)
    offset 38  FrameCount    u32
    offset 42  Observer      40 bytes
    offset 82  Instrument    40 bytes
    offset 122 Telescope     40 bytes
    offset 162 DateTime      i64
    offset 170 DateTimeUTC   i64
    offset 178 frame data    Width*Height*(depth//8) bytes per frame

reference: video_reader.py:31-66 (header parse), :94-109 (buffered reads),
:84-91,119-122 (frame normalisation: rotate so the wavelength axis is X,
upscale 8-bit to 16-bit by x256).

TPU-first design difference: instead of the reference's 25-frame Python
read-ahead buffer we memory-map the file and hand out large zero-copy frame
slabs, which the pipeline ships to device HBM in chunks (overlapped with
device compute by the orchestrator).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

HEADER_SIZE = 178
_HEADER_STRUCT = struct.Struct("<14s7I40s40s40sqq")  # through DateTimeUTC


@dataclass
class SerHeader:
    file_id: bytes
    lu_id: int
    color_id: int
    little_endian: int
    width: int
    height: int
    pixel_depth: int
    frame_count: int
    observer: bytes = b"\0" * 40
    instrument: bytes = b"\0" * 40
    telescope: bytes = b"\0" * 40
    date_time: int = 0
    date_time_utc: int = 0

    @property
    def dtype(self) -> np.dtype:
        return np.dtype("uint8" if self.pixel_depth == 8 else "<u2")

    @property
    def frame_bytes(self) -> int:
        return self.width * self.height * (1 if self.pixel_depth == 8 else 2)

    def pack(self) -> bytes:
        return _HEADER_STRUCT.pack(
            self.file_id,
            self.lu_id,
            self.color_id,
            self.little_endian,
            self.width,
            self.height,
            self.pixel_depth,
            self.frame_count,
            self.observer,
            self.instrument,
            self.telescope,
            self.date_time,
            self.date_time_utc,
        )

    @classmethod
    def parse(cls, raw: bytes) -> "SerHeader":
        if len(raw) < HEADER_SIZE:
            raise ValueError("SER file too short for 178-byte header")
        fields = _HEADER_STRUCT.unpack(raw[:HEADER_SIZE])
        hdr = cls(*fields)
        if hdr.pixel_depth not in (8, 16):
            raise ValueError(f"unsupported SER PixelDepthPerPlane {hdr.pixel_depth}")
        if hdr.width == 0 or hdr.height == 0:
            raise ValueError("SER header has zero dimensions")
        return hdr


class SerReader:
    """Zero-copy SER reader.

    Frames are exposed both raw (`raw_frames`, on-disk layout) and normalised
    (`read`, matching the reference: rotated so the spectral axis is X and
    upscaled to uint16).  The normalised spatial size is (ih, iw) where
    ih >= iw (reference: video_reader.py:84-91).
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.header = SerHeader.parse(f.read(HEADER_SIZE))
        h = self.header
        # Clamp FrameCount to what the file actually holds (robustness:
        # truncated captures are common; the reference would read garbage).
        payload = os.path.getsize(path) - HEADER_SIZE
        self.frame_count = int(min(h.frame_count, payload // h.frame_bytes))
        if self.frame_count <= 0:
            # a corrupt header (absurd dims swallow the payload) or an
            # empty capture; failing here lets the per-file precheck skip
            # it cleanly (reference: SHG_MAIN.py:104-129 semantics) instead
            # of a divide-by-zero deep in the pipeline
            raise ValueError(
                f"SER file holds no complete frame "
                f"({h.width}x{h.height}x{h.pixel_depth}bit, "
                f"payload {max(payload, 0)} bytes)"
            )
        self.flag_rotate = h.width > h.height
        self.ih = int(max(h.width, h.height))
        self.iw = int(min(h.width, h.height))
        self._mm = np.memmap(
            path,
            dtype=self.header.dtype,
            mode="r",
            offset=HEADER_SIZE,
            shape=(self.frame_count, h.height, h.width),
        )

    # -- raw access ----------------------------------------------------
    @property
    def Width(self) -> int:  # noqa: N802 (reference field name)
        return int(self.header.width)

    @property
    def Height(self) -> int:  # noqa: N802
        return int(self.header.height)

    @property
    def pixel_depth(self) -> int:
        return int(self.header.pixel_depth)

    def raw_frames(self, start: int = 0, count: int | None = None) -> np.ndarray:
        """(count, Height, Width) zero-copy memmap slice in file dtype."""
        if count is None:
            count = self.frame_count - start
        return self._mm[start : start + count]

    # -- normalised access ----------------------------------------------
    def read(self, start: int = 0, count: int | None = None) -> np.ndarray:
        """Normalised frames (count, ih, iw) uint16.

        Equivalent per-frame to the reference's
        ``np.rot90(img); img.astype(uint16)*256`` (video_reader.py:117-122),
        vectorised over the chunk.
        """
        raw = self.raw_frames(start, count)
        if self.flag_rotate:
            # np.rot90 over axes (1, 2) for every frame at once
            raw = np.rot90(raw, axes=(1, 2))
        out = np.ascontiguousarray(raw)
        if self.header.pixel_depth == 8:
            out = out.astype(np.uint16) << 8
        return out

    def chunks(self, chunk: int) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (frame_start, normalised_chunk) over the whole video."""
        for start in range(0, self.frame_count, chunk):
            n = min(chunk, self.frame_count - start)
            yield start, self.read(start, n)


def write_ser(
    path: str,
    frames: np.ndarray,
    pixel_depth: int | None = None,
    color_id: int = 0,
    file_id: bytes = b"LUCAM-RECORDER",
) -> None:
    """Write frames (F, Height, Width) uint8/uint16 as a SER file."""
    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError("frames must be (F, H, W)")
    if pixel_depth is None:
        pixel_depth = 8 if frames.dtype == np.uint8 else 16
    dtype = np.uint8 if pixel_depth == 8 else np.dtype("<u2")
    hdr = SerHeader(
        file_id=file_id.ljust(14, b"\0")[:14],
        lu_id=0,
        color_id=color_id,
        little_endian=1,
        width=int(frames.shape[2]),
        height=int(frames.shape[1]),
        pixel_depth=int(pixel_depth),
        frame_count=int(frames.shape[0]),
    )
    with open(path, "wb") as f:
        f.write(hdr.pack())
        # stream in frame blocks: a multi-GB scan (or a rot90 view from a
        # transpose-to-wide fixture) must not materialise one contiguous
        # copy PLUS a tobytes() copy — that doubles peak memory and adds a
        # full extra pass
        block = max(1, (64 << 20) // max(frames[0].nbytes, 1))
        for i in range(0, frames.shape[0], block):
            np.ascontiguousarray(frames[i : i + block], dtype=dtype).tofile(f)
