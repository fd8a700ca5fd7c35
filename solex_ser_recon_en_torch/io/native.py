"""ctypes bindings of the port's native host library (csrc/ser_io.cpp).

Counterpart of solex_ser_recon_en_tpu/io/native.py.  ``csrc/ser_io.cpp`` is
the port's own copy of the JAX package's ``native/ser_io.cpp``, held to it
byte for byte by the tests.  It is compiled at first use with the system
C++ compiler into the directory of the CUDA kernels
(``build/solex_torch_kernels/``, ``SOLEX_TORCH_BUILD_DIR`` overrides), the
way ops/cuda_build.py builds those: the file name carries a hash of the
source, the flags, the compiler's version line and the instruction set
``-march=native`` resolves to on this machine, so an edited source or
another machine builds anew and a stale library is never loaded; the
library is written under a temporary name and ``os.replace``d, so
processes that build at once never load a half-written file.

One flag recipe: ``-O3 -march=native -ffp-contract=off``.  The last flag is
not optional: g++ contracts a*b+c into an FMA by default, which would
change the bits of ``ser_recon_f64``.

Where the JAX module degrades to Python (no compiler, a failed build, a
missing symbol, a failed call), this one raises: there is no fallback and
no switch that turns the library off.  ``CALLS`` counts the calls of each
entry point, so a run can show that its main path went through them.

Bound here: ``ser_open``, ``ser_prefetch``, ``ser_read``, ``ser_close``
(``NativeSerReader``), ``box_blur_u16_exact`` (``box_blur_u16``),
``png_pack_rows`` (``png_pack``), ``png_encode_stored_band``
(``png_encode_band``) and ``fits_pack_u16`` (``fits_pack_u16``, the FITS
writer's payload).  The library's other entry points are compiled with the
copy and bound by the modules that will use them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..ops.cuda_build import CSRC, build_dir

SOURCE = CSRC / "ser_io.cpp"
#: the C++ compiler, by name (looked up on PATH)
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_U = ctypes.c_uint32
_UP = ctypes.POINTER(ctypes.c_uint32)
#: entry point -> (restype, argtypes)
_SIGNATURES = {
    # path, handle out, width, height, pixel depth, frame count
    "ser_open": (_I, [ctypes.c_char_p, ctypes.POINTER(_P), _UP, _UP, _UP,
                      _UP]),
    # handle, start, count
    "ser_prefetch": (_I, [_P, _U, _U]),
    # handle, start, count, out
    "ser_read": (_I, [_P, _U, _U, _P]),
    "ser_close": (None, [_P]),
    # src u16 (h, w), h, w, kx, ky, out f32 or NULL, out u16 or NULL
    "box_blur_u16_exact": (_I, [_P, _L, _L, _I, _I, _P, _P]),
    # src (n, w) u8/u16, n, w, is16, out n * (1 + bpp * w) bytes
    "png_pack_rows": (_I, [_P, _L, _L, _I, _P]),
    # src (n, w), n, w, is16, first, final, adler in, crc in, out,
    # adler out, crc out -> bytes emitted
    "png_encode_stored_band": (_L, [_P, _L, _L, _I, _I, _I, _U, _U, _P, _UP,
                                    _UP]),
    # src u16, n elements, out u16 (big-endian, offset by 32768)
    "fits_pack_u16": (_I, [_P, _L, _P]),
}

#: calls of each entry point; reset by callers that want to count one run
CALLS = {name: 0 for name in _SIGNATURES}

_SER_OPEN_ERRORS = {-1: "cannot open or stat the file",
                    -2: "shorter than the 178-byte header",
                    -3: "bad header (zero size, or a pixel depth other "
                        "than 8 or 16)",
                    -4: "mmap failed"}

_lock = threading.Lock()
_calls_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def _count(name: str) -> None:
    with _calls_lock:       # ser_read is called from several threads
        CALLS[name] += 1


def _compiler_output(args: list) -> str:
    try:
        res = subprocess.run([CXX, *args], capture_output=True, text=True,
                             timeout=120)
    except OSError as e:
        raise RuntimeError(
            f"C++ compiler {CXX!r} cannot be run ({e}): the native host "
            "library of solex_ser_recon_en_torch cannot be built") from e
    if res.returncode != 0:
        raise RuntimeError(f"{CXX} {' '.join(args)} failed (rc "
                           f"{res.returncode}):\n{res.stderr[-2000:]}")
    return res.stdout


def compiler_version() -> str:
    """The first line of ``g++ --version``."""
    return _compiler_output(["--version"]).splitlines()[0]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(compiler_version().encode())
    # what -march=native means here: a library built on another machine
    # may hold instructions this one lacks
    h.update(_compiler_output([*CXX_FLAGS, "-Q", "--help=target"]).encode())
    h.update(SOURCE.read_bytes())
    return build_dir() / f"solex_torch_ser_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ser_io.cpp into the shared library, unless it exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        _compiler_output([*CXX_FLAGS, "-o", str(tmp), str(SOURCE)])
        os.replace(tmp, so)
    finally:
        build_seconds = time.perf_counter() - t0
        tmp.unlink(missing_ok=True)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded host library (built on first call); raises when it cannot
    be built or lacks an entry point."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            handle = ctypes.CDLL(str(so))
            for name, (restype, argtypes) in _SIGNATURES.items():
                try:
                    fn = getattr(handle, name)
                except AttributeError as e:
                    raise RuntimeError(
                        f"{so} has no entry point {name}") from e
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = handle
        return _lib


def _address(buf):
    """(address, bytes) of a writable C-contiguous host numpy array or CPU
    tensor."""
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous or not buf.flags.writeable:
            raise ValueError("the buffer must be C-contiguous and writable")
        return buf.ctypes.data, buf.nbytes
    if not hasattr(buf, "data_ptr"):
        raise TypeError(f"numpy array or tensor expected, not {type(buf)}")
    if buf.device.type != "cpu" or not buf.is_contiguous():
        raise ValueError("the tensor must be contiguous and on the host")
    return buf.data_ptr(), buf.numel() * buf.element_size()


class NativeSerReader:
    """Raw-frame SER reader over the native library: an mmap of the file,
    ``madvise`` readahead and a plain memcpy into the caller's buffer."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = None
        h = _P()
        w, ht, d, n = _U(), _U(), _U(), _U()
        _count("ser_open")
        rc = self._lib.ser_open(os.fsencode(path), ctypes.byref(h),
                                ctypes.byref(w), ctypes.byref(ht),
                                ctypes.byref(d), ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(
                f"ser_open({path}) failed with {rc}: "
                + _SER_OPEN_ERRORS.get(rc, "unknown error"))
        self._h = h
        self.path = path
        self.Width, self.Height = int(w.value), int(ht.value)
        self.pixel_depth = int(d.value)
        #: clamped to the frames the file really holds
        self.frame_count = int(n.value)
        self.frame_bytes = self.Width * self.Height * (self.pixel_depth // 8)
        self.dtype = np.dtype(np.uint8 if self.pixel_depth == 8 else "<u2")

    def _handle(self):
        if self._h is None:
            raise RuntimeError(f"{self.path}: the reader is closed")
        return self._h

    def _check_range(self, start: int, count: int, what: str) -> None:
        if start < 0 or count < 0 or start + count > self.frame_count:
            raise RuntimeError(
                f"{what}: frames [{start}, {start + count}) lie outside "
                f"the {self.frame_count} frames of {self.path}")

    def prefetch(self, start: int, count: int) -> None:
        """Ask the kernel to page in frames [start, start + count) (clipped
        to the file's end; ``start`` must be a frame of the file)."""
        if not 0 <= start < self.frame_count or count < 0:
            raise RuntimeError(
                f"ser_prefetch: frame {start} (count {count}) lies outside "
                f"the {self.frame_count} frames of {self.path}")
        _count("ser_prefetch")
        rc = self._lib.ser_prefetch(self._handle(), start, count)
        if rc != 0:
            raise RuntimeError(f"ser_prefetch({start}, {count}) failed "
                               f"with {rc} on {self.path}")

    def read_into(self, start: int, count: int, out) -> None:
        """Copy raw frames [start, start + count) into ``out``, a contiguous
        host numpy array or CPU tensor of exactly count * frame_bytes bytes
        that the caller owns (and keeps alive over the call).  ``ctypes``
        drops the GIL for the copy, so several threads can each read a
        frame range of one chunk."""
        self._check_range(start, count, "ser_read")
        addr, nbytes = _address(out)
        if nbytes != count * self.frame_bytes:
            raise ValueError(f"ser_read: the buffer holds {nbytes} bytes, "
                             f"{count} frames take "
                             f"{count * self.frame_bytes}")
        _count("ser_read")
        rc = self._lib.ser_read(self._handle(), start, count, addr)
        if rc != 0:
            raise RuntimeError(f"ser_read({start}, {count}) failed with "
                               f"{rc} on {self.path}")

    def close(self) -> None:
        """Unmap and close the file; no read may be in flight."""
        if self._h is not None:
            _count("ser_close")
            self._lib.ser_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def box_blur_u16_fits(shape, kx: int, ky: int) -> bool:
    """Whether ``box_blur_u16`` takes a window of kx columns x ky rows on
    an image of this (h, w) shape: the reflected border must fit inside the
    image (one bounce), and 65535 * kx * ky must fit the int32 window sums
    (the numpy twin wraps there as the device program does, where C's
    division would truncate)."""
    h, w = shape
    return (kx >= 1 and ky >= 1
            and kx // 2 <= w - 1 and kx - 1 - kx // 2 <= w - 1
            and ky // 2 <= h - 1 and ky - 1 - ky // 2 <= h - 1
            and kx * ky <= 32767)


def box_blur_u16(img: np.ndarray, kx: int, ky: int, want: str) -> np.ndarray:
    """Exact box blur of a 2-D uint16 image in one C pass
    (``box_blur_u16_exact``): ``want`` 'f32' gives ops/blur.py's
    ``box_blur_host`` result, 'u16' its ``box_blur_u16_host`` result.
    Raises outside the domain of ``box_blur_u16_fits``."""
    if img.dtype != np.uint16 or img.ndim != 2:
        raise TypeError("box_blur_u16 takes a 2-D uint16 image")
    if want not in ("f32", "u16"):
        raise ValueError(f"want must be 'f32' or 'u16', not {want!r}")
    if not box_blur_u16_fits(img.shape, kx, ky):
        raise ValueError(f"a {kx} x {ky} window on a {img.shape} image is "
                         "outside the native blur's domain")
    lib = get_lib()
    img = np.ascontiguousarray(img)
    h, w = img.shape
    out = np.empty((h, w), np.float32 if want == "f32" else np.uint16)
    _count("box_blur_u16_exact")
    rc = lib.box_blur_u16_exact(
        img.ctypes.data, h, w, int(kx), int(ky),
        out.ctypes.data if want == "f32" else None,
        out.ctypes.data if want == "u16" else None)
    if rc != 0:
        raise RuntimeError(f"box_blur_u16_exact failed with {rc}")
    return out


def _png_rows(rows: np.ndarray):
    if rows.ndim != 2 or rows.dtype not in (np.uint16, np.uint8) \
            or 0 in rows.shape:
        raise TypeError("PNG rows must be a 2-D uint8 or uint16 array that "
                        "is not empty")
    rows = np.ascontiguousarray(rows)
    is16 = int(rows.dtype == np.uint16)
    return rows, is16, rows.shape[0] * (1 + (1 + is16) * rows.shape[1])


def png_pack(rows: np.ndarray) -> np.ndarray:
    """PNG scanlines ([filter 0][big-endian samples] a row) of a 2-D u8/u16
    host image as flat bytes (``png_pack_rows``)."""
    rows, is16, payload = _png_rows(rows)
    out = np.empty(payload, np.uint8)
    _count("png_pack_rows")
    rc = get_lib().png_pack_rows(rows.ctypes.data, rows.shape[0],
                                 rows.shape[1], is16, out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"png_pack_rows failed with {rc}")
    return out


def png_encode_band(rows: np.ndarray, first: bool, final: bool, adler: int,
                    crc: int):
    """One PNG IDAT chunk body of a band of rows, framed in one pass:
    scanline pack, zlib stored blocks of at most 65535 bytes, the running
    adler32 of the payload and the chunk's crc32
    (``png_encode_stored_band``).  ``first`` prepends the zlib header;
    ``final`` marks the image's last block and appends the adler32.
    ``crc`` is the running crc (seeded with crc32(b"IDAT")).  Returns
    (body as a uint8 array, adler, crc)."""
    rows, is16, payload = _png_rows(rows)
    cap = (2 * first + payload + 5 * -(-payload // 65535)
           + 4 * final)
    out = np.empty(cap, np.uint8)
    a_out, c_out = _U(0), _U(0)
    _count("png_encode_stored_band")
    total = get_lib().png_encode_stored_band(
        rows.ctypes.data, rows.shape[0], rows.shape[1], is16, int(first),
        int(final), adler & 0xFFFFFFFF, crc & 0xFFFFFFFF, out.ctypes.data,
        ctypes.byref(a_out), ctypes.byref(c_out))
    if total < 0 or total > cap:
        raise RuntimeError(f"png_encode_stored_band failed with {total}")
    return out[:total], a_out.value, c_out.value


def fits_pack_u16(data: np.ndarray) -> np.ndarray:
    """The BITPIX=16 / BZERO=32768 payload of a uint16 array in one pass
    (``fits_pack_u16``: offset by 32768 and byte swap): the bytes of
    ``(data - 32768).astype('>i2')``, as a flat uint16 array."""
    if data.dtype != np.uint16:
        raise TypeError(f"fits_pack_u16 takes uint16 data, not {data.dtype}")
    data = np.ascontiguousarray(data)
    out = np.empty(data.size, dtype=np.uint16)
    lib = get_lib()
    _count("fits_pack_u16")
    rc = lib.fits_pack_u16(data.ctypes.data, data.size, out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"fits_pack_u16 failed with {rc}")
    return out
