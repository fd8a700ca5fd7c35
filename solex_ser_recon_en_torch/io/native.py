"""ctypes bindings of the port's native host library (csrc/ser_io.cpp,
csrc/plans.cpp, csrc/canny.cpp and csrc/products.cpp).

Counterpart of solex_ser_recon_en_tpu/io/native.py.  ``csrc/ser_io.cpp`` is
the port's own copy of the JAX package's ``native/ser_io.cpp``, held to it
byte for byte by the tests; ``csrc/plans.cpp`` holds the host entry points
of the kernels' launch plans (``csrc/plans.cuh``), ``csrc/canny.cpp`` those
of the device Canny's per-pixel arithmetic (``csrc/canny.cuh``),
``csrc/products.cpp`` those of the product chain's (``csrc/products.cuh``).
All four are compiled at first use with the system C++ compiler into the
directory of the CUDA kernels (``build/solex_torch_kernels/``,
``SOLEX_TORCH_BUILD_DIR`` overrides), the way ops/cuda_build.py builds
those: the file name carries a hash of the sources and their headers, the
flags, the compiler's version line and the instruction set
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

Every entry point of the library is bound:

- the reader (``NativeSerReader``): ``ser_open``, ``ser_prefetch``,
  ``ser_read``, ``ser_close``, ``ser_data`` (``frames``, a view of the
  mapping), and the host pass A sweeps ``ser_mean_max``,
  ``ser_mean_max_band``, ``ser_sample_stats`` and ``ser_band_stats``;
- the host pass B: ``ser_recon_f64`` (``recon_chunk``);
- the host warp: ``warp_f32_u16``, ``warp_u16_u16`` (``warp_u16``) and
  ``warp_u16_u16_batch`` (``warp_u16_batch``);
- the transversalium row statistics: ``row_medstats_f32``,
  ``row_medstats_sorted_f32`` and ``mask_interval_f32`` (``row_medstats``);
- the host product core: ``gain_hist_u16``, ``hist_u16``, ``lut_u16`` and
  ``clahe_u16``;
- ``box_blur_u16_exact`` (``box_blur_u16``), ``png_pack_rows``
  (``png_pack``), ``png_encode_stored_band`` (``png_encode_band``) and
  ``fits_pack_u16`` (the FITS writer's payload);
- the launch plans (``solex_*``, called by ops/fused_cuda.py and not
  counted);
- the device Canny's arithmetic (``solex_canny_*_host``, called by the
  tests and not counted);
- the product chain's arithmetic (``solex_row_gain_host``,
  ``solex_clahe_lut_host``, ``solex_clahe_blend_host``,
  ``solex_stretch_params_host``, ``solex_stretch_host``, called by the tests
  and not counted).
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
#: the launch plans' host entry points; they include plans.cuh beside them
PLANS = CSRC / "plans.cpp"
#: the device Canny's per-pixel arithmetic; it includes canny.cuh beside it
CANNY = CSRC / "canny.cpp"
#: the product chain's arithmetic; it includes products.cuh beside it
PRODUCTS = CSRC / "products.cpp"
#: the C++ compiler, by name (looked up on PATH)
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_U = ctypes.c_uint32
_UP = ctypes.POINTER(ctypes.c_uint32)
_Z = ctypes.c_size_t
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
    # handle -> the first frame's byte in the mapping
    "ser_data": (_P, [_P]),
    # handle, sum out u64 (H, W), max out u16 (H, W)
    "ser_mean_max": (_I, [_P, _P, _P]),
    # handle, sum out, max out, r0, r1, c0, c1, band out (F, r1-r0, c1-c0)
    "ser_mean_max_band": (_I, [_P, _P, _P, _U, _U, _U, _U, _P]),
    # handle, step, sum out, max out -> frames summed
    "ser_sample_stats": (_I, [_P, _U, _P, _P]),
    # handle, r0, r1, c0, c1, sum out, max out (band-local)
    "ser_band_stats": (_I, [_P, _U, _U, _U, _U, _P, _P]),
    # src, frame stride (bytes), frames, is_u16, upscale, flat_l (S, ih)
    # i64, right_off, w_l (ih,) f64, w_r (ih,) f64, S, ih, out at this
    # chunk's first frame, out stride (frames), do_prefetch
    "ser_recon_f64": (_I, [_P, _L, _U, _I, _I, _P, _L, _P, _P, _U, _U, _P,
                           _L, _I]),
    # src, h, w_in, mat3 (9,) f64, out_h, out_w, cval, out u16
    "warp_f32_u16": (_I, [_P, _L, _L, _P, _L, _L, ctypes.c_float, _P]),
    "warp_u16_u16": (_I, [_P, _L, _L, _P, _L, _L, ctypes.c_float, _P]),
    # srcs (K,) pointers, k, h, w_in, mat3, out_h, out_w, cvals (K,) f32,
    # outs (K,) pointers
    "warp_u16_u16_batch": (_I, [_P, _L, _L, _L, _P, _L, _L, _P, _P]),
    # rat (R, W) f32, R, W, row_ok (R,) u8, x_lo (R,) i32, x_hi (R,) i32,
    # value out (R, W) f32, nk out (R,) i64
    "row_medstats_f32": (_I, [_P, _L, _L, _P, _P, _P, _P, _P]),
    # sorted masked rows, rat, R, W, row_ok, x_lo, x_hi, value out, nk out
    "row_medstats_sorted_f32": (_I, [_P, _P, _L, _L, _P, _P, _P, _P, _P]),
    # src (R, W) f32, R, W, row_ok, x_lo, x_hi, out (R, W) f32
    "mask_interval_f32": (_I, [_P, _L, _L, _P, _P, _P, _P]),
    # src (h, w) u16, h, w, gain (h,) f32, out u16, hist u32[65536] or NULL
    "gain_hist_u16": (_I, [_P, _L, _L, _P, _P, _P]),
    # src u16, n, hist u32[65536]
    "hist_u16": (_I, [_P, _L, _P]),
    # src u16, n, lut u16[65536], out u16
    "lut_u16": (_I, [_P, _L, _P, _P]),
    # src (h, w) u16, h, w, tiles_x, tiles_y, clip limit, out u16, hist
    # u32[65536] or NULL
    "clahe_u16": (_I, [_P, _L, _L, _I, _I, ctypes.c_double, _P, _P]),
    # frames' address, elem_bytes, F, pixels a frame, block slots, out
    "solex_sum_max_plan_host": (_I, [_Z, _I, _I, _L, _L, _P]),
    # frames' address, S, ih, iw, out (both)
    "solex_shg_fused_plan_host": (_I, [_Z, _I, _I, _I, _P]),
    "solex_shg_fused_mxu_plan_host": (_I, [_Z, _I, _I, _I, _P]),
    # tiles, block slots, F
    "solex_frames_per_block": (_I, [_L, _L, _I]),
    "solex_mxu_frame_stride": (_L, [_I]),
    "solex_plan_limits": (_I, [_P]),
    # a, b, c f32, n, out f32: a * b + c rounded once
    "solex_canny_fma_host": (_I, [_P, _P, _P, _L, _P]),
    # y, x f32, n, out (f32; the sector's int32)
    "solex_canny_hypot_host": (_I, [_P, _P, _L, _P]),
    "solex_canny_atan2f_host": (_I, [_P, _P, _L, _P]),
    "solex_canny_sector_host": (_I, [_P, _P, _L, _P]),
    # img (h, w) f32, h, w, taps f32, n, low, high, mag f32, sector i32,
    # classes u8 (each or NULL), edges u8
    "solex_canny_host": (_I, [_P, _I, _I, _P, _I, ctypes.c_float,
                              ctypes.c_float, _P, _P, _P, _P]),
    # the card's entry points of csrc/products.cu less the stream: img,
    # elem_bytes, h, w, gain, out
    "solex_row_gain_host": (_I, [_P, _I, _I, _I, _P, _P]),
    # hist, tiles, hist_size, clip, scale, lut, full or NULL
    "solex_clahe_lut_host": (_I, [_P, _I, _I, _I, ctypes.c_float, _P, _P]),
    # img, elem_bytes, h, w, tiles_y, tiles_x, hist_size, lut, out
    "solex_clahe_blend_host": (_I, [_P, _I, _I, _I, _I, _I, _I, _P, _P]),
    # hist, k0, k1, low_w, high_w, full or NULL, f0, f1, f_low_w, f_high_w,
    # params out
    "solex_stretch_params_host": (_I, [_P, _I, _I, ctypes.c_float,
                                       ctypes.c_float, _P, _I, _I,
                                       ctypes.c_float, ctypes.c_float, _P]),
    # cl1, img or NULL, n, params, cc, hc or NULL, pr or NULL
    "solex_stretch_host": (_I, [_P, _P, _L, _P, _P, _P, _P]),
}

#: the sorted hybrid of the row statistics (numpy sorts the masked rows,
#: ``row_medstats_sorted_f32`` consumes them); False takes the library's
#: own radix selection (``row_medstats_f32``).  Both are bit-identical.
ROWSTATS_SORTED = True

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
    for src in (SOURCE, PLANS, PLANS.with_suffix(".cuh"), CANNY,
                CANNY.with_suffix(".cuh"), PRODUCTS,
                PRODUCTS.with_suffix(".cuh")):
        h.update(src.read_bytes())
    return build_dir() / f"solex_torch_ser_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ser_io.cpp, csrc/plans.cpp, csrc/canny.cpp and
    csrc/products.cpp into the shared library, unless it exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        _compiler_output([*CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                          str(PLANS), str(CANNY), str(PRODUCTS)])
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

    def frames(self) -> np.ndarray:
        """The file's frames as a read-only (F, Height, Width) view of the
        reader's mapping (``ser_data``): no copy; valid until ``close``."""
        _count("ser_data")
        addr = self._lib.ser_data(self._handle())
        if not addr:
            raise RuntimeError(f"ser_data returned NULL on {self.path}")
        n = self.frame_count * self.frame_bytes
        buf = (ctypes.c_uint8 * max(n, 1)).from_address(addr)
        view = np.frombuffer(buf, np.uint8, n).view(self.dtype).reshape(
            self.frame_count, self.Height, self.Width)
        view.flags.writeable = False
        return view

    def _stats(self, shape):
        return (np.zeros(shape, np.uint64), np.zeros(shape, np.uint16))

    def mean_max(self):
        """(sum u64, max u16) over every frame, raw layout, in one native
        sweep (``ser_mean_max``)."""
        s, m = self._stats((self.Height, self.Width))
        _count("ser_mean_max")
        rc = self._lib.ser_mean_max(self._handle(), s.ctypes.data,
                                    m.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"ser_mean_max failed with {rc} on "
                               f"{self.path}")
        return s, m

    def _check_rect(self, r0: int, r1: int, c0: int, c1: int) -> None:
        if not (0 <= r0 < r1 <= self.Height and 0 <= c0 < c1 <= self.Width):
            raise ValueError(f"rectangle rows [{r0}, {r1}) x cols [{c0}, "
                             f"{c1}) outside the {self.Height} x "
                             f"{self.Width} frames of {self.path}")

    def mean_max_band(self, r0: int, r1: int, c0: int, c1: int):
        """``mean_max`` and, in the same sweep, every frame's raw rectangle
        rows [r0, r1) x cols [c0, c1) copied into a (F, r1-r0, c1-c0) slab
        (``ser_mean_max_band``).  Returns (sum, max, slab)."""
        self._check_rect(r0, r1, c0, c1)
        s, m = self._stats((self.Height, self.Width))
        band = np.empty((self.frame_count, r1 - r0, c1 - c0), self.dtype)
        _count("ser_mean_max_band")
        rc = self._lib.ser_mean_max_band(self._handle(), s.ctypes.data,
                                         m.ctypes.data, r0, r1, c0, c1,
                                         band.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"ser_mean_max_band failed with {rc} on "
                               f"{self.path}")
        return s, m, band

    def sample_stats(self, step: int):
        """(sum u64, max u16, frames summed) over every ``step``-th frame,
        full frames (``ser_sample_stats``)."""
        if step < 1:
            raise ValueError(f"sample_stats: step {step} < 1")
        s, m = self._stats((self.Height, self.Width))
        _count("ser_sample_stats")
        n = self._lib.ser_sample_stats(self._handle(), int(step),
                                       s.ctypes.data, m.ctypes.data)
        if n < 0:
            raise RuntimeError(f"ser_sample_stats failed with {n} on "
                               f"{self.path}")
        return s, m, int(n)

    def band_stats(self, r0: int, r1: int, c0: int, c1: int):
        """(sum u64, max u16) over every frame of the raw rectangle rows
        [r0, r1) x cols [c0, c1), band-local layout, reading only the
        rectangle's bytes (``ser_band_stats``)."""
        self._check_rect(r0, r1, c0, c1)
        s, m = self._stats((r1 - r0, c1 - c0))
        _count("ser_band_stats")
        rc = self._lib.ser_band_stats(self._handle(), r0, r1, c0, c1,
                                      s.ctypes.data, m.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"ser_band_stats failed with {rc} on "
                               f"{self.path}")
        return s, m

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


def recon_chunk(src: np.ndarray, flat_l: np.ndarray, right_off: int,
                w_l: np.ndarray, w_r: np.ndarray, upscale: bool,
                out: np.ndarray, start: int) -> None:
    """The float64 two-tap gather-lerp of pass B over one chunk of frames
    (``ser_recon_f64``), bit-identical to io/hostreduce.py's numpy loop.

    ``src``: (n, ...) u8/u16 frames, each contiguous, frames any stride
    apart (a memmap slice or a band slab); ``flat_l``: (S, ih) element
    indices of the left taps in a frame viewed flat, the right tap
    ``right_off`` further; ``out``: the (S, ih, F_total) uint16 disks,
    frames [start, start + n) written."""
    if src.dtype not in (np.uint8, np.uint16) or src.ndim < 2:
        raise TypeError(f"recon_chunk: u8/u16 frames expected, not "
                        f"{src.dtype} {src.shape}")
    if not src[0].flags.c_contiguous or src.strides[0] <= 0:
        raise ValueError("recon_chunk: each frame must be contiguous")
    if out.dtype != np.uint16 or out.ndim != 3 or not out.flags.c_contiguous \
            or not out.flags.writeable:
        raise ValueError("recon_chunk: out must be a writable contiguous "
                         "(S, ih, F) uint16 array")
    n = src.shape[0]
    S, ih = flat_l.shape
    if out.shape[:2] != (S, ih) or not 0 <= start <= out.shape[2] - n:
        raise ValueError(f"recon_chunk: out {out.shape} cannot take frames "
                         f"[{start}, {start + n}) of ({S}, {ih}) disks")
    frame_elems = src[0].size
    flat_l = np.ascontiguousarray(flat_l, dtype=np.int64)
    if n and (flat_l.min() < 0 or flat_l.max() + right_off >= frame_elems):
        raise ValueError("recon_chunk: a tap lies outside the frame")
    w_l = np.ascontiguousarray(w_l, dtype=np.float64)
    w_r = np.ascontiguousarray(w_r, dtype=np.float64)
    if w_l.shape != (ih,) or w_r.shape != (ih,):
        raise ValueError(f"recon_chunk: the weights must be ({ih},)")
    _count("ser_recon_f64")
    rc = get_lib().ser_recon_f64(
        src.ctypes.data, src.strides[0], n, int(src.itemsize == 2),
        int(upscale), flat_l.ctypes.data, int(right_off), w_l.ctypes.data,
        w_r.ctypes.data, S, ih, out.ctypes.data + start * out.itemsize,
        out.shape[2], 0)
    if rc != 0:
        raise RuntimeError(f"ser_recon_f64 failed with {rc}")


def _out_u16(out, shape):
    if out is None:
        return np.empty(shape, np.uint16)
    if (out.shape != shape or out.dtype != np.uint16
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable contiguous {shape} "
                         "uint16 array")
    return out


def warp_u16(image: np.ndarray, mat3: np.ndarray, out_h: int, out_w: int,
             cval: float, out: np.ndarray = None) -> np.ndarray:
    """Projective bilinear warp of a 2-D uint16 image (taken /65536) or
    float32 [0, 1) image to uint16 (``warp_u16_u16`` / ``warp_f32_u16``),
    bit-identical to ops/warp_host.py's numpy twin and the u16 store.
    ``cval`` is on the [0, 1) scale; ``out`` receives the result in place
    when given."""
    if image.ndim != 2:
        raise TypeError("warp_u16 takes a 2-D image")
    h, w_in = image.shape
    shape = (int(out_h), int(out_w))
    res = _out_u16(out, shape)
    m = np.ascontiguousarray(mat3, dtype=np.float64)
    if m.size != 9:
        raise ValueError("warp_u16: mat3 must be 3 x 3")
    if image.dtype == np.uint16:
        name = "warp_u16_u16"
        src = np.ascontiguousarray(image)
    elif image.dtype == np.float32:
        name = "warp_f32_u16"
        src = np.ascontiguousarray(image)
    else:
        raise TypeError(f"warp_u16 takes uint16 or float32, not "
                        f"{image.dtype}")
    _count(name)
    rc = getattr(get_lib(), name)(src.ctypes.data, h, w_in, m.ctypes.data,
                                  shape[0], shape[1], float(cval),
                                  res.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"{name} failed with {rc}")
    return res


def warp_u16_batch(images, mat3: np.ndarray, out_h: int, out_w: int, cvals,
                   out: np.ndarray) -> np.ndarray:
    """K uint16 images of one shape warped by ONE matrix into ``out`` (K,
    out_h, out_w) (``warp_u16_u16_batch``: each output row's coordinates
    computed once for all K); each plane bit-identical to ``warp_u16``.
    ``cvals``: one [0, 1)-scale fill a image."""
    k = len(images)
    if k < 1:
        raise ValueError("warp_u16_batch: no images")
    h, w_in = images[0].shape
    if any(im.dtype != np.uint16 or im.shape != (h, w_in) for im in images):
        raise TypeError("warp_u16_batch: K uint16 images of one shape")
    out = _out_u16(out, (k, int(out_h), int(out_w)))
    srcs = [np.ascontiguousarray(im) for im in images]
    m = np.ascontiguousarray(mat3, dtype=np.float64)
    cv = np.ascontiguousarray(cvals, dtype=np.float32)
    if m.size != 9 or cv.shape != (k,):
        raise ValueError("warp_u16_batch: mat3 3 x 3 and one cval a image")
    ptrs = ctypes.c_void_p * k
    src_p = ptrs(*(s.ctypes.data for s in srcs))
    out_p = ptrs(*(out[i].ctypes.data for i in range(k)))
    _count("warp_u16_u16_batch")
    rc = get_lib().warp_u16_u16_batch(
        ctypes.addressof(src_p), k, h, w_in, m.ctypes.data, int(out_h),
        int(out_w), cv.ctypes.data, ctypes.addressof(out_p))
    if rc != 0:
        raise RuntimeError(f"warp_u16_u16_batch failed with {rc}")
    return out


def row_medstats(rat: np.ndarray, row_ok: np.ndarray, x_lo: np.ndarray,
                 x_hi: np.ndarray):
    """The masked row median / MAD clip of the transversalium row
    statistics: (value (R, W) f32, rat where kept and 0 elsewhere; nk (R,)
    i64, the kept counts), with numpy's selection semantics.  The valid
    pixels of row r are columns [x_lo[r], x_hi[r]) where row_ok[r].  The
    sorted hybrid (``mask_interval_f32``, a numpy row sort,
    ``row_medstats_sorted_f32``) when ``ROWSTATS_SORTED``, else the
    library's radix selection (``row_medstats_f32``)."""
    rat = np.ascontiguousarray(rat, dtype=np.float32)
    R, W = rat.shape
    row_ok = np.ascontiguousarray(row_ok, dtype=np.uint8)
    x_lo = np.ascontiguousarray(x_lo, dtype=np.int32)
    x_hi = np.ascontiguousarray(x_hi, dtype=np.int32)
    if row_ok.shape != (R,) or x_lo.shape != (R,) or x_hi.shape != (R,):
        raise ValueError(f"row_medstats: row_ok, x_lo, x_hi must be ({R},)")
    lib = get_lib()
    value = np.empty((R, W), np.float32)
    nk = np.empty(R, np.int64)
    if ROWSTATS_SORTED:
        srt = np.empty_like(rat)
        _count("mask_interval_f32")
        rc = lib.mask_interval_f32(rat.ctypes.data, R, W, row_ok.ctypes.data,
                                   x_lo.ctypes.data, x_hi.ctypes.data,
                                   srt.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"mask_interval_f32 failed with {rc}")
        srt.sort(axis=1)
        name = "row_medstats_sorted_f32"
        args = (srt.ctypes.data, rat.ctypes.data)
    else:
        name = "row_medstats_f32"
        args = (rat.ctypes.data,)
    _count(name)
    rc = getattr(lib, name)(*args, R, W, row_ok.ctypes.data,
                            x_lo.ctypes.data, x_hi.ctypes.data,
                            value.ctypes.data, nk.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"{name} failed with {rc}")
    return value, nk


def _image_u16(img: np.ndarray, what: str) -> np.ndarray:
    if img.dtype != np.uint16:
        raise TypeError(f"{what} takes uint16, not {img.dtype}")
    return np.ascontiguousarray(img)


def gain_hist_u16(src: np.ndarray, gain: np.ndarray, want_hist: bool = True):
    """(u16(clip(src * gain[row], 0, 65535)), its value histogram (u32,
    65536 bins) or None) in one pass (``gain_hist_u16``)."""
    src = _image_u16(src, "gain_hist_u16")
    if src.ndim != 2:
        raise TypeError("gain_hist_u16 takes a 2-D image")
    h, w = src.shape
    gain = np.ascontiguousarray(gain, dtype=np.float32)
    if gain.shape != (h,):
        raise ValueError(f"gain_hist_u16: the gain must be ({h},)")
    out = np.empty_like(src)
    hist = np.empty(65536, np.uint32) if want_hist else None
    _count("gain_hist_u16")
    rc = get_lib().gain_hist_u16(src.ctypes.data, h, w, gain.ctypes.data,
                                 out.ctypes.data,
                                 hist.ctypes.data if want_hist else None)
    if rc != 0:
        raise RuntimeError(f"gain_hist_u16 failed with {rc}")
    return out, hist


def hist_u16(img: np.ndarray) -> np.ndarray:
    """np.bincount(img.ravel(), minlength=65536) of a uint16 array, as u32
    (``hist_u16``)."""
    img = _image_u16(img, "hist_u16")
    hist = np.empty(65536, np.uint32)
    _count("hist_u16")
    rc = get_lib().hist_u16(img.ctypes.data, img.size, hist.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"hist_u16 failed with {rc}")
    return hist


def lut_u16(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """lut[img] of a uint16 array and a 65536-entry uint16 LUT
    (``lut_u16``)."""
    img = _image_u16(img, "lut_u16")
    lut = _image_u16(lut, "lut_u16")
    if lut.shape != (65536,):
        raise ValueError("lut_u16: the LUT must have 65536 entries")
    out = np.empty_like(img)
    _count("lut_u16")
    rc = get_lib().lut_u16(img.ctypes.data, img.size, lut.ctypes.data,
                           out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"lut_u16 failed with {rc}")
    return out


def clahe_u16(img: np.ndarray, clip_limit: float = 0.8, tiles=(2, 2),
              want_hist: bool = False):
    """OpenCV's CLAHE of a 2-D uint16 image (``clahe_u16``;
    ``cv2.createCLAHE(clipLimit, tileGridSize=tiles).apply``, reference
    solex_util.py:532-533).  With ``want_hist`` the output's value
    histogram (u32, 65536 bins) comes from the same pass: returns (out,
    hist), else out."""
    img = _image_u16(img, "clahe_u16")
    if img.ndim != 2 or min(img.shape) < 2:
        raise ValueError(f"clahe_u16 takes a 2-D image of at least 2 x 2, "
                         f"not {img.shape}")
    tx, ty = int(tiles[0]), int(tiles[1])
    if tx < 1 or ty < 1:
        raise ValueError(f"clahe_u16: tiles {tiles}")
    h, w = img.shape
    out = np.empty_like(img)
    hist = np.empty(65536, np.uint32) if want_hist else None
    _count("clahe_u16")
    rc = get_lib().clahe_u16(img.ctypes.data, h, w, tx, ty,
                             float(clip_limit), out.ctypes.data,
                             hist.ctypes.data if want_hist else None)
    if rc != 0:
        raise RuntimeError(f"clahe_u16 failed with {rc}")
    return (out, hist) if want_hist else out
