"""Build, load and launch-check the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for
Hopper (``sm_90a``), all started together, and the objects are linked into
ONE shared library with a plain C interface, at first use, under
``build/solex_torch_kernels/`` (``SOLEX_TORCH_BUILD_DIR`` overrides).  The
library name carries a hash of the sources, the headers beside them
(``csrc/*.cuh``) and the flags, so an edited source
builds anew and a stale library is never loaded.  ``ctypes`` loads it: each
entry point takes device pointers (``tensor.data_ptr()``) and PyTorch's
current stream, and returns the ``cudaGetLastError()`` of its launch, which
``check`` turns into an exception.

There is no fallback: a missing ``nvcc``, a failed build or a refused
launch raises.  ``LAUNCHES`` counts the kernel launches of each wrapper, so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-std=c++17", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
]

#: kernel launches per wrapper (ops/recon_cuda.py, ops/warp_fast.py,
#: ops/clahe.py, ops/fused_cuda.py, ops/rowstats.py's row gain,
#: pipeline/products.py's stretches), added by ``count_launch``; reset by
#: callers that want to count one run (ops/rowstats.py counts its row
#: statistics in ``ROW_STATS_LAUNCHES``, ops/canny.py in
#: ``CANNY_LAUNCHES``, pipeline/products.py the product chain's calls in
#: ``PRODUCTS_LAUNCHES``)
LAUNCHES = {"recon": 0, "hresample": 0, "tile_hist": 0, "shg_fused": 0,
            "shg_fused_mxu": 0, "sum_max": 0, "row_gain": 0, "clahe_lut": 0,
            "clahe_blend": 0, "stretch_params": 0, "stretch": 0}
_launches_lock = threading.Lock()


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` (a session launches from two threads:
    read_scan's and process_scan's)."""
    with _launches_lock:
        LAUNCHES[name] += 1

#: the most raw chunks one launch of kernel B3 takes (its pointer table,
#: csrc/recon.cu:kMaxChunks; checked against the library when it loads)
RECON_MAX_CHUNKS = 256

#: the widest row the transversalium row statistics stage in shared memory
#: (csrc/rowstats.cu:kStageFloats; checked when the library loads); wider
#: rows need an (H, W) float32 workspace
ROW_STATS_STAGE_FLOATS = 8192

#: the widest blur the device Canny takes, as a radius (csrc/canny.cuh:
#: kMaxRadius; checked when the library loads): sigma up to 2.0
CANNY_MAX_RADIUS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # bases (host array of K device pointers), K, chunk_frames, elem_bytes,
    # ind_l, left_w, out, S, F, H, W, ih, out_frames, frame_offset, rotate,
    # upscale, stream
    "solex_recon_chunks": [ctypes.POINTER(ctypes.c_uint64), _I, _I, _I,
                           _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    "solex_recon_max_chunks": [],
    # V, loc, w0, w1, cadd, out, K, H, Wp, OW, stream
    "solex_hresample": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # img, elem_bytes, h, w, tiles_y, tiles_x, hist_size, out, stream
    "solex_tile_hist": [_P, _I, _I, _I, _I, _I, _I, _P, _P],
    # frames, ind_l, left_w, sum, max, disks, S, F, ih, iw, stream, int* bulk
    "solex_shg_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # the same arguments but the last
    "solex_shg_fused_mxu": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # frames, S, F, ih, iw, out[12]: kernel B1's launch geometry
    "solex_shg_fused_plan": [_P, _I, _I, _I, _I, _P],
    # frames, S, F, ih, iw, out[10]: kernel B6's launch geometry
    "solex_shg_fused_mxu_plan": [_P, _I, _I, _I, _I, _P],
    # frames, elem_bytes, sum, max, F, pixels a frame, stream, int* owned
    "solex_sum_max": [_P, _I, _P, _P, _I, _L, _P, _P],
    # frames, elem_bytes, F, pixels a frame, out[12]: pass A's launch plan
    "solex_sum_max_plan": [_P, _I, _I, _L, _P],
    # img, elem_bytes, H, W, cx, cy, r, bx0, by1, bx2, by3, mean_all,
    # mean_r, workspace, dbg_i, dbg_f, stream
    "solex_row_stats": [_P, _I, _I, _I] + [ctypes.c_float] * 7
    + [_P, _P, _P, _P, _P, _P],
    "solex_row_stats_stage_floats": [],
    # img, H, W, taps (host floats), taps, low, high, classes, mag, sector,
    # flag, stream
    "solex_canny_gradients": [_P, _I, _I, _P, _I, ctypes.c_float,
                              ctypes.c_float, _P, _P, _P, _P, _P],
    # classes, edges, H, W, flag, rounds (host int out), stream
    "solex_canny_hysteresis": [_P, _P, _I, _I, _P, ctypes.POINTER(_I), _P],
    "solex_canny_max_radius": [],
    # img, elem_bytes (2 u16, 4 float32), h, w, gain, out, stream
    "solex_row_gain": [_P, _I, _I, _I, _P, _P, _P],
    # hist, tiles, hist_size, clip, scale, lut, full or NULL, stream
    "solex_clahe_lut": [_P, _I, _I, _I, ctypes.c_float, _P, _P, _P],
    # img, elem_bytes, h, w, tiles_y, tiles_x, hist_size, lut, out, stream
    "solex_clahe_blend": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # hist, k0, k1, low_w, high_w, full or NULL, f0, f1, f_low_w, f_high_w,
    # params, stream
    "solex_stretch_params": [_P, _I, _I, ctypes.c_float, ctypes.c_float, _P,
                             _I, _I, ctypes.c_float, ctypes.c_float, _P, _P],
    # cl1, img or NULL, n, params, cc, hc or NULL, pr or NULL, stream
    "solex_stretch": [_P, _P, _L, _P, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def build_dir() -> Path:
    env = os.environ.get("SOLEX_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[1] / "build" / "solex_torch_kernels"


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "solex_ser_recon_en_torch cannot be built"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"solex_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list, log: list) -> None:
    """Run the commands in parallel; log each; raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out = p.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)} (rc {p.returncode}):\n"
                          f"{out[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    shared library, unless it exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [so.parent / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    log: list = []
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                  for src, o in zip(sources(), objs)], log)
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]], log)
    finally:
        build_seconds = time.perf_counter() - t0
        (so.parent / "build.log").write_text("\n".join(log))
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            if handle.solex_recon_max_chunks() != RECON_MAX_CHUNKS:
                raise RuntimeError("csrc/recon.cu's chunk table holds "
                                   f"{handle.solex_recon_max_chunks()} "
                                   f"pointers, not {RECON_MAX_CHUNKS}")
            if handle.solex_row_stats_stage_floats() != ROW_STATS_STAGE_FLOATS:
                raise RuntimeError(
                    "csrc/rowstats.cu stages rows of "
                    f"{handle.solex_row_stats_stage_floats()} floats, not "
                    f"{ROW_STATS_STAGE_FLOATS}")
            if handle.solex_canny_max_radius() != CANNY_MAX_RADIUS:
                raise RuntimeError(
                    "csrc/canny.cuh takes a radius of "
                    f"{handle.solex_canny_max_radius()}, not "
                    f"{CANNY_MAX_RADIUS}")
            _lib = handle
        return _lib


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {rc}")
