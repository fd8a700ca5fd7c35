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
#: ops/clahe.py, ops/fused_cuda.py); reset by callers that want to count
#: one run
LAUNCHES = {"recon": 0, "hresample": 0, "tile_hist": 0, "shg_fused": 0,
            "shg_fused_mxu": 0, "sum_max": 0}

#: the most raw chunks one launch of kernel B3 takes (its pointer table,
#: csrc/recon.cu:kMaxChunks; checked against the library when it loads)
RECON_MAX_CHUNKS = 256

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
    # frames, ind_l, left_w, sum, max, disks, S, F, ih, iw, stream
    "solex_shg_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the same arguments
    "solex_shg_fused_mxu": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # frames, S, F, ih, iw, out[12]: kernel B1's launch geometry
    "solex_shg_fused_plan": [_P, _I, _I, _I, _I, _P],
    # frames, S, F, ih, iw, out[10]: kernel B6's launch geometry
    "solex_shg_fused_mxu_plan": [_P, _I, _I, _I, _I, _P],
    # frames, elem_bytes, sum, max, F, pixels a frame, stream
    "solex_sum_max": [_P, _I, _P, _P, _I, _L, _P],
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
            _lib = handle
        return _lib


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {rc}")
