"""Overlapped product-file writes.

The port's own copy of the data-write lane of
solex_ser_recon_en_tpu/io/writers.py (``submit`` and ``barrier``; the port
renders no diagnostic figures, so the deferred figure lane is not copied).
Product writes have no ordering dependencies, and each mixes a
device-to-host copy with a host encode and a disk write, so two worker
threads overlap one write's I/O with another's encode.  The pipeline
submits writes as it produces images and joins them at the end of
``process_scan`` / ``process_file`` (pipeline/run.py): every product file
exists when those return.  A worker's exception is re-raised at the
barrier.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None
_pending: list = []


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    if _pool is None:
        _pool = ThreadPoolExecutor(max_workers=2,
                                   thread_name_prefix="solex-torch-write")
    return _pool


def submit(fn, *args, **kwargs) -> None:
    """Queue one product-file write."""
    with _lock:
        _pending.append(_get_pool().submit(fn, *args, **kwargs))


def barrier() -> None:
    """Wait for every queued write; re-raise the first worker error after
    all of them have finished."""
    with _lock:
        pending = _pending[:]
        _pending.clear()
    first_err = None
    for f in pending:
        try:
            f.result()
        except Exception as e:  # noqa: BLE001 — surface after draining all
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
