"""Overlapped product-file writer pool + deferred diagnostic-figure lane.

The port's own copy of solex_ser_recon_en_tpu/io/writers.py.  Product
writes (five FITS, four PNGs a shift) have no ordering dependencies, and
each mixes a device-to-host copy with a host encode and a disk write, so
two worker threads overlap one write's I/O with another's encode.  The
pipeline submits writes as it produces images and joins them at the end of
``process_scan`` / ``process_file`` (pipeline/run.py): every DATA product
file exists when those return.  A worker's exception is re-raised at the
barrier.  SOLEX_SYNC_WRITES=1 restores strictly sequential writes
(debugging / timing attribution).

**Diagnostic figures ride a separate deferred lane** (``submit_figure``):
the three matplotlib plots are pure sinks, nothing downstream reads them.
They are queued, rendered by ``figure_barrier()``, which the CLI calls
after the batch (and an atexit hook backstops), so every file exists when
the command finishes while a scan's latency does not pay for plot
rasterisation.  Backpressure: a submit beyond a small queue depth spills
the oldest entries to one background worker, so a long batch cannot
accumulate unbounded image references.
"""

from __future__ import annotations

import atexit
import os
import threading
from concurrent.futures import ThreadPoolExecutor

_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None
_pending: list = []
_fig_pool: ThreadPoolExecutor | None = None
_fig_queue: list = []  # (fn, args, kwargs), rendered lazily
_pending_figs: list = []  # in-flight overflow renders
_FIG_QUEUE_DEPTH = 8  # bound on the images the queue keeps alive


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    if _pool is None:
        _pool = ThreadPoolExecutor(max_workers=2,
                                   thread_name_prefix="solex-torch-write")
    return _pool


_atexit_registered = False


def _get_fig_pool() -> ThreadPoolExecutor:
    global _fig_pool
    if _fig_pool is None:
        _fig_pool = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="solex-torch-figure")
    return _fig_pool


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(figure_barrier)


def submit(fn, *args, **kwargs) -> None:
    """Queue one product-file write (or run it inline under
    SOLEX_SYNC_WRITES=1)."""
    if os.environ.get("SOLEX_SYNC_WRITES") == "1":
        fn(*args, **kwargs)
        return
    with _lock:
        _pending.append(_get_pool().submit(fn, *args, **kwargs))


def submit_figure(fn, *args, **kwargs) -> None:
    """Queue one diagnostic-figure render on the deferred lane.

    Lazy by design: nothing renders until ``figure_barrier()`` (the CLI
    calls it after the batch; atexit backstops), since a background render
    would take the interpreter lock from the pipeline.  Overflow beyond a
    small queue depth spills the oldest entries to one background worker."""
    if os.environ.get("SOLEX_SYNC_WRITES") == "1":
        fn(*args, **kwargs)
        return
    with _lock:
        _register_atexit()
        _fig_queue.append((fn, args, kwargs))
        spill, pool = None, None
        if len(_fig_queue) > _FIG_QUEUE_DEPTH:
            spill = _fig_queue[: -_FIG_QUEUE_DEPTH]
            del _fig_queue[: -_FIG_QUEUE_DEPTH]
            pool = _get_fig_pool()
        if spill:
            for f, a, k in spill:
                _pending_figs.append(pool.submit(f, *a, **k))


def _drain(pending: list) -> None:
    first_err = None
    for f in pending:
        try:
            f.result()
        except Exception as e:  # noqa: BLE001 — surface after draining all
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def barrier() -> None:
    """Wait for every queued DATA write; re-raise the first worker error
    after all of them have finished.  Deferred figures are not joined
    here: see ``figure_barrier``."""
    with _lock:
        pending = _pending[:]
        _pending.clear()
    _drain(pending)


def figure_barrier() -> None:
    """Render every queued diagnostic figure and join in-flight spills;
    re-raise the first error after all of them have been tried."""
    with _lock:
        queued = _fig_queue[:]
        _fig_queue.clear()
        pending = _pending_figs[:]
        _pending_figs.clear()
    first_err = None
    for fn, args, kwargs in queued:
        try:
            fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — surface after draining all
            if first_err is None:
                first_err = e
    try:
        _drain(pending)
    except Exception as e:  # noqa: BLE001
        if first_err is None:
            first_err = e
    if first_err is not None:
        raise first_err
