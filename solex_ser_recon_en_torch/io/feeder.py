"""Raw SER chunks to the device, and their normalisation there.

Counterpart of solex_ser_recon_en_tpu/io/feeder.py: ``prefetch_iter``,
``raw_device_chunks`` and ``normalize_frames``.  The chunks keep the
on-disk layout (the consumers, ops/fused.py, index the raw layout
directly).

``raw_device_chunks`` splits the work over two sides.  A producer thread
fills a ring of ``RING_DEPTH`` staging buffers (pinned on CUDA) from the
native reader (io/native.py: ``ser_prefetch`` of the next chunk, then
``ser_read``, one chunk's frames split over ``COPY_THREADS`` threads;
``ctypes`` drops the GIL for each copy).  The consumer, the caller's
thread, makes every CUDA call: it uploads a filled buffer with
``copy_(non_blocking=True)`` on a side stream into a fresh device tensor,
lets the caller's stream wait on the upload's event, and hands the buffer
back to the producer once that upload has finished.  So the file is read
for chunks k+1 and k+2 while chunk k is uploaded and used; the producer's
exceptions surface on the consumer, and closing the iterator stops the
producer, waits for it and closes the reader.  ``FEED`` holds the last
run's busy and waiting times of both sides.

``raw_device_chunks_plain`` is the plain version of the feed, kept for
the tests and comparisons: one thread copies each memmap slice into one of
two staging buffers and uploads it, so the card waits while the host
copies.  Nothing on the main path calls it.

Not ported from the JAX module: ``pad_to_bucket`` (it keeps XLA at one
compiled program a shape; PyTorch compiles none, and ops/fused.py takes a
short last chunk), and the policy of the other feeds
(``probe_transfer_rate``, ``d2h_responsive``, ``FeedRateMonitor``,
``FeedCollapse``, ``note_collapse``, ``note_small_scan``).

SER only (the AVI demuxer needs OpenCV).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from ..ops.dtypes import as_int16, to_u16, widen
from .native import NativeSerReader
from .ser import SerReader

TARGET_CHUNK_BYTES = 96 * 1024 * 1024
#: threads that share one chunk's copy from the page cache into staging.
#: Measured with bench_feed.py on an 8-core host of an NVIDIA H100 80GB
#: HBM3 (700.00 W), 2.458 GB scan, medians of 3 in three runs: the whole
#: feed takes 0.60-0.71 s with 1 thread, 0.24-0.25 s with 4, 0.19-0.21 s
#: with 6 and 0.19-0.22 s with 8 (the plain feed 0.56-0.60 s); 6 leaves
#: cores to the consumer and the product writers
COPY_THREADS = 6
#: staging buffers: one being filled, one being uploaded, one ready
RING_DEPTH = 3
#: seconds between a blocked producer's looks at its stop flag
_POLL_S = 0.05

#: the last ``raw_device_chunks`` run, written when its iterator ends:
#: chunks and bytes fed, seconds from its first chunk's request to its end
#: (the consumer's work between chunks included), seconds the copy threads
#: spent inside ``ser_read``
#: (summed over threads) and the producer spent filling (wall) and waiting
#: for a free buffer; seconds the consumer waited for a filled
#: buffer (the last such wait holds ``close_s``, the unmapping of the file
#: when the reader closes) and for an upload's event; device milliseconds
#: of the uploads (CUDA only, when the run reached its end)
FEED = {}


def auto_chunk_frames(frame_bytes: int, requested: int) -> int:
    """Frames per host->device transfer, capped to ~96 MB per chunk."""
    cap = max(1, TARGET_CHUNK_BYTES // max(frame_bytes, 1))
    return max(1, min(requested, cap))


def normalize_frames(raw: torch.Tensor, rotate: bool,
                     upscale: bool) -> torch.Tensor:
    """(F, H, W) raw frames -> (F, ih, iw) uint16, on raw's device.

    rotate: np.rot90 over the spatial axes (wavelength axis -> X),
    out[f, i, j] = raw[f, j, W-1-i].  upscale: 8-bit -> 16-bit x256.
    Either one makes a new contiguous slab (the shape changes, so it
    cannot be done in place): one slab of device memory beside ``raw``
    until the caller drops it.  With neither, ``raw`` is returned as is.
    """
    out = raw
    if upscale:
        out = to_u16(widen(out) << 8)
    if rotate:
        out = as_int16(out).transpose(1, 2).flip(1).contiguous().view(
            out.dtype)
    return out


def prefetch_iter(it, depth: int = 2):
    """Run ``it`` in a background thread, keeping ``depth`` items ready.

    The producer's exception is raised on the consumer's side.  When the
    consumer closes or abandons the generator, the producer is told to
    stop, and the generator waits for it: after ``close()`` no thread of
    this iterator is left, so what ``it`` used can be released.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not put(item):
                    return
            put(done)
        except BaseException as e:  # raised again on the consumer's side
            put(e)

    thread = threading.Thread(target=run, daemon=True,
                              name="solex-torch-feed")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while thread.is_alive():    # unblock a producer in put()
            try:
                q.get_nowait()
            except queue.Empty:
                thread.join(_POLL_S)


def _frame_ranges(n: int, parts: int):
    """[0, n) cut into at most ``parts`` contiguous ranges of frames."""
    parts = max(1, min(parts, n))
    return [(n * i // parts, n * (i + 1) // parts) for i in range(parts)]


def _staged_chunks(reader: SerReader, chunk: int, dtype, pin: bool,
                   threads: int, depth: int, stats: dict):
    """Generator of (start, filled staging view (n, H, W), release): the
    producer side of the feed.  ``release()`` hands the view's buffer back
    for refilling; the caller calls it once nothing reads the view any
    more.  Closing the generator stops the producer and closes the file.
    """
    if threads < 1 or depth < 2:
        raise ValueError("the feed needs a copy thread and two buffers")
    native = NativeSerReader(reader.path)
    pool = None
    staged = None
    try:
        if (native.frame_count, native.Height, native.Width,
                native.pixel_depth) != (reader.frame_count, reader.Height,
                                        reader.Width, reader.pixel_depth):
            raise RuntimeError(f"{reader.path}: the native reader and the "
                               "Python reader disagree on the header")
        total = reader.frame_count
        staging = [torch.empty((chunk, reader.Height, reader.Width),
                               dtype=dtype, pin_memory=pin)
                   for _ in range(depth)]
        free: "queue.Queue" = queue.Queue()
        for slot in range(depth):
            free.put(slot)
        stop = threading.Event()
        busy_lock = threading.Lock()
        pool = ThreadPoolExecutor(threads - 1,
                                  thread_name_prefix="solex-torch-copy") \
            if threads > 1 else None

        def copy(start: int, a: int, b: int, host) -> None:
            t0 = time.perf_counter()
            native.read_into(start + a, b - a, host[a:b])
            dt = time.perf_counter() - t0
            with busy_lock:
                stats["copy_thread_s"] += dt

        def fill():
            for start in range(0, total, chunk):
                n = min(chunk, total - start)
                t0 = time.perf_counter()
                slot = None
                while slot is None:
                    if stop.is_set():
                        return
                    try:
                        slot = free.get(timeout=_POLL_S)
                    except queue.Empty:
                        pass
                t1 = time.perf_counter()
                stats["producer_wait_s"] += t1 - t0
                if start + n < total:
                    native.prefetch(start + n, chunk)
                host = staging[slot][:n]
                ranges = _frame_ranges(n, threads)
                futures = [pool.submit(copy, start, a, b, host)
                           for a, b in ranges[1:]]
                copy(start, *ranges[0], host)
                for f in futures:
                    f.result()
                stats["fill_s"] += time.perf_counter() - t1
                yield start, host, slot

        staged = prefetch_iter(fill(), depth)
        for start, host, slot in staged:
            yield start, host, lambda slot=slot: free.put(slot)
    finally:
        if staged is not None:
            stop.set()
            staged.close()          # waits for the producer thread
        if pool is not None:
            pool.shutdown(wait=True)
        t0 = time.perf_counter()
        native.close()
        stats["close_s"] = time.perf_counter() - t0


def raw_device_chunks(
    reader: SerReader, chunk: int, device: torch.device, *,
    threads: int = COPY_THREADS, depth: int = RING_DEPTH,
) -> Tuple[Iterator[Tuple[int, torch.Tensor]], bool, bool]:
    """(iterator of (start, raw chunk on ``device``), rotate, upscale).

    Every yielded tensor is a fresh (n, Height, Width) allocation, ready to
    use on the current stream and safe to keep resident.  The iterator is a
    generator: ``close()`` it (or run it to its end) to stop the producer
    thread and close the file.  ``threads`` and ``depth`` default to the
    module's constants; tests and measurements pass others.
    """
    chunk = auto_chunk_frames(reader.header.frame_bytes, chunk)
    dtype = torch.uint8 if reader.header.pixel_depth == 8 else torch.uint16
    cuda = device.type == "cuda"

    def gen():
        t_begin = time.perf_counter()
        stats = dict(threads=threads, depth=depth, chunks=0, bytes=0,
                     wall_s=0.0, copy_thread_s=0.0, fill_s=0.0, producer_wait_s=0.0,
                     consumer_wait_s=0.0, upload_wait_s=0.0, close_s=0.0,
                     h2d_ms=None)
        staged = _staged_chunks(reader, chunk, dtype, cuda, threads, depth,
                                stats)
        copy_stream = torch.cuda.Stream(device) if cuda else None
        uploads = []            # (begin, end) timing events of each upload
        try:
            while True:
                t0 = time.perf_counter()
                item = next(staged, None)
                stats["consumer_wait_s"] += time.perf_counter() - t0
                if item is None:
                    break
                start, host, release = item
                stats["chunks"] += 1
                stats["bytes"] += host.numel() * host.element_size()
                if not cuda:
                    dev = host.clone()
                    release()
                    yield start, dev
                    continue
                consumer = torch.cuda.current_stream(device)
                with torch.cuda.stream(copy_stream):
                    # allocated from the copy stream's pool; record_stream
                    # makes the allocator wait for the consumer's work
                    # before reuse
                    dev = torch.empty(host.shape, dtype=dtype, device=device)
                    begin = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    begin.record(copy_stream)
                    dev.copy_(host, non_blocking=True)
                    end.record(copy_stream)
                dev.record_stream(consumer)
                consumer.wait_event(end)
                uploads.append((begin, end))
                yield start, dev
                # the buffer goes back once its upload has read it; the
                # producer fills the other buffers meanwhile
                t0 = time.perf_counter()
                end.synchronize()
                stats["upload_wait_s"] += time.perf_counter() - t0
                release()
            if cuda:
                stats["h2d_ms"] = sum(b.elapsed_time(e) for b, e in uploads)
        finally:
            staged.close()
            stats["wall_s"] = time.perf_counter() - t_begin
            FEED.clear()
            FEED.update(stats)

    return gen(), reader.flag_rotate, reader.header.pixel_depth == 8


def raw_device_chunks_plain(
    reader: SerReader, chunk: int, device: torch.device
) -> Tuple[Iterator[Tuple[int, torch.Tensor]], bool, bool]:
    """The plain version of ``raw_device_chunks``: the same chunks, read
    from the Python reader's memmap by the consumer's thread alone (on
    CUDA through two pinned staging buffers, each refilled only after the
    upload that last read it has finished)."""
    chunk = auto_chunk_frames(reader.header.frame_bytes, chunk)
    dtype = torch.uint8 if reader.header.pixel_depth == 8 else torch.uint16
    shape = (reader.Height, reader.Width)

    def gen_cpu():
        for start in range(0, reader.frame_count, chunk):
            n = min(chunk, reader.frame_count - start)
            yield start, torch.from_numpy(np.array(reader.raw_frames(start, n)))

    def gen_cuda():
        copy_stream = torch.cuda.Stream(device)
        staging = [torch.empty((chunk, *shape), dtype=dtype, pin_memory=True)
                   for _ in range(2)]
        done = [None, None]
        for k, start in enumerate(range(0, reader.frame_count, chunk)):
            n = min(chunk, reader.frame_count - start)
            b = k % 2
            if done[b] is not None:
                done[b].synchronize()      # its previous upload has read it
            host = staging[b][:n]
            np.copyto(host.view(torch.int16).numpy() if dtype == torch.uint16
                      else host.numpy(),
                      reader.raw_frames(start, n).view(
                          np.int16 if dtype == torch.uint16 else np.uint8))
            consumer = torch.cuda.current_stream(device)
            with torch.cuda.stream(copy_stream):
                dev = torch.empty((n, *shape), dtype=dtype, device=device)
                dev.copy_(host, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy_stream)
            dev.record_stream(consumer)
            done[b] = ev
            consumer.wait_event(ev)
            yield start, dev
        for ev in done:
            if ev is not None:
                ev.synchronize()

    gen = gen_cuda() if device.type == "cuda" else gen_cpu()
    return gen, reader.flag_rotate, reader.header.pixel_depth == 8
