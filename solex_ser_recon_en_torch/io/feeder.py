"""Raw SER and AVI chunks to the device, and their normalisation there.

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
``copy_(non_blocking=True)`` on the card's upload stream (one for every
feed, ``_copy_stream``) into a fresh device tensor,
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

The feed's chunk source depends on the scan (``_chunk_source``): a SER's
frames through the native reader; an uncompressed 8-bit grey-scale AVI's
u8 planes, copied untouched by the same copy threads from the file's
memmap at their offsets (an 8-byte chunk header and padding lie between
planes) and yielded like an 8-bit SER's, so pass A and kernel B3 do the
rot90 and the x256; a compressed AVI's frames decoded by OpenCV on one
thread, already normalised (u16, no rotate, no upscale).

The ``band`` feed (pipeline/run.py) uploads only the recon's spectral
band through the same producer, ring, copy threads and upload stream
(``band_device_chunks``, source ``_BandSource``): each copy thread copies
its frames' band rows (wide-stored) or band columns (tall-stored) out of
the native reader's mapping in one strided copy, or out of the band slab
that the host's fused sweep already extracted.  It takes the place of the
JAX module's ``prefetch_iter`` thread feeding ``jax.device_put``.

Under a device mesh (``shards``, pipeline/run.py) each staged chunk is
cut into contiguous pieces, one a frame shard (the JAX module's frame
``sharding`` of ``device_put``): each piece goes up on its own card's
upload stream and is waited on by that card's consumer stream, and the
buffer goes back to the ring once every piece's upload has read it.

``probe_transfer_rate``, ``cached_probe_rate`` and ``note_small_scan``
rate the host-to-device link for the ``auto`` feed policy, memoised a
process.

Not ported from the JAX module: ``pad_to_bucket`` and
``_fit_chunk_to_shards`` (they keep XLA at one compiled program a shape
and a chunk divisible over the shards; PyTorch compiles none, ops/fused.py
takes a short last chunk, and a piece carries its start frame), ``d2h_responsive``, ``FeedRateMonitor``,
``FeedCollapse`` and ``note_collapse`` (silent fallbacks for a remote
link; ROADMAP A6 says why).
"""

from __future__ import annotations

import mmap
import queue
import resource
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from ..ops.dtypes import as_int16, to_u16, widen
from ..utils.timer import span
from .native import NativeSerReader
from .ser import SerReader
from .video import _AviVideo, _SerVideo

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
#: buffer and for an upload's event (the spans ``staging wait`` and
#: ``upload wait``, utils/timer.py); ``close_s``, the source's closing
#: (the unmapping of the file) inside the consumer's span ``close`` after
#: the last chunk; device milliseconds of the uploads (CUDA only, when the
#: run reached its end); ``minflt``, the process's minor page faults from
#: the first chunk's request to the end (every thread's: the copy
#: threads' first touch of the file's mapped pages)
FEED = {}

#: the upload stream of each card, shared by every feed.  The chunks are
#: allocated from its pool of the caching allocator, so the next scan of a
#: session reuses the blocks the last one freed; a new stream a scan would
#: leave each scan's 2.5 GB cached under a stream no later scan uses.
_COPY_STREAMS: dict = {}
_copy_streams_lock = threading.Lock()


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    with _copy_streams_lock:
        if index not in _COPY_STREAMS:
            _COPY_STREAMS[index] = torch.cuda.Stream(index)
        return _COPY_STREAMS[index]


#: the memoised link rate: (bytes/s, time.monotonic() of the probe)
_PROBE_CACHE = None
#: seconds a probe's reading stays fresh
PROBE_TTL_S = 600.0
#: bytes of small scans fed since the process started (note_small_scan)
_SMALL_BYTES_SEEN = 0
_probe_lock = threading.Lock()


def probe_transfer_rate(device: torch.device,
                        sample_bytes: int = 24 * 1024 * 1024) -> float:
    """Host-to-``device`` copy rate (bytes/s) for the ``auto`` feed policy:
    a 4 MB warm-up copy, then the worse of two timed copies of
    ``sample_bytes`` / 2 from pageable host memory.  Memoised for
    ``PROBE_TTL_S`` seconds within the process."""
    global _PROBE_CACHE
    with _probe_lock:
        rate = _fresh_rate()
        if rate is not None:
            return rate
        now = time.monotonic()
        device = torch.device(device)

        def put(n: int) -> float:
            src = torch.ones(n, dtype=torch.uint8)
            dst = torch.empty(n, dtype=torch.uint8, device=device)
            t0 = time.perf_counter()
            dst.copy_(src)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return max(time.perf_counter() - t0, 1e-6)

        put(4 * 1024 * 1024)
        n = sample_bytes // 2
        rate = min(n / put(n) for _ in range(2))
        _PROBE_CACHE = (rate, now)
        return rate


def _fresh_rate():
    if _PROBE_CACHE is not None and \
            time.monotonic() - _PROBE_CACHE[1] < PROBE_TTL_S:
        return _PROBE_CACHE[0]
    return None


def cached_probe_rate():
    """The memoised probe reading (bytes/s), or None when none is fresh:
    a small scan's feed decision consults an earlier probe for free."""
    with _probe_lock:
        return _fresh_rate()


def note_small_scan(nbytes: int) -> int:
    """Add a small scan's bytes to the process's count and return it: once
    a folder of small scans has fed more than a probe costs, a probe pays
    for itself."""
    global _SMALL_BYTES_SEEN
    with _probe_lock:
        _SMALL_BYTES_SEEN += int(nbytes)
        return _SMALL_BYTES_SEEN


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


class _SerSource:
    """A SER's raw frames through the native reader (any copy thread may
    read any frame range)."""

    max_threads = None

    def __init__(self, reader: SerReader):
        self.reader = reader
        self.frame_count = reader.frame_count
        self.shape = (reader.Height, reader.Width)
        self.frame_bytes = reader.header.frame_bytes
        self.dtype = torch.uint8 if reader.pixel_depth == 8 else torch.uint16
        self.rotate = reader.flag_rotate
        self.upscale = reader.pixel_depth == 8
        self._native = None

    def open(self) -> None:
        r = self.reader
        self._native = NativeSerReader(r.path)
        n = self._native
        if (n.frame_count, n.Height, n.Width, n.pixel_depth) != (
                r.frame_count, r.Height, r.Width, r.pixel_depth):
            raise RuntimeError(f"{r.path}: the native reader and the "
                               "Python reader disagree on the header")

    def prefetch(self, start: int, count: int) -> None:
        self._native.prefetch(start, count)

    def read_into(self, start: int, count: int, host: torch.Tensor) -> int:
        self._native.read_into(start, count, host)
        return count

    def close(self) -> None:
        if self._native is not None:
            self._native.close()


class _AviPlaneSource:
    """An uncompressed 8-bit grey-scale AVI's planes, stored as they are
    (u8, the file's orientation), copied from the video's memmap at their
    offsets; numpy drops the interpreter lock for each copy.  Planes are
    evenly spaced within a RIFF segment, so a frame range is copied as one
    strided copy a run of equal steps; the next chunk's planes are asked
    for ahead (``MADV_WILLNEED``), as the SER reader's ``ser_prefetch``
    does."""

    max_threads = None

    def __init__(self, video: _AviVideo):
        self.video = video
        self.frame_count = video.frame_count
        self.shape = (video.Height, video.Width)
        self.frame_bytes = video.Height * video.Width
        self.dtype = torch.uint8
        self.rotate = video.Width > video.Height
        self.upscale = True

    def open(self) -> None:
        pass

    def prefetch(self, start: int, count: int) -> None:
        offsets = self.video._raw[start:start + count]
        if len(offsets):
            first = int(offsets[0]) & ~(mmap.PAGESIZE - 1)
            end = int(offsets[-1]) + self.frame_bytes
            self.video._mm.base.madvise(mmap.MADV_WILLNEED, first,
                                        end - first)

    def read_into(self, start: int, count: int, host: torch.Tensor) -> int:
        mm, h, w = self.video._mm, *self.shape
        dst = host.numpy()
        offsets = self.video._raw[start:start + count]
        steps = np.diff(offsets)
        i = 0
        while i < count:
            step = int(steps[i]) if i < count - 1 else self.frame_bytes
            # planes i .. i + n - 1 lie ``step`` bytes apart
            off = np.flatnonzero(steps[i:] != step)
            n = int(off[0]) + 1 if len(off) else count - i
            np.copyto(dst[i:i + n], np.lib.stride_tricks.as_strided(
                mm[int(offsets[i]):], shape=(n, h, w), strides=(step, w, 1)))
            i += n
        return count

    def close(self) -> None:
        pass


class _Cv2Source:
    """A compressed AVI decoded by OpenCV, in order, on one thread: frames
    already normalised (u16, rotated, x256).  A capture may hold fewer
    frames than its header says; ``read_into`` returns the count decoded."""

    max_threads = 1

    def __init__(self, video: _AviVideo):
        self.video = video
        self.frame_count = video.frame_count
        self.shape = (video.ih, video.iw)
        self.frame_bytes = video.ih * video.iw * 2
        self.dtype = torch.uint16
        self.rotate = False
        self.upscale = False

    def open(self) -> None:
        pass

    def prefetch(self, start: int, count: int) -> None:
        pass

    def read_into(self, start: int, count: int, host: torch.Tensor) -> int:
        frames = self.video._read_cv2(start, count)
        n = frames.shape[0]
        host[:n].view(torch.int16).numpy()[...] = frames.view(np.int16)
        return n

    def close(self) -> None:
        pass


class _BandSource:
    """The raw frames' spectral band, columns [x0, x1) of the normalised
    frame: raw rows [x0, x1) of a wide-stored SER (rotate), raw columns of
    a tall-stored one.  Copied from the native reader's mapping
    (``ser_data``) or from ``slab``, the (F, ...) band slab of exactly
    [x0, x1) that the fused host sweep extracted; each copy thread copies
    its frame range in one strided numpy copy (the interpreter lock is
    dropped for it)."""

    max_threads = None

    def __init__(self, reader: SerReader, x0: int, x1: int, slab=None):
        self.reader = reader
        self.frame_count = reader.frame_count
        self.rotate = reader.flag_rotate
        self.upscale = reader.pixel_depth == 8
        self.dtype = torch.uint8 if self.upscale else torch.uint16
        if self.rotate:
            self.rect = (slice(x0, x1), slice(None))
            self.shape = (x1 - x0, reader.Width)
        else:
            self.rect = (slice(None), slice(x0, x1))
            self.shape = (reader.Height, x1 - x0)
        self.frame_bytes = (self.shape[0] * self.shape[1]
                            * reader.header.dtype.itemsize)
        if slab is not None and (slab.shape[0] != self.frame_count
                                 or tuple(slab.shape[1:]) != self.shape):
            raise ValueError(f"band slab {slab.shape} is not the "
                             f"({self.frame_count}, {self.shape}) band")
        self.slab = slab
        self._native = None
        self._frames = None

    def open(self) -> None:
        if self.slab is not None:
            self._frames = self.slab
            return
        self._native = NativeSerReader(self.reader.path)
        frames = self._native.frames()
        if frames.shape != (self.frame_count, self.reader.Height,
                            self.reader.Width):
            raise RuntimeError(f"{self.reader.path}: the native reader and "
                               "the Python reader disagree on the header")
        self._frames = frames[(slice(None), *self.rect)]

    def prefetch(self, start: int, count: int) -> None:
        pass

    def read_into(self, start: int, count: int, host: torch.Tensor) -> int:
        src = self._frames[start:start + count]
        if host.dtype == torch.uint16:
            np.copyto(host.view(torch.int16).numpy(), src.view(np.int16))
        else:
            np.copyto(host.numpy(), src)
        return count

    def close(self) -> None:
        self._frames = None
        if self._native is not None:
            self._native.close()
            self._native = None


def _ser_reader(video) -> SerReader:
    """The SER reader of a VideoReader of a SER scan, or the reader given
    (io/ser.py:SerReader, or a reader with its fields)."""
    if isinstance(video, _AviVideo):
        raise TypeError(f"{video._path}: not a SER scan")
    return video._r if isinstance(video, _SerVideo) else video


def _chunk_source(video):
    """The feed's source of raw chunks of a SER reader or a VideoReader
    (io/video.py:open_video)."""
    if isinstance(video, _AviVideo):
        if video._raw is not None:
            return _AviPlaneSource(video)
        return _Cv2Source(video)
    return _SerSource(_ser_reader(video))


def _staged_chunks(source, chunk: int, pin: bool, threads: int, depth: int,
                   stats: dict):
    """Generator of (start, filled staging view (n, H, W), release): the
    producer side of the feed.  ``release()`` hands the view's buffer back
    for refilling; the caller calls it once nothing reads the view any
    more.  Closing the generator stops the producer and closes the source.
    """
    if threads < 1 or depth < 2:
        raise ValueError("the feed needs a copy thread and two buffers")
    source.open()
    pool = None
    staged = None
    try:
        total = source.frame_count
        staging = [torch.empty((chunk, *source.shape), dtype=source.dtype,
                               pin_memory=pin)
                   for _ in range(depth)]
        free: "queue.Queue" = queue.Queue()
        for slot in range(depth):
            free.put(slot)
        stop = threading.Event()
        busy_lock = threading.Lock()
        pool = ThreadPoolExecutor(threads - 1,
                                  thread_name_prefix="solex-torch-copy") \
            if threads > 1 else None

        def copy(start: int, a: int, b: int, host) -> int:
            t0 = time.perf_counter()
            got = source.read_into(start + a, b - a, host[a:b])
            dt = time.perf_counter() - t0
            with busy_lock:
                stats["copy_thread_s"] += dt
            return got

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
                    source.prefetch(start + n, chunk)
                host = staging[slot][:n]
                ranges = _frame_ranges(n, threads)
                futures = [pool.submit(copy, start, a, b, host)
                           for a, b in ranges[1:]]
                got = copy(start, *ranges[0], host)
                got += sum(f.result() for f in futures)
                stats["fill_s"] += time.perf_counter() - t1
                if got:
                    yield start, host[:got], slot
                if got < n:         # a decoder that ran out of frames
                    return

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
        source.close()
        stats["close_s"] = time.perf_counter() - t0


def raw_device_chunks(
    video, chunk: int, device: torch.device, *,
    threads: int = COPY_THREADS, depth: int = RING_DEPTH, shards=None,
) -> Tuple[Iterator[Tuple[int, torch.Tensor, int]], bool, bool]:
    """(iterator of (start, raw chunk on ``device``, shard), rotate,
    upscale) of a SerReader or a VideoReader (io/video.py:open_video);
    ``shard`` is 0 without a mesh.

    Every yielded tensor is a fresh (n, H, W) allocation, ready to use on
    the current stream and safe to keep resident; (H, W) is the source's
    frame shape (the stored one, or (ih, iw) for frames OpenCV decoded).
    The iterator is a generator: ``close()`` it (or run it to its end) to
    stop the producer thread and close the source.  ``threads`` and
    ``depth`` default to the module's constants; tests and measurements
    pass others.

    ``shards`` (a mesh row's frame devices, parallel/mesh.py; default
    ``[device]``) splits every staged chunk into contiguous pieces, one a
    shard (parallel/mesh.py:frame_split), each uploaded to its own device
    and yielded as (start, piece, shard index), in frame order.  A chunk
    that does not divide over the shards splits unevenly: pieces carry
    their start frame, so none is padded.
    """
    source = _chunk_source(video)
    return (_device_chunks(source, chunk, device, threads, depth, shards),
            source.rotate, source.upscale)


def band_device_chunks(
    reader, x0: int, x1: int, chunk: int, device: torch.device, *,
    slab=None, threads: int = COPY_THREADS, depth: int = RING_DEPTH,
    shards=None,
) -> Tuple[Iterator[Tuple[int, torch.Tensor, int]], bool, bool]:
    """``raw_device_chunks`` of the spectral band [x0, x1) of a SER scan
    (a SerReader or a VideoReader of one): (iterator of (start, band chunk
    (n, x1 - x0, W) if rotate else (n, H, x1 - x0) on ``device``, shard),
    rotate,
    upscale), read from the file's mapping or from ``slab``, the fused
    host sweep's band slab of exactly [x0, x1) (``_BandSource``); split
    over ``shards`` as ``raw_device_chunks`` does."""
    source = _BandSource(_ser_reader(reader), x0, x1, slab)
    return (_device_chunks(source, chunk, device, threads, depth, shards),
            source.rotate, source.upscale)


def _device_chunks(source, chunk: int, device: torch.device, threads: int,
                   depth: int, shards=None):
    """The consumer side of the feed over a chunk source (the generator
    ``raw_device_chunks`` and ``band_device_chunks`` return)."""
    from ..parallel.mesh import frame_split

    chunk = auto_chunk_frames(source.frame_bytes, chunk)
    dtype = source.dtype
    threads = min(threads, source.max_threads or threads)
    devices = [torch.device(d) for d in shards] if shards else [device]
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"the feed's devices are of one type: {devices}")
    cuda = devices[0].type == "cuda"

    def gen():
        t_begin = time.perf_counter()
        minflt = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        stats = dict(threads=threads, depth=depth, chunks=0, bytes=0,
                     wall_s=0.0, copy_thread_s=0.0, fill_s=0.0,
                     producer_wait_s=0.0, consumer_wait_s=0.0,
                     upload_wait_s=0.0, close_s=0.0, h2d_ms=None)
        staged = _staged_chunks(source, chunk, cuda, threads, depth, stats)
        copy_streams = [_copy_stream(d) for d in devices] if cuda else None
        uploads = []            # (begin, end) timing events of each upload
        fed = 0                 # frames yielded so far
        try:
            # the last chunk ends the loop, so that the source closes under
            # ``close`` and not inside a wait for a chunk that never comes
            # (a decoder that runs out of frames ends it through None; the
            # first request, which opens the source, is always made)
            while not fed or fed < source.frame_count:
                with span("staging wait", timed=True) as wait:
                    item = next(staged, None)
                stats["consumer_wait_s"] += wait.seconds
                if item is None:
                    break
                start, host, release = item
                fed = start + host.shape[0]
                stats["chunks"] += 1
                stats["bytes"] += host.numel() * host.element_size()
                pieces = [(k, a, b) for k, (a, b) in enumerate(
                    frame_split(host.shape[0], len(devices))) if a < b]
                if not cuda:
                    with span("upload"):
                        out = [(start + a, host[a:b].clone(), k)
                               for k, a, b in pieces]
                    release()
                    yield from out
                    continue
                out, ends = [], []
                with span("upload"):
                    for k, a, b in pieces:
                        # each piece on its own card's upload stream, waited
                        # on by that card's consumer stream
                        dev_k, copy_stream = devices[k], copy_streams[k]
                        consumer = torch.cuda.current_stream(dev_k)
                        with torch.cuda.stream(copy_stream):
                            # allocated from the copy stream's pool;
                            # record_stream makes the allocator wait for the
                            # consumer's work before reuse
                            dev = torch.empty((b - a, *host.shape[1:]),
                                              dtype=dtype, device=dev_k)
                            begin = torch.cuda.Event(enable_timing=True)
                            end = torch.cuda.Event(enable_timing=True)
                            begin.record(copy_stream)
                            dev.copy_(host[a:b], non_blocking=True)
                            end.record(copy_stream)
                        dev.record_stream(consumer)
                        consumer.wait_event(end)
                        uploads.append((begin, end))
                        ends.append(end)
                        out.append((start + a, dev, k))
                yield from out
                # the buffer goes back once every upload of it has read
                # it; the producer fills the other buffers meanwhile
                with span("upload wait", timed=True) as wait:
                    for end in ends:
                        end.synchronize()
                stats["upload_wait_s"] += wait.seconds
                release()
            if cuda:
                stats["h2d_ms"] = sum(b.elapsed_time(e) for b, e in uploads)
        finally:
            with span("close"):
                staged.close()
            stats["wall_s"] = time.perf_counter() - t_begin
            stats["minflt"] = (resource.getrusage(resource.RUSAGE_SELF)
                               .ru_minflt - minflt)
            FEED.clear()
            FEED.update(stats)

    return gen()


def raw_device_chunks_plain(
    reader, chunk: int, device: torch.device, shards=None,
) -> Tuple[Iterator[Tuple[int, torch.Tensor, int]], bool, bool]:
    """The plain version of ``raw_device_chunks`` for SER scans: the same
    chunks, read from the Python reader's memmap by the consumer's thread
    alone (on CUDA through two pinned staging buffers, each refilled only
    after the upload that last read it has finished), as (start, chunk, 0)
    triples.  It takes no mesh: ``shards`` raises."""
    if shards:
        raise ValueError("the plain feed does not split chunks over shards")
    reader = _ser_reader(reader)
    chunk = auto_chunk_frames(reader.header.frame_bytes, chunk)
    dtype = torch.uint8 if reader.header.pixel_depth == 8 else torch.uint16
    shape = (reader.Height, reader.Width)

    def gen_cpu():
        for start in range(0, reader.frame_count, chunk):
            n = min(chunk, reader.frame_count - start)
            yield start, torch.from_numpy(np.array(
                reader.raw_frames(start, n))), 0

    def gen_cuda():
        copy_stream = _copy_stream(device)
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
            yield start, dev, 0
        for ev in done:
            if ev is not None:
                ev.synchronize()

    gen = gen_cuda() if device.type == "cuda" else gen_cpu()
    return gen, reader.flag_rotate, reader.header.pixel_depth == 8
