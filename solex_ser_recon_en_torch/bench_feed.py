"""Measurements of the scan feed (io/feeder.py): what the host copies, what
the link carries, and what the two do together.

    python -m solex_ser_recon_en_torch.bench_feed scan.ser [--device cpu]
    python -m solex_ser_recon_en_torch.bench_feed scan.ser --register-probe

The first form prints one JSON line: ``os.cpu_count()``; the host's copy
rate from the page cache into pinned staging for 1, 2, 4, 6 and 8 copy
threads (``staging_rate``: the producer side of the feed alone), of one
numpy copy from the memmap (``plain_staging_rate``) and, as a yardstick
that no path uses, of ``os.preadv`` into the same buffers, which reads
the file without mapping it (``pread_staging_rate``); one 96 MB pinned
upload (``h2d_ms``); the seconds of the whole feed by thread count and of
the plain feed (``feed_seconds``); and the feed after the scan was dropped
from the page cache, with and without the ``madvise`` readahead
(``cold_feed``).  On the CPU the rates are those of pageable buffers and
there is no upload.

The second form answers one question on the card: can the scan's read-only
file mapping be registered with ``cudaHostRegister`` and uploaded from in
place, with no staging copy?  It prints CUDA's return codes and, if
a registration held, the seconds of the upload.  It runs in a process of
its own, because a refused registration leaves an error behind in the CUDA
runtime.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import mmap
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from .config import Options
from .io import feeder
from .io.ser import HEADER_SIZE, SerReader
from .utils.device import resolve_device, synchronize

THREAD_COUNTS = (1, 2, 4, 6, 8)


def _chunk_and_dtype(reader: SerReader):
    chunk = feeder.auto_chunk_frames(reader.header.frame_bytes,
                                     Options().frame_chunk)
    dtype = torch.uint8 if reader.pixel_depth == 8 else torch.uint16
    return chunk, dtype


def scan_bytes(reader: SerReader) -> int:
    return reader.frame_count * reader.header.frame_bytes


def staging_rate(reader: SerReader, threads: int, pin: bool) -> float:
    """GB/s of the feed's producer alone: the whole scan from the page
    cache into the ring of staging buffers, ``threads`` copy threads."""
    chunk, _ = _chunk_and_dtype(reader)
    stats = dict(copy_thread_s=0.0, fill_s=0.0, producer_wait_s=0.0,
                 close_s=0.0)
    t0 = time.perf_counter()
    with contextlib.closing(feeder._staged_chunks(
            feeder._chunk_source(reader), chunk, pin, threads,
            feeder.RING_DEPTH, stats)) as staged:
        for _, _, release in staged:
            release()
    return scan_bytes(reader) / (time.perf_counter() - t0) / 1e9


def plain_staging_rate(reader: SerReader, pin: bool) -> float:
    """GB/s of one numpy copy of each memmap chunk into one staging buffer:
    the plain feed's host side."""
    chunk, dtype = _chunk_and_dtype(reader)
    host = torch.empty((chunk, reader.Height, reader.Width), dtype=dtype,
                       pin_memory=pin)
    view = (host.view(torch.int16) if dtype == torch.uint16 else host).numpy()
    as_signed = np.int16 if dtype == torch.uint16 else np.uint8
    t0 = time.perf_counter()
    for start in range(0, reader.frame_count, chunk):
        n = min(chunk, reader.frame_count - start)
        np.copyto(view[:n], reader.raw_frames(start, n).view(as_signed))
    return scan_bytes(reader) / (time.perf_counter() - t0) / 1e9


def pread_staging_rate(reader: SerReader, threads: int, pin: bool) -> float:
    """GB/s of the same copy made by ``os.preadv`` from the file into one
    staging buffer, ``threads`` threads a chunk: the kernel copies from the
    page cache, and no page of the file is mapped or faulted in."""
    chunk, dtype = _chunk_and_dtype(reader)
    fb = reader.header.frame_bytes
    host = torch.empty(chunk * fb, dtype=torch.uint8, pin_memory=pin)
    view = memoryview(host.numpy())
    fd = os.open(reader.path, os.O_RDONLY)

    def read(a: int, b: int, offset: int) -> None:
        while a < b:
            got = os.preadv(fd, [view[a:b]], offset)
            if got <= 0:
                raise OSError(f"preadv returned {got} at offset {offset}")
            a, offset = a + got, offset + got

    try:
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            for start in range(0, reader.frame_count, chunk):
                n = min(chunk, reader.frame_count - start)
                jobs = [pool.submit(read, a * fb, b * fb,
                                    HEADER_SIZE + (start + a) * fb)
                        for a, b in feeder._frame_ranges(n, threads)]
                for j in jobs:
                    j.result()
            return scan_bytes(reader) / (time.perf_counter() - t0) / 1e9
    finally:
        os.close(fd)


def h2d_ms(device: torch.device, nbytes: int = feeder.TARGET_CHUNK_BYTES,
           reps: int = 7) -> float:
    """Median milliseconds of one pinned host-to-device copy of ``nbytes``
    (CUDA events)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
    times = []
    for _ in range(reps + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dev.copy_(host, non_blocking=True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


def feed_seconds(reader: SerReader, device: torch.device, plain: bool = False,
                 **kw) -> float:
    """Seconds to drain one feed of the scan (chunks dropped as they come),
    ending in a synchronise."""
    t0 = time.perf_counter()
    make = feeder.raw_device_chunks_plain if plain else feeder.raw_device_chunks
    chunks, _, _ = make(reader, Options().frame_chunk, device, **kw)
    with contextlib.closing(chunks):
        for _ in chunks:
            pass
    synchronize(device)
    return time.perf_counter() - t0


def cached_fraction(path: str) -> float:
    """Share of the file's pages that are in the page cache (mincore)."""
    libc = ctypes.CDLL(None, use_errno=True)
    size = os.path.getsize(path)
    with open(path, "rb") as f, contextlib.closing(
            mmap.mmap(f.fileno(), size, prot=mmap.PROT_READ)) as mm:
        pages = -(-size // mmap.PAGESIZE)
        vec = (ctypes.c_ubyte * pages)()
        buf = np.frombuffer(mm, np.uint8)
        rc = libc.mincore(ctypes.c_void_p(buf.ctypes.data),
                          ctypes.c_size_t(size), vec)
        del buf
        if rc != 0:
            raise OSError(ctypes.get_errno(), "mincore failed")
        return float((np.frombuffer(vec, np.uint8) & 1).mean())


def drop_from_page_cache(path: str) -> float:
    """Ask the kernel to drop the file's clean pages (no root needed);
    returns the share still cached."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return cached_fraction(path)


def cold_feed(path: str, device: torch.device) -> dict:
    """The feed after the scan was dropped from the page cache, with the
    readahead of the next chunk and without it."""
    out = {}
    prefetch = feeder.NativeSerReader.prefetch
    for name, fn in (("readahead", prefetch),
                     ("no_readahead", lambda self, start, count: None)):
        left = drop_from_page_cache(path)
        feeder.NativeSerReader.prefetch = fn
        try:
            # a new reader: its memmap must not keep pages referenced
            secs = feed_seconds(SerReader(path), device)
        finally:
            feeder.NativeSerReader.prefetch = prefetch
        out[name] = dict(cached_before=left, seconds=secs)
    return out


def measure(path: str, device: torch.device,
            thread_counts=THREAD_COUNTS, reps: int = 3) -> dict:
    """Every figure is the median of ``reps`` passes over the scan, taken
    in turns (each pass of the sweep visits every thread count once), but
    for the cold feeds, which are single passes."""
    reader = SerReader(path)
    cuda = device.type == "cuda"
    nbytes = scan_bytes(reader)
    feed_seconds(reader, device)            # warm: page cache, pinned pool

    def sweep(fn):
        runs = [{t: fn(t) for t in thread_counts} for _ in range(reps)]
        return {t: statistics.median(r[t] for r in runs)
                for t in thread_counts}

    def median(fn):
        return statistics.median(fn() for _ in range(reps))

    out = dict(
        cpu_count=os.cpu_count(), scan_gb=nbytes / 1e9,
        copy_threads=feeder.COPY_THREADS, ring_depth=feeder.RING_DEPTH,
        staging_gbps=sweep(lambda t: staging_rate(reader, t, cuda)),
        plain_staging_gbps=median(lambda: plain_staging_rate(reader, cuda)),
        pread_staging_gbps=sweep(
            lambda t: pread_staging_rate(reader, t, cuda)),
        h2d_ms=h2d_ms(device) if cuda else None,
        feed_s=sweep(lambda t: feed_seconds(reader, device, threads=t)),
        plain_feed_s=median(lambda: feed_seconds(reader, device, plain=True)),
    )
    if cuda:
        out["h2d_gbps"] = feeder.TARGET_CHUNK_BYTES / out["h2d_ms"] / 1e6
    del reader
    out["cold_feed"] = cold_feed(path, device)
    return out


def register_probe(path: str, device: torch.device) -> dict:
    """``cudaHostRegister`` of the scan's read-only mapping, plain and with
    the read-only flag; where one holds, the seconds of an upload of the
    frames straight from the mapping."""
    torch.cuda.init()
    rt = torch.cuda.cudart()
    reader = SerReader(path)
    chunk, dtype = _chunk_and_dtype(reader)
    nbytes = scan_bytes(reader)
    out = {}
    with open(path, "rb") as f, contextlib.closing(
            mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)) as mm:
        whole = np.frombuffer(mm, np.uint8)
        for name, flags in (("default", 0), ("read_only", 8)):
            rc = int(rt.cudaHostRegister(whole.ctypes.data, whole.nbytes,
                                         flags))
            out[name] = dict(rc=rc)
            if rc != 0:
                continue
            frames = torch.from_numpy(
                whole[HEADER_SIZE:HEADER_SIZE + nbytes].view(np.int16 if
                dtype == torch.uint16 else np.uint8)).view(
                    reader.frame_count, reader.Height, reader.Width)
            out[name]["is_pinned"] = bool(frames.is_pinned())
            dev = torch.empty(frames.shape, dtype=frames.dtype, device=device)
            for rep in ("first", "second"):
                t0 = time.perf_counter()
                for start in range(0, reader.frame_count, chunk):
                    dev[start:start + chunk].copy_(
                        frames[start:start + chunk], non_blocking=True)
                synchronize(device)
                out[name][f"upload_s_{rep}"] = time.perf_counter() - t0
            ok = bool((dev[-1].cpu() == frames[-1]).all())
            out[name]["last_frame_equal"] = ok
            del dev, frames
            out[name]["unregister_rc"] = int(
                rt.cudaHostUnregister(whole.ctypes.data))
        del whole
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m solex_ser_recon_en_torch.bench_feed",
        description="Host copy, link and feed rates of one scan (one JSON "
                    "line).")
    ap.add_argument("scan", help="SER scan")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--register-probe", action="store_true",
                    help="probe cudaHostRegister of the file mapping")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.register_probe:
        if device.type != "cuda":
            raise SystemExit("--register-probe needs the card")
        out = register_probe(args.scan, device)
    else:
        out = measure(args.scan, device)
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
