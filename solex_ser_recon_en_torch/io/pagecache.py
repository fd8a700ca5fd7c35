"""Best-effort page-cache pinning for multi-pass scan access.

The pipeline reads every scan at least twice (pass A mean/max, pass B
recon — reference: Solex_recon.py:61-73), and batch/bench callers re-read
the same file across runs.  On hosts with a small page-cache budget
(cgroup-capped) and token-bucket disk throughput, the kernel reclaims the
scan's pages between passes and every pass pays the full disk read again.

``pin(path)`` holds an open read-only mapping of the file and ``mlock``\\ s
it so those pages stay resident for the process lifetime (an explicit,
bounded form of what the OS page cache is supposed to do).  Everything is
best-effort: any failure (no permission, RLIMIT_MEMLOCK, low memory)
degrades to normal unpinned reads.
"""

from __future__ import annotations

import ctypes
import mmap
import os
from collections import OrderedDict
from typing import Optional, Tuple

_PINS: "OrderedDict[Tuple[str, float, int], Tuple[mmap.mmap, int]]" = OrderedDict()
_PINNED_BYTES = 0
_MIN_FILE = 64 * 1024 * 1024       # small files don't suffer multi-pass cost


def _budget() -> int:
    """Pin at most min(8 GB, 25% of MemAvailable-at-first-use)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                    return min(8 * 1024**3, avail // 4)
    except OSError:
        pass
    return 2 * 1024**3


_BUDGET: Optional[int] = None


def pin(path: str) -> bool:
    """Pin ``path``'s bytes into RAM for this process; True when pinned
    (now or already).  Oldest pins are released when over budget."""
    global _PINNED_BYTES, _BUDGET
    if os.environ.get("SOLEX_NO_PIN") == "1":
        return False
    try:
        st = os.stat(path)
    except OSError:
        return False
    size = st.st_size
    if size < _MIN_FILE:
        return False
    key = (os.path.abspath(path), st.st_mtime, size)
    if key in _PINS:
        _PINS.move_to_end(key)
        return True
    if _BUDGET is None:
        _BUDGET = _budget()
    if size > _BUDGET:
        return False
    while _PINNED_BYTES + size > _BUDGET and _PINS:
        _, (old_mm, old_size) = _PINS.popitem(last=False)
        old_mm.close()
        _PINNED_BYTES -= old_size
    try:
        import numpy as np

        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), size, prot=mmap.PROT_READ)
        # the mapping address via the buffer protocol (read-only safe)
        addr = np.frombuffer(mm, dtype=np.uint8).ctypes.data
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        rc = libc.mlock(ctypes.c_void_p(addr), ctypes.c_size_t(size))
        if rc != 0:
            mm.close()
            return False
    except Exception:
        return False
    _PINS[key] = (mm, size)
    _PINNED_BYTES += size
    return True


def pinned_bytes() -> int:
    return _PINNED_BYTES


def clear() -> None:
    global _PINNED_BYTES
    for mm, _ in _PINS.values():
        mm.close()
    _PINS.clear()
    _PINNED_BYTES = 0
