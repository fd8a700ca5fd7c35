"""Multi-process scale-out: the split of a folder batch across processes.

The port's own copy of ``assign_files`` and ``shard_folder_batch`` from
solex_ser_recon_en_tpu/parallel/distributed.py (stdlib only).  Scans are
independent, so processes that each take a different share of a folder's
files need no communication: every process computes the same split
locally, no coordinator.  That module's ``initialize`` (a
``jax.distributed`` passthrough) has no counterpart here yet: it waits for
the port's ``torch.distributed`` work.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence


def assign_files(
    files: Sequence[str], num_processes: int, process_id: int
) -> List[str]:
    """Deterministic split of a file batch across processes.

    Stable content-independent hashing (not round-robin) so membership is
    insensitive to listing order AND to later additions — the property the
    continuous-detect watcher needs when hosts poll a shared directory.
    Only the basename is hashed, so hosts mounting the same share at
    different paths agree on the split.  Balance is statistical (uniform in
    expectation); small batches can be uneven.
    """
    if not 0 <= process_id < num_processes:
        raise ValueError("process_id out of range")
    import os

    mine = []
    for f in files:
        key = os.path.basename(f)
        h = int.from_bytes(hashlib.sha1(key.encode()).digest()[:4], "big")
        if h % num_processes == process_id:
            mine.append(f)
    return mine


def shard_folder_batch(options, num_processes: int, process_id: int):
    """Folder-batch worklist for this process (cli.main.handle_folder's
    multi-host form)."""
    from ..cli.main import folder_scan_files

    return assign_files(
        sorted(folder_scan_files(options.input_dir)), num_processes, process_id
    )
