"""Multi-process scale-out: ``initialize`` and the split of a folder batch.

Counterpart of solex_ser_recon_en_tpu/parallel/distributed.py.  Scans are
independent, so processes that each take a different share of a folder's
files need no communication: ``assign_files`` and ``shard_folder_batch``
(the port's own copies, stdlib only) give every process the same split,
computed locally, no coordinator.  Within a process the cards form a
device mesh (parallel/mesh.py), which needs no collective either.

``initialize`` is the counterpart of that module's ``jax.distributed``
passthrough: it joins this process to a ``torch.distributed`` process
group (``nccl`` for a CUDA device, ``gloo`` for the CPU).  Neither CLI
calls it, as in the JAX package; a multi-process program that wants
collectives does.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """``torch.distributed.init_process_group`` for this process.

    ``coordinator_address`` ``host:port`` (or a full ``tcp://host:port``)
    is the rendezvous of rank 0; omitted, the environment's
    ``MASTER_ADDR``/``MASTER_PORT`` are (``env://``).  ``num_processes``
    and ``process_id`` are the world size and this process's rank; omitted,
    ``WORLD_SIZE`` and ``RANK`` are read.  The backend follows ``device``:
    ``nccl`` on CUDA (which must be present), ``gloo`` on the CPU.
    """
    import torch.distributed as dist

    from ..utils.device import resolve_device

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)


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
