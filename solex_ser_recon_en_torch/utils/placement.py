"""Where a stage places its tensors: the feed policy's two flags.

Counterpart of solex_ser_recon_en_tpu/utils/placement.py.  The feed policy
of pipeline/run.py:read_scan sets two flags for the scan it reads:

- ``small_ops_on_host`` (the ``band`` and ``host`` feeds): the small
  image work of the ellipse fit (the blurs and Canny of the 4x-downscaled
  disk) runs on the CPU;
- ``host_pipeline`` (the ``host`` feed): the disks are host arrays, and
  the bulk post-processing (warp, transversalium row statistics, product
  core, de-vignette profiles) runs on the host too, through the native
  library and numpy.

Where the JAX module enters ``jax.default_device``, a stage here asks
``small_ops_device`` / ``host_ops_device`` for the ``torch.device`` to put
its tensors on: the CPU when the flag is set, the scan's device otherwise.

The flags are THREAD-local: cli/main.py:handle_files reads scan N+1 on its
own thread while a pool thread post-processes scan N, and each thread sets
the flags of the scan it works on (pipeline/run.py:process_scan re-asserts
the scan's flags on the pool thread).
"""

from __future__ import annotations

import threading

import torch

_TLS = threading.local()
CPU = torch.device("cpu")


def set_small_ops_on_host(flag: bool) -> None:
    _TLS.small = bool(flag)


def small_ops_on_host() -> bool:
    return getattr(_TLS, "small", False)


def set_host_pipeline(flag: bool) -> None:
    """Full-host mode: the feed policy chose the ``host`` feed (not
    ``band``, whose disks live on the card), so the bulk stages run on the
    host as well."""
    _TLS.pipe = bool(flag)


def host_pipeline() -> bool:
    return getattr(_TLS, "pipe", False)


def small_ops_device(device: torch.device) -> torch.device:
    """The device of the small image ops of a scan on ``device``."""
    return CPU if small_ops_on_host() else torch.device(device)


def host_ops_device(device: torch.device) -> torch.device:
    """The device of the bulk post-processing of a scan on ``device``."""
    return CPU if host_pipeline() else torch.device(device)
