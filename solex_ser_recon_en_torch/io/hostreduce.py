"""Host pass A over an in-memory frame stack.

The port's own copy of ``host_mean_max_frames`` from
solex_ser_recon_en_tpu/io/hostreduce.py (numpy only): the folder batch
(pipeline/batch.py) reads each small scan whole and takes its mean and max
here.  The rest of that module (the host and band feeds) is not ported
yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def host_mean_max_frames(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/max of an in-memory normalised (F, ih, iw) uint16 stack.

    The host pass A for non-SER sources (AVI) on CPU-only hosts — same
    truncating arithmetic as the reference accumulator
    (solex_util.py:174-188)."""
    n = frames.shape[0]
    acc = frames.sum(axis=0, dtype=np.uint64)
    mean = (acc.astype(np.float64) / n).astype(np.uint16)
    return mean, frames.max(axis=0)
