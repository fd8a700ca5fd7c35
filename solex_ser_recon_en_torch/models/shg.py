"""One fused device step of SHG reconstruction.

Counterpart of solex_ser_recon_en_tpu/models/shg.py: mean/max and the
multi-shift reconstruction over a resident, normalised frame slab
(reference hot path: solex_util.py:93-144,174-188).  The host-side fits
(spectral line, ellipse) happen between device steps; this is what the
card spends its time in.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.fused_cuda import Step, mean_max_plain, shg_fused
from ..ops.recon import build_shift_indices, recon_onehot
from ..ops.recon_cuda import recon


def shg_forward(frames: torch.Tensor, ind_l: torch.Tensor,
                left_w: torch.Tensor) -> Step:
    """frames (F, ih, iw) u16, ind_l (S, ih) i32, left_w (ih,) f32
    -> (mean u16 (ih, iw), max u16 (ih, iw), disks u16 (S, ih, F)).

    On CUDA this always launches kernel B1, for every S; on the CPU it takes
    B1's plain version.  The JAX package crosses over to its one-hot matmul
    at large S (solex_ser_recon_en_tpu/models/shg.py:55-65) because the
    TPU's mask contraction costs O(S * iw) per tile; two indexed loads per
    output do not, so there is no second route to pick.  Kernel B6 (the
    tensor-core extraction, ``shg_fused(..., mxu=True)``) is never selected
    here, as the JAX package never selects its MXU kernel on its own.
    """
    return shg_fused(frames, ind_l, left_w)


def shg_forward_plain(frames: torch.Tensor, ind_l: torch.Tensor,
                      left_w: torch.Tensor) -> Step:
    """The two-pass gather route: separate torch reductions, then the
    two-tap gather-lerp recon (kernel B3 on the card, its plain version on
    the CPU) — the JAX package's reductions plus ``_recon_gather``."""
    mean, mx = mean_max_plain(frames)
    return mean, mx, recon(frames, ind_l, left_w, False, False)


def shg_forward_onehot(frames: torch.Tensor, ind_l: torch.Tensor,
                       left_w: torch.Tensor) -> Step:
    """Counterpart of ``shg_forward_xla`` (solex_ser_recon_en_tpu/models/
    shg.py:22-34), PyTorch's own kernels throughout: the torch reductions
    of ``mean_max_plain``, then the one-hot float32 matmul recon
    (ops/recon.py:recon_onehot).  No hand-written kernel runs in it, so the
    shoot-out can set the fused steps against it."""
    mean, mx = mean_max_plain(frames)
    return mean, mx, recon_onehot(frames, ind_l, left_w)


def example_inputs(
    F: int = 64, ih: int = 256, iw: int = 128, S: int = 2, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random frames and a gently sloped line's shift indices (numpy copy
    of solex_ser_recon_en_tpu/models/shg.py:example_inputs)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 65536, size=(F, ih, iw), dtype=np.uint16)
    curve = iw / 2 + 0.01 * np.arange(ih)
    floor = np.floor(curve).astype(np.int64)
    frac = curve - floor
    ind_l, left_w = build_shift_indices(floor, frac, list(range(S)), iw)
    return frames, ind_l, left_w
