"""Multi-shift disk reconstruction — indices and the plain gather-lerp.

reference: solex_util.py:93-144 — for every frame f and shift s,

    out[s][y, f] = img_f[y, l] * w(y) + img_f[y, l+1] * (1 - w(y))
    l(s, y) = clip(floor(curve(y)) + shift_s, 0, iw-2)

``recon_plain`` is the plain PyTorch version of kernel B3
(csrc/recon.cu, wrapped by ops/recon_cuda.py): the gather-lerp of
solex_ser_recon_en_tpu/ops/recon.py:_recon_gather on the RAW SER layout,
with the rot90 and the 8-bit x256 upscale taken into the indexing exactly
as solex_ser_recon_en_tpu/ops/fused.py:_recon_raw_lerp does.

``reconstruct`` is the counterpart of
solex_ser_recon_en_tpu/ops/recon.py:reconstruct, the recon of normalised
frames held in memory (the spectral analyser's): kernel B3 with
``rotate=False`` on a CUDA tensor.

``recon_onehot`` is the counterpart of
solex_ser_recon_en_tpu/ops/recon.py:_recon_onehot: the recon as one
float32 matrix product batched over rows, which the JAX package leaves to
XLA and this package to ``torch.bmm``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dtypes import as_int16, to_u16, widen


def build_shift_indices(
    fit_floor: np.ndarray, fit_frac: np.ndarray, shifts, iw: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-shift left-neighbour columns and left weights.

    reference: solex_util.py:113-123 — indices clipped to [0, iw-2]; the
    left weight is 1-frac and does NOT depend on the shift.

    Returns (ind_l (S, ih) int32, left_w (ih,) float32).
    """
    shifts = np.asarray(shifts, dtype=np.int64)
    ind_l = fit_floor.astype(np.int64)[None, :] + shifts[:, None]
    ind_l = np.clip(ind_l, 0, iw - 2).astype(np.int32)
    left_w = (1.0 - np.asarray(fit_frac)).astype(np.float32)
    return ind_l, left_w


def recon_plain(raw: torch.Tensor, ind_l: torch.Tensor, left_w: torch.Tensor,
                rotate: bool, upscale: bool) -> torch.Tensor:
    """raw (F, H, W) u16/u8, ind_l (S, ih) i32, left_w (ih,) f32 ->
    disks (S, ih, F) u16 in normalised orientation.

    norm[f, y, x] = raw[f, x, W-1-y] when ``rotate``; only the two taps of
    every (s, y) are gathered, never the whole slab.  ``ind_l`` is clipped
    to [0, iw-2] as build_shift_indices does, so both taps are in range.
    """
    F, H, W = raw.shape
    ih = ind_l.shape[1]
    iw = H if rotate else W
    src = as_int16(raw)
    ys = torch.arange(ih, device=raw.device)
    l = ind_l.long().clamp(0, iw - 2)
    if rotate:
        col = W - 1 - ys
        g0, g1 = src[:, l, col], src[:, l + 1, col]        # (F, S, ih)
    else:
        g0, g1 = src[:, ys, l], src[:, ys, l + 1]
    g0 = widen(g0.view(raw.dtype)).to(torch.float32)
    g1 = widen(g1.view(raw.dtype)).to(torch.float32)
    if upscale:
        g0 = g0 * 256.0
        g1 = g1 * 256.0
    w = left_w
    out = w * g0 + (1.0 - w) * g1                          # (F, S, ih)
    out = to_u16(out.clamp(0, 65535))
    return out.permute(1, 2, 0).contiguous()               # (S, ih, F)


def recon_chunks_plain(chunks, ind_l: torch.Tensor, left_w: torch.Tensor,
                       rotate: bool, upscale: bool,
                       out: Optional[torch.Tensor] = None,
                       frame_offset: int = 0) -> torch.Tensor:
    """Plain version of kernel B3's launch over several raw chunks:
    ``recon_plain`` of the chunks' frames in order, written into ``out``
    (S, ih, F_out) u16 at frames [frame_offset, frame_offset + F) — or
    returned as a new (S, ih, F) tensor when ``out`` is None."""
    disks = recon_plain(torch.cat([as_int16(c) for c in chunks]).view(
        chunks[0].dtype), ind_l, left_w, rotate, upscale)
    if out is None:
        return disks
    F = disks.shape[2]
    as_int16(out)[:, :, frame_offset:frame_offset + F] = as_int16(disks)
    return out


def onehot_weights(ind_l: torch.Tensor, left_w: torch.Tensor,
                   iw: int) -> torch.Tensor:
    """The recon's weights as a (ih, S, iw) float32 matrix per row:
    w[y] at x = l(s, y), 1 - w[y] at x = l(s, y) + 1, else 0."""
    cols = torch.arange(iw, device=ind_l.device)
    l = ind_l.t().long()[:, :, None]                        # (ih, S, 1)
    w = left_w[:, None, None]                               # (ih, 1, 1)
    return (torch.where(cols == l, w, 0.0)
            + torch.where(cols == l + 1, 1.0 - w, 0.0))


def recon_onehot(frames: torch.Tensor, ind_l: torch.Tensor,
                 left_w: torch.Tensor, out_u16: bool = True,
                 split_invariant: bool = False) -> torch.Tensor:
    """frames (F, ih, iw) u16 normalised, ind_l (S, ih) i32, left_w (ih,)
    f32 -> disks (S, ih, F) u16 (``out_u16``) or the unclipped float32
    sums (S, ih, F) (the mesh's batched step warps those), as one
    row-batched float32 matmul:

        W[y, s, x] = w[y]·1[x = l(s, y)] + (1 - w[y])·1[x = l(s, y) + 1]
        out[y, s, f] = sum_x W[y, s, x] · frames[f, y, x]

    It makes a float32 copy of the slab.  TF32 is switched off for the
    call only, the counterpart of JAX's per-operation Precision.HIGHEST:
    TF32 keeps 10 mantissa bits, which would break the 1-LSB disk
    contract.  The caller's float32 matmul precision and TF32 flag are
    restored afterwards.

    ``split_invariant`` (the mesh's recons, parallel/mesh.py): the float32
    matmul's result depends on its shape (the library picks another kernel
    for a few frames, 1 ulp apart), so a frame-sharded recon would not
    equal the whole one.  This contracts in float64 instead, where each
    product of a float32 weight and a u16 value is exact, so the sum of
    a row's two non-zero products does not depend on the order or the
    blocking of the matmul; it is then rounded to float32.
    """
    dtype = torch.float64 if split_invariant else torch.float32
    W = onehot_weights(ind_l, left_w, frames.shape[2]).to(dtype)
    x = widen(frames).to(dtype).permute(1, 2, 0)            # (ih, iw, F)
    precision = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        if (torch.get_float32_matmul_precision() != "highest"
                or torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError(
                "recon_onehot: float32 matmuls would run in TF32")
        out = torch.bmm(W, x).to(torch.float32)             # (ih, S, F)
    finally:
        # the flag first: setting it moves the precision, which the second
        # call then puts back
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)
    out = out.permute(1, 0, 2)                              # (S, ih, F)
    if not out_u16:
        return out.contiguous()
    return to_u16(out.clamp(0, 65535)).contiguous()


def reconstruct(frames, fit_floor: np.ndarray, fit_frac: np.ndarray,
                shifts) -> torch.Tensor:
    """Disks (S, ih, F) u16 of normalised frames held in memory, for every
    shift: the frames-in-memory recon of the spectral analyser.

    Counterpart of solex_ser_recon_en_tpu/ops/recon.py:reconstruct.
    frames: (F, ih, iw) u16 tensor (a numpy array is taken as a CPU
    tensor); fit_floor/fit_frac: (ih,) line fit.  A CUDA tensor launches
    kernel B3 (ops/recon_cuda.py:recon_chunks, the counterpart of the
    Pallas recon) over the frames as one chunk, ``rotate=False``; a CPU
    tensor takes its plain version.

    The JAX function's ``kernel`` choice (its XLA "gather" and "onehot"
    recons stand beside the Pallas one) and ``out_u16=False`` are not
    ported here: no caller of the port needs them (the mesh's float disks
    come from ``recon_onehot``).
    """
    from .recon_cuda import recon_chunks

    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(frames)
    ind_l, left_w = build_shift_indices(fit_floor, fit_frac, shifts,
                                        frames.shape[2])
    ind_l = torch.from_numpy(ind_l).to(frames.device)
    left_w = torch.from_numpy(left_w).to(frames.device)
    return recon_chunks([frames], ind_l, left_w, False, False)
