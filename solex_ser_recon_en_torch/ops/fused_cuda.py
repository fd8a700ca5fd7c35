"""The fused single-pass step on the card: wrappers of kernels B1
(csrc/fused.cu) and B6 (csrc/fused_mxu.cu), and of pass A's sum/max kernel
(csrc/sum_max.cu).

Counterpart of solex_ser_recon_en_tpu/ops/fused_pallas.py:shg_fused_pallas.
One read of the normalised frame slab gives the int32 frame sum, the frame
max and the multi-shift disks.  ``shg_fused`` runs B1, the counterpart of
the VPU kernels _kernel_win and _kernel (which are bit-identical; B1 folds
both): a two-tap gather-lerp in float32.  ``shg_fused(..., mxu=True)`` runs
B6, the counterpart of the MXU kernel _kernel_mxu: the disks as one
contraction over the spectral axis on the FP64 tensor cores.  A CUDA tensor
launches the kernel; a CPU tensor takes the plain version
(``shg_fused_plain``, ``shg_fused_mxu_plain``); any other device raises.

``sum_max`` and ``mean_max`` are pass A: the int32 frame sum and the frame
max of u8 or u16 frames in any layout, from one read of them (the ring and
the sum/max consumer that B1 and B6 use, with no shifts).  The JAX package
leaves these reductions to XLA (solex_ser_recon_en_tpu/ops/fused.py:33-34);
``mean_max`` also stands for its frames-in-memory reduction
(solex_ser_recon_en_tpu/ops/reduce.py), which the spectral analyser runs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build
from .dtypes import as_int16, to_u16, widen
from .recon import recon_plain

#: int32 sum bound: 65535 * 32767 < 2**31 (ops/fused_pallas.py:21)
MAX_FRAMES = 32767
#: longer stacks spill the int32 sum into an int64 fold every 2**15 frames
#: (65535 * 2**15 < 2**31; solex_ser_recon_en_tpu/ops/reduce.py)
SPILL_FRAMES = 1 << 15
#: B6 holds whole rows of 8 frames in shared memory: rows up to 3072
#: columns (csrc/fused_mxu.cu)
MXU_MAX_IW = 3072

Step = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(frames: torch.Tensor, ind_l: torch.Tensor,
           left_w: torch.Tensor, name: str = "shg_fused") -> None:
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {frames.device}")
    if frames.ndim != 3 or frames.dtype != torch.uint16:
        raise TypeError(f"{name}: frames must be (F, ih, iw) uint16, got "
                        f"{tuple(frames.shape)} {frames.dtype}")
    F, ih, iw = frames.shape
    if ind_l.ndim != 2 or ind_l.dtype != torch.int32 or ind_l.shape[1] != ih:
        raise TypeError(f"{name}: ind_l must be (S, {ih}) int32, got "
                        f"{tuple(ind_l.shape)} {ind_l.dtype}")
    if left_w.dtype != torch.float32 or tuple(left_w.shape) != (ih,):
        raise TypeError(f"{name}: left_w must be ({ih},) float32, got "
                        f"{tuple(left_w.shape)} {left_w.dtype}")
    for arg, t in (("frames", frames), ("ind_l", ind_l), ("left_w", left_w)):
        if t.device != frames.device or not t.is_contiguous():
            raise ValueError(
                f"{name}: {arg} must be contiguous on {frames.device}")
    S = ind_l.shape[0]
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"{name}: F={F} outside [1, {MAX_FRAMES}] "
                         "(the int32 frame sum would overflow)")
    if not 1 <= S <= 65535 or not 1 <= ih <= 65535 or iw < 2:
        raise ValueError(f"{name}: S={S}, ih={ih}, iw={iw} out of range")


def mean_max_plain(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (F, ih, iw) u16 -> (mean u16, max u16): int32 sum floor-divided
    by F (the reference's truncating mean), and the max."""
    v = widen(frames)
    total = v.sum(dim=0, dtype=torch.int32)
    return to_u16(total // frames.shape[0]), to_u16(v.amax(dim=0))


def sum_max_plain(frames: torch.Tensor, total: torch.Tensor,
                  mx: torch.Tensor) -> None:
    """Plain version of ``sum_max``: an int32 copy of the frames, its sum
    added to ``total`` and its amax folded into ``mx``."""
    v = widen(frames)
    total += v.sum(dim=0, dtype=torch.int32)
    torch.maximum(mx, v.amax(dim=0), out=mx)


def _sum_max_check(frames: torch.Tensor, name: str) -> None:
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {frames.device}")
    if frames.ndim != 3 or frames.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"{name}: frames must be (F, h, w) uint8 or uint16, "
                        f"got {tuple(frames.shape)} {frames.dtype}")
    if not frames.is_contiguous() or 0 in frames.shape:
        raise ValueError(f"{name}: frames must be contiguous and not empty")
    if frames.shape[0] > MAX_FRAMES:
        raise ValueError(f"{name}: F={frames.shape[0]} > {MAX_FRAMES} (the "
                         "int32 frame sum would overflow)")


#: pass A's launch geometry (csrc/sum_max.cu, csrc/ring.cuh; the ring's most
#: stages and barrier bytes are B1's, below): a block's run is at most this
#: many bytes of a frame (16-byte chunks a thread x threads)
SUM_MAX_MAX_RUN = 16 * 4 * 256
#: the shortest run (bytes) the owned plan gives a block; a frame below
#: this many bytes a block slot takes the split plan
SUM_MAX_MIN_OWNED_RUN = 1024
SUM_MAX_MAX_K = 8
#: an owned plan's most frames a stage
SUM_MAX_OWNED_MAX_K = 16
SUM_MAX_STAGE_TARGET, SUM_MAX_RING_TARGET = 16 * 1024, 100 * 1024
#: an owned plan's stage, bytes (its ring within the split ring's memory)
SUM_MAX_OWNED_STAGE_TARGET = 64 * 1024
#: frames of a split plan's frame range come in multiples of this
SPLIT_FRAMES = 32

#: pass A's launches by plan ("owned": every block owns a run of pixels
#: over all frames of the launch, plain merge; "split": runs over frame
#: splits, atomic merge), as the kernel library reports them; reset by
#: callers that count a run
SUM_MAX_PLANS = {"owned": 0, "split": 0}


def _frames_per_block(tiles: int, slots: int, F: int) -> int:
    """csrc/ring.cuh:frames_per_block: frames a block takes (a multiple of
    SPLIT_FRAMES) so that the last wave is as full as it can be, then the
    split with fewer blocks."""
    nfb = -(-F // SPLIT_FRAMES)
    top = min(nfb, 4 * (-(-slots // tiles)))
    best, best_blocks, best_cap = SPLIT_FRAMES * nfb, 0, 1
    for sp in range(1, top + 1):
        fper = SPLIT_FRAMES * (-(-nfb // sp))
        blocks = tiles * (-(-F // fper))
        cap = -(-blocks // slots) * slots
        if sp == 1 or blocks * best_cap > best_blocks * cap:
            best, best_blocks, best_cap = fper, blocks, cap
    return best


def _sum_max_ring(granules: int, stage: int, max_k: int, cap: int):
    """csrc/sum_max.cu:size_ring: (K frames a stage, D stages, shared bytes
    a block) for runs of ``granules`` 16-byte granules, stages towards
    ``stage`` bytes of at most ``max_k`` frames, the ring within ``cap``
    bytes."""
    fst = 16 * granules + 16
    K = min(max_k, max(1, stage // fst))
    K = 1 << (K.bit_length() - 1)
    while K > 1 and 2 * K * fst > cap:
        K //= 2
    D = min(B1_MAX_D, max(2, cap // (K * fst)))
    return K, D, B1_BAR_BYTES + D * K * fst


def sum_max_plan(data_ptr: int, elem_bytes: int, F: int, npix: int,
                 sms: int, blocks_per_sm: int) -> dict:
    """csrc/sum_max.cu:make_plan in Python: pass A's launch plan for F
    frames of ``npix`` elements of ``elem_bytes`` at ``data_ptr`` on a card
    of ``sms`` SMs that holds ``blocks_per_sm`` blocks of the kernel at the
    split ring's shared memory: owned where every slot gets a run of
    SUM_MAX_MIN_OWNED_RUN bytes.  A dict: plan ("owned" or "split"), path
    ("bulk" or "element"), K frames a stage, D stages, base granules
    (16 bytes) of a block's run and rem runs that take one more, smem bytes
    a block, blocks across a frame, fper frames a block, grid.  The wrapper
    does not call it: tests hold it to the library's plan
    (``sum_max_plan_cuda``)."""
    frame_b = npix * elem_bytes
    G = -(-frame_b // 16)
    max_g = SUM_MAX_MAX_RUN // 16
    min_g = SUM_MAX_MIN_OWNED_RUN // 16
    slots = sms * blocks_per_sm
    base, rem = min(G, max_g), 0
    K, D, smem = _sum_max_ring(base, SUM_MAX_STAGE_TARGET, SUM_MAX_MAX_K,
                               SUM_MAX_RING_TARGET)
    blocks = -(-G // base)
    if G >= slots * min_g:
        plan = "owned"
        blocks = slots * (-(-G // (slots * max_g)))
        base, rem = divmod(G, blocks)
        K, D, _ = _sum_max_ring(base + (rem > 0), SUM_MAX_OWNED_STAGE_TARGET,
                                SUM_MAX_OWNED_MAX_K, smem - B1_BAR_BYTES)
        fper = F
    else:
        plan = "split"
        fper = _frames_per_block(blocks, slots, F)
    bulk = data_ptr % 16 == 0 and frame_b % 16 == 0
    return dict(plan=plan, path="bulk" if bulk else "element", K=K, D=D,
                base=base, rem=rem, smem=smem, blocks=blocks, fper=fper,
                grid=(blocks, -(-F // fper)))


def sum_max_plan_cuda(frames: torch.Tensor) -> dict:
    """The launch plan pass A's kernel would use on these CUDA frames (F, h,
    w), from the kernel library itself (csrc/sum_max.cu:
    solex_sum_max_plan): the keys of ``sum_max_plan`` plus blocks_per_sm
    and sms."""
    F = frames.shape[0]
    out = (ctypes.c_longlong * 12)()
    with torch.cuda.device(frames.device):
        rc = cuda_build.lib().solex_sum_max_plan(
            frames.data_ptr(), frames.element_size(), F,
            frames[0].numel(), out)
    cuda_build.check(rc, "sum_max_plan")
    v = list(out)
    return dict(plan="owned" if v[0] else "split",
                path="bulk" if v[1] else "element", K=v[2], D=v[3],
                base=v[4], rem=v[5], smem=v[6], blocks_per_sm=v[7], sms=v[8],
                blocks=v[9], fper=v[11], grid=(v[9], v[10]))


def sum_max(frames: torch.Tensor, total: torch.Tensor,
            mx: torch.Tensor) -> None:
    """Pass A over one chunk, accumulated in place: ``total += sum_f frames``
    and ``mx = max(mx, max_f frames)`` for frames (F, h, w) u8 or u16 in any
    layout and total, mx (h, w) int32 that the caller holds (zeroed before
    the first chunk).  CUDA tensors launch the sum/max kernel on the
    current stream, CPU tensors take ``sum_max_plain``.  The caller keeps
    the frames of all chunks within MAX_FRAMES, and every launch into one
    total/mx pair on one stream: the owned plan's merge is a plain load and
    store, ordered only by the stream.  Each launch adds one to
    ``SUM_MAX_PLANS`` under the plan the library took."""
    _sum_max_check(frames, "sum_max")
    for arg, t in (("total", total), ("mx", mx)):
        if (t.dtype != torch.int32 or t.shape != frames.shape[1:]
                or t.device != frames.device or not t.is_contiguous()):
            raise TypeError(f"sum_max: {arg} must be {tuple(frames.shape[1:])}"
                            f" int32, contiguous on {frames.device}")
    if frames.device.type == "cpu":
        sum_max_plain(frames, total, mx)
        return
    F, h, w = frames.shape
    owned = ctypes.c_int(0)
    with torch.cuda.device(frames.device):
        rc = cuda_build.lib().solex_sum_max(
            frames.data_ptr(), frames.element_size(), total.data_ptr(),
            mx.data_ptr(), F, h * w, cuda_build.stream_handle(frames.device),
            ctypes.byref(owned))
    cuda_build.check(rc, "sum_max")
    cuda_build.count_launch("sum_max")
    SUM_MAX_PLANS["owned" if owned.value else "split"] += 1


def mean_max(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (F, ih, iw) u8 or u16, any F -> (mean u16, max u16) on the
    frames' device: the reference's truncating mean of the exact frame
    sum (solex_util.py:174-188, a uint64 accumulation), and the max.

    Up to MAX_FRAMES frames this is ``mean_max_plain`` (one launch of the
    sum/max kernel on CUDA tensors).  Longer stacks spill the int32 sum
    into an int64 fold every SPILL_FRAMES frames, as
    solex_ser_recon_en_tpu/ops/reduce.py:MeanMaxAccumulator does, so any
    length is exact."""
    if frames.ndim == 3 and frames.shape[0] <= MAX_FRAMES:
        _sum_max_check(frames, "mean_max")
        if frames.device.type == "cpu":
            return mean_max_plain(frames)
    total = torch.zeros(frames.shape[1:], dtype=torch.int32,
                        device=frames.device)
    mx = torch.zeros_like(total)
    fold = None
    for start in range(0, frames.shape[0], SPILL_FRAMES):
        if start:
            fold = total.long() if fold is None else fold + total
            total.zero_()
        window = frames[start:start + SPILL_FRAMES]
        for a in range(0, window.shape[0], MAX_FRAMES):
            sum_max(window[a:a + MAX_FRAMES], total, mx)
    if fold is not None:
        total = fold + total
    return to_u16(total // frames.shape[0]), to_u16(mx)


def shg_fused_plain(frames: torch.Tensor, ind_l: torch.Tensor,
                    left_w: torch.Tensor) -> Step:
    """Plain version of kernel B1: int32 sum, amax and the two-tap
    gather-lerp of ops/recon.py:recon_plain on the normalised layout."""
    mean, mx = mean_max_plain(frames)
    return mean, mx, recon_plain(frames, ind_l, left_w, False, False)


def shg_fused_mxu_plain(frames: torch.Tensor, ind_l: torch.Tensor,
                        left_w: torch.Tensor) -> Step:
    """Plain version of kernel B6: int32 sum and amax, then the two taps
    gathered and combined in float64, ``a * w + b * f32(1 - w)`` (exact
    products, one rounding: what the FP64 contraction gives in any order),
    rounded to float32, clipped and truncated to u16.  A tap outside
    [0, iw) is absent (contributes 0), as in the TPU kernel's comb."""
    mean, mx = mean_max_plain(frames)
    F, ih, iw = frames.shape
    src = as_int16(frames)
    ys = torch.arange(ih, device=frames.device)
    l = ind_l.long()

    def tap(col):                                  # (F, S, ih) float64
        ok = (col >= 0) & (col < iw)
        v = widen(src[:, ys, col.clamp(0, iw - 1)].view(torch.uint16))
        return torch.where(ok, v, 0).to(torch.float64)

    w1 = (1.0 - left_w).to(torch.float64)          # 1 - w rounded in f32
    out = tap(l) * left_w.to(torch.float64) + tap(l + 1) * w1
    out = to_u16(out.to(torch.float32).clamp(0, 65535))
    return mean, mx, out.permute(1, 2, 0).contiguous()


#: kernel B1's launch geometry (csrc/fused.cu: kThreads, kChunks, ...)
B1_THREADS = 256
B1_MAX_RUN = 8 * 4 * B1_THREADS      # elements a block holds of a frame
B1_MAX_ROWS, B1_MAX_K, B1_MAX_D = 64, 8, 8
B1_STAGE_TARGET, B1_RING_TARGET = 16 * 1024, 72 * 1024
B1_MAX_SMEM = 232448                 # opt-in shared memory of a block
B1_BAR_BYTES = 8 * B1_MAX_D

#: B1 launches by copy path ("bulk": TMA bulk copies of whole runs;
#: "element": 16-byte cp.async granules); reset by callers that count a run
FUSED_PATHS = {"bulk": 0, "element": 0}


def _align16(n: int) -> int:
    return (n + 15) & ~15


def fused_plan(data_ptr: int, S: int, ih: int, iw: int):
    """csrc/fused.cu:make_plan in Python: kernel B1's copy path and ring
    for frames at ``data_ptr`` of shape (F, ih, iw) and S shifts, as a dict
    (path, yb rows a block owns, xw its columns, K frames a stage, D stages
    in the ring, fb frames a disk store, smem bytes a block), or None where
    even the smallest ring does not fit (the launch then fails)."""
    aligned = data_ptr % 16 == 0 and ih * iw % 8 == 0
    xw = B1_MAX_RUN - 1 if iw > B1_MAX_RUN else iw
    yb = 1
    if xw == iw:
        # a bulk-aligned run first, then the larger share of the threads'
        # 16-byte chunk slots used, then more rows
        best = None
        for rows in range(1, min(ih, B1_MAX_ROWS, B1_MAX_RUN // iw) + 1):
            n = rows * iw
            P = -(-n // (8 * B1_THREADS))
            b = aligned and n % 8 == 0
            if best is None or (b and not best[0]) or (
                    b == best[0] and n * best[2] >= best[1] * P):
                best, yb = (b, n, P), rows
    want_bulk = xw == iw and aligned and yb * iw % 8 == 0

    def run(rows):
        return xw + 1 if xw < iw else rows * iw

    def smem(rows, K, D, fb):
        return (B1_BAR_BYTES + D * K * (_align16(2 * run(rows)) + 16)
                + _align16(2 * S * rows * fb) + 4 * S * rows + 4 * rows)

    fst = _align16(2 * run(yb)) + 16
    K = min(B1_MAX_K, max(1, B1_STAGE_TARGET // fst))
    K = 1 << (K.bit_length() - 1)
    D = min(B1_MAX_D, max(2, B1_RING_TARGET // (K * fst)))
    fb = 32
    while smem(yb, K, D, fb) > B1_MAX_SMEM:
        if D > 2:
            D -= 1
        elif K > 1:
            K //= 2
        elif yb > 1:
            yb -= 1
            while yb > 1 and want_bulk and yb * iw % 8:
                yb -= 1
        elif fb > 8:
            fb //= 2
        else:
            return None
    bulk = xw == iw and aligned and yb * iw % 8 == 0
    return dict(path="bulk" if bulk else "element", yb=yb, xw=xw, K=K, D=D,
                fb=fb, smem=smem(yb, K, D, fb))


#: kernel B6's launch geometry (csrc/fused_mxu.cu); the ring's own limits
#: (barrier bytes, most stages, a block's shared memory) are B1's, above
B6_MAX_ROWS, B6_M = 8, 8             # rows a block owns; frames a stage
B6_STAGE_TARGET, B6_RING_TARGET = 20 * 1024, 60 * 1024


def mxu_frame_stride(n: int) -> int:
    """Bytes between two frames of a B6 stage that holds runs of n u16
    (csrc/fused_mxu.cu:frame_stride): 16 more than a multiple of 128."""
    return ((2 * n + 16 + 127) & ~127) + 16


def fused_mxu_plan(data_ptr: int, S: int, ih: int, iw: int):
    """csrc/fused_mxu.cu:make_plan in Python: kernel B6's copy path and ring
    for frames at ``data_ptr`` of shape (F, ih, iw), iw <= MXU_MAX_IW, and S
    shifts, as a dict (path, yb rows a block owns, D stages of 8 frames in
    the ring, fb frames a disk store, stride bytes between two frames of a
    stage, smem bytes a block), or None where even the smallest plan does
    not fit (several thousand shifts; the kernel library then refuses the
    launch).  The wrapper does not call it: tests and the smoke run hold it
    to the library's plan (``fused_mxu_plan_cuda``)."""
    aligned = data_ptr % 16 == 0 and ih * iw % 8 == 0
    nsg = -(-S // 8)
    # a bulk-aligned run first, then the longest run whose stage stays
    # within the target (the shortest, if none does)
    best, yb = None, 1
    for rows in range(1, min(ih, B6_MAX_ROWS, MXU_MAX_IW // iw) + 1):
        n = rows * iw
        b = aligned and n % 8 == 0
        key = n if B6_M * mxu_frame_stride(n) <= B6_STAGE_TARGET else -n
        if best is None or (b and not best[0]) or (b == best[0]
                                                   and key > best[1]):
            best, yb = (b, key), rows
    want_bulk = best[0]

    def smem(rows, D, fb):
        return (B1_BAR_BYTES + D * B6_M * mxu_frame_stride(rows * iw)
                + _align16(2 * S * rows * fb) + 16 * rows + 8 * rows * nsg
                + 32 * rows * nsg)

    D = min(B1_MAX_D, max(2, B6_RING_TARGET
                          // (B6_M * mxu_frame_stride(yb * iw))))
    fb = 32
    while smem(yb, D, fb) > B1_MAX_SMEM:
        if D > 2:
            D -= 1
        elif yb > 1:
            yb -= 1
            while yb > 1 and want_bulk and yb * iw % 8:
                yb -= 1
        elif fb > 8:
            fb //= 2
        else:
            return None
    bulk = aligned and yb * iw % 8 == 0
    return dict(path="bulk" if bulk else "element", yb=yb, D=D, fb=fb,
                stride=mxu_frame_stride(yb * iw), smem=smem(yb, D, fb))


def fused_mxu_plan_cuda(frames: torch.Tensor, S: int) -> dict:
    """The launch geometry kernel B6 would use on these CUDA frames, from
    the kernel library itself (csrc/fused_mxu.cu:solex_shg_fused_mxu_plan):
    the keys of ``fused_mxu_plan`` plus blocks_per_sm, grid and fper (frames
    a block)."""
    F, ih, iw = frames.shape
    out = (ctypes.c_int * 10)()
    with torch.cuda.device(frames.device):
        rc = cuda_build.lib().solex_shg_fused_mxu_plan(frames.data_ptr(), S,
                                                       F, ih, iw, out)
    cuda_build.check(rc, "shg_fused_mxu_plan")
    v = list(out)
    return dict(path="bulk" if v[0] else "element", yb=v[1], D=v[2], fb=v[3],
                stride=v[4], smem=v[5], blocks_per_sm=v[6],
                grid=tuple(v[7:9]), fper=v[9])


def fused_plan_cuda(frames: torch.Tensor, S: int) -> dict:
    """The launch geometry kernel B1 would use on these CUDA frames, from
    the kernel library itself (csrc/fused.cu:solex_shg_fused_plan): the
    keys of ``fused_plan`` plus blocks_per_sm, grid and fper (frames a
    block)."""
    F, ih, iw = frames.shape
    out = (ctypes.c_int * 12)()
    with torch.cuda.device(frames.device):
        rc = cuda_build.lib().solex_shg_fused_plan(frames.data_ptr(), S, F,
                                                   ih, iw, out)
    cuda_build.check(rc, "shg_fused_plan")
    v = list(out)
    return dict(path="bulk" if v[0] else "element", yb=v[1], xw=v[2],
                K=v[3], D=v[4], fb=v[5], smem=v[6], blocks_per_sm=v[7],
                grid=tuple(v[8:11]), fper=v[11])


def _launch(entry: str, frames: torch.Tensor, ind_l: torch.Tensor,
            left_w: torch.Tensor) -> Step:
    F, ih, iw = frames.shape
    S = ind_l.shape[0]
    dev = frames.device
    total = torch.empty((ih, iw), dtype=torch.int32, device=dev)
    mx = torch.empty((ih, iw), dtype=torch.int32, device=dev)
    disks = torch.empty((S, ih, F), dtype=torch.uint16, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(cuda_build.lib(), "solex_" + entry)(
            frames.data_ptr(), ind_l.data_ptr(), left_w.data_ptr(),
            total.data_ptr(), mx.data_ptr(), disks.data_ptr(), S, F, ih, iw,
            cuda_build.stream_handle(dev),
        )
    cuda_build.check(rc, entry)
    cuda_build.count_launch(entry)
    # as in the JAX package, the mean division and the u16 casts sit
    # outside the kernel (ops/fused_pallas.py:232-233, :290-291)
    return to_u16(total // F), to_u16(mx), disks


def shg_fused_mxu(frames: torch.Tensor, ind_l: torch.Tensor,
                  left_w: torch.Tensor) -> Step:
    """Kernel B6 on CUDA tensors, ``shg_fused_mxu_plain`` on CPU tensors;
    the contract of ``shg_fused``, for iw <= MXU_MAX_IW.  On the card the
    shift count is bounded by the block's shared memory (its staging tile
    and tap columns grow with S): past several thousand shifts the kernel
    library refuses the launch (cudaErrorInvalidValue, raised by
    ``cuda_build.check``); ``fused_mxu_plan`` says whether a plan exists."""
    _check(frames, ind_l, left_w, "shg_fused_mxu")
    F, ih, iw = frames.shape
    if iw > MXU_MAX_IW:
        raise ValueError(f"shg_fused_mxu: iw={iw} > {MXU_MAX_IW} (B6 holds "
                         "whole rows in shared memory)")
    if frames.device.type == "cpu":
        return shg_fused_mxu_plain(frames, ind_l, left_w)
    return _launch("shg_fused_mxu", frames, ind_l, left_w)


def shg_fused(frames: torch.Tensor, ind_l: torch.Tensor,
              left_w: torch.Tensor, mxu: bool = False) -> Step:
    """frames (F, ih, iw) u16, ind_l (S, ih) i32, left_w (ih,) f32
    -> (mean u16 (ih, iw), max u16 (ih, iw), disks u16 (S, ih, F)).

    The contract of solex_ser_recon_en_tpu/ops/fused_pallas.py:326-337:
    ``mxu`` selects kernel B6 (``shg_fused_mxu``), else kernel B1, whose
    tap columns are clipped to [0, iw-2] as build_shift_indices does.
    Each B1 launch adds one to ``FUSED_PATHS`` under its copy path.
    """
    if mxu:
        return shg_fused_mxu(frames, ind_l, left_w)
    _check(frames, ind_l, left_w)
    if frames.device.type == "cpu":
        return shg_fused_plain(frames, ind_l, left_w)
    F, ih, iw = frames.shape
    plan = fused_plan(frames.data_ptr(), ind_l.shape[0], ih, iw)
    out = _launch("shg_fused", frames, ind_l, left_w)
    FUSED_PATHS[plan["path"]] += 1
    return out
