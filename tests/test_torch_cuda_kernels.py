"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no interpret mode)
and skips elsewhere.  The file imports no jax, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: bit-identical — the kernels and their plain versions round
every float32 step the same way (no FMA, same order); B6's FP64
contraction and its plain version both form round_f64(a*w + b*(1-w)) from
exact products.  B6 against B1: mean and max equal, disks within 1 LSB
(float64 vs float32 sums of the same two products).  Pass A's sum/max
kernel: bit-identical (integer sums and maxima, exact in any order).  The
feed's chunks on the card and the PNG of an image that comes down in
bands: bit-identical to the plain feed's and the plain encoder's.
"""

import os

import numpy as np
import pytest
import torch

from solex_ser_recon_en_torch.geometry.ellipse import get_correction_matrix
from solex_ser_recon_en_torch.io.feeder import normalize_frames
from solex_ser_recon_en_torch.models.shg import shg_forward, shg_forward_plain
from solex_ser_recon_en_torch.ops import cuda_build
from solex_ser_recon_en_torch.ops.clahe import (
    _launch_hist,
    image_tile_histograms_plain,
    tile_histograms,
    tile_histograms_plain,
)
from solex_ser_recon_en_torch.ops.fused import RawScanProcessor
from solex_ser_recon_en_torch.ops.fused_cuda import (
    FUSED_PATHS,
    fused_mxu_plan,
    fused_mxu_plan_cuda,
    fused_plan,
    fused_plan_cuda,
    mean_max,
    mean_max_plain,
    shg_fused,
    shg_fused_mxu,
    shg_fused_mxu_plain,
    shg_fused_plain,
    sum_max,
    sum_max_plain,
    sum_max_plan,
    sum_max_plan_cuda,
)
from solex_ser_recon_en_torch.ops import fused_cuda
from solex_ser_recon_en_torch.ops.recon import (
    build_shift_indices,
    recon_chunks_plain,
    recon_plain,
)
from solex_ser_recon_en_torch.ops.recon_cuda import (
    RECON_MAX_CHUNKS,
    recon,
    recon_chunks,
)
from solex_ser_recon_en_torch.ops.warp_fast import (
    hresample,
    hresample_plain,
    warp_inputs,
)

from torch_parity import cuda_device, t  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("rotate,upscale", [(True, False), (False, False),
                                            (True, True), (False, True)])
def test_recon_kernel_matches_plain(rng, cuda_device, rotate, upscale):
    H, W = (24, 64) if rotate else (64, 24)
    raw = rng.integers(0, 256 if upscale else 65536, (70, H, W)).astype(
        np.uint8 if upscale else np.uint16)
    ih, iw = (W, H) if rotate else (H, W)
    curve = iw / 2 + 0.05 * np.arange(ih)
    floor = np.floor(curve)
    ind_l, left_w = build_shift_indices(floor, curve - floor, [-30, 0, 3],
                                        iw)
    args = (t(raw, cuda_device), t(ind_l, cuda_device),
            t(left_w, cuda_device), rotate, upscale)
    out = recon(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  recon_plain(*args).cpu().numpy())


def test_recon_clips_taps_like_plain(rng, cuda_device):
    """Tap columns outside [0, iw-2] are clipped (the kernel never reads
    outside the frame), exactly as the plain version does."""
    raw = rng.integers(0, 65536, (3, 8, 16)).astype(np.uint16)
    ind_l = np.array([np.arange(-4, 12)], dtype=np.int32)   # iw = 8
    left_w = np.linspace(0, 1, 16).astype(np.float32)
    args = (t(raw, cuda_device), t(ind_l, cuda_device),
            t(left_w, cuda_device), True, False)
    np.testing.assert_array_equal(recon(*args).cpu().numpy(),
                                  recon_plain(*args).cpu().numpy())


def test_hresample_kernel_matches_plain(rng, cuda_device):
    mat, _ = get_correction_matrix(0.15, 0.93)
    m3 = np.eye(3)
    m3[:2, :2] = mat
    m3 = m3 @ np.array([[1, 0, -13.4], [0, 1, 7.3], [0, 0, 1.0]])
    imgs = rng.integers(0, 65536, (2, 300, 257)).astype(np.uint16)
    f01 = t(imgs, cuda_device).to(torch.int32).to(torch.float32) / 65536.0
    args = warp_inputs(f01, m3, 310, 270, f01[:, 0, 0])
    out = hresample(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  hresample_plain(*args).cpu().numpy())


@pytest.mark.parametrize("hist_size", [65536, 256, 70000])
def test_hist_kernel_matches_plain(rng, cuda_device, hist_size):
    tiles = rng.integers(-1, hist_size + 3, (4, 300000)).astype(np.int32)
    tiles[0, :200000] = 7   # one hot bin: heavy atomic contention
    tt = t(tiles, cuda_device)
    out = tile_histograms(tt, hist_size)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        out.cpu().numpy(), tile_histograms_plain(tt, hist_size).cpu().numpy())


def _recon_args(rng, device, rotate, upscale, F, H, W, shifts=(-30, 0, 3)):
    raw = t(rng.integers(0, 256 if upscale else 65536, (F, H, W)).astype(
        np.uint8 if upscale else np.uint16), device)
    ih, iw = (W, H) if rotate else (H, W)
    curve = iw / 2 + 0.05 * np.arange(ih)
    floor = np.floor(curve)
    ind_l, left_w = build_shift_indices(floor, curve - floor, list(shifts),
                                        iw)
    return raw, t(ind_l, device), t(left_w, device)


def _check_recon_chunks(chunks, ind_l, left_w, rotate, upscale,
                        out=None, offset=0):
    before = cuda_build.LAUNCHES["recon"]
    got = recon_chunks(chunks, ind_l, left_w, rotate, upscale, out, offset)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["recon"] == before + 1
    want = recon_chunks_plain(chunks, ind_l, left_w, rotate, upscale)
    F = want.shape[2]
    np.testing.assert_array_equal(
        got[:, :, offset:offset + F].cpu().numpy(), want.cpu().numpy())
    return got


@pytest.mark.parametrize("rotate,upscale", [(True, False), (False, False),
                                            (True, True), (False, True)])
@pytest.mark.parametrize("C", [13, 32, 81])
def test_recon_chunks_kernel_matches_plain(rng, cuda_device, rotate,
                                           upscale, C):
    """One launch over uneven chunks (the last one short; frame tiles that
    straddle chunks) equals the plain version on their frames."""
    H, W = (24, 64) if rotate else (64, 24)
    raw, ind_l, left_w = _recon_args(rng, cuda_device, rotate, upscale,
                                     200, H, W)
    chunks = [raw[s:s + C].clone() for s in range(0, 200, C)]
    _check_recon_chunks(chunks, ind_l, left_w, rotate, upscale)


def test_recon_chunks_at_the_table_maximum(rng, cuda_device):
    """RECON_MAX_CHUNKS chunks in one launch (the library's table holds
    exactly that many), and one more is refused."""
    assert cuda_build.lib().solex_recon_max_chunks() == RECON_MAX_CHUNKS
    raw, ind_l, left_w = _recon_args(rng, cuda_device, True, False,
                                     2 * RECON_MAX_CHUNKS - 1, 16, 40)
    chunks = [raw[s:s + 2].clone() for s in range(0, raw.shape[0], 2)]
    assert len(chunks) == RECON_MAX_CHUNKS
    _check_recon_chunks(chunks, ind_l, left_w, True, False)
    with pytest.raises(ValueError, match="chunks, 1 to"):
        recon_chunks(chunks + chunks[:1], ind_l, left_w, True, False)


def test_recon_chunks_unaligned_view_into_out(rng, cuda_device):
    """Chunks that are contiguous views starting 2 bytes into their
    allocation, written at a frame offset of a larger disk tensor (the
    streaming path's launch); the frames around them stay untouched."""
    raw, ind_l, left_w = _recon_args(rng, cuda_device, True, False, 45, 24,
                                     64)
    chunks = []
    for s in range(0, 45, 20):
        c = raw[s:s + 20]
        flat = torch.empty(c.numel() + 1, dtype=torch.uint16,
                           device=cuda_device)
        view = flat[1:].view(c.shape)
        view.copy_(c)
        assert view.is_contiguous() and view.data_ptr() % 4 != 0
        chunks.append(view)
    out = torch.zeros((3, 64, 60), dtype=torch.uint16, device=cuda_device)
    got = _check_recon_chunks(chunks, ind_l, left_w, True, False, out, 7)
    assert got is out
    assert not out[:, :, :7].cpu().numpy().any()
    assert not out[:, :, 52:].cpu().numpy().any()


def test_resident_pass_b_is_one_launch(rng, cuda_device):
    """RawScanProcessor.reconstruct launches B3 once over the feeder's
    chunks, and equals reconstruct_streaming (one launch per chunk)."""
    raw, _, _ = _recon_args(rng, cuda_device, True, False, 100, 24, 64)
    p = RawScanProcessor(24, 64, True, False, cuda_device)
    for s in range(0, 100, 30):
        p.accumulate(s, raw[s:s + 30].clone())
    curve = 12 + 0.03 * np.arange(64)
    floor = np.floor(curve)
    before = cuda_build.LAUNCHES["recon"]
    resident = p.reconstruct(floor, curve - floor, [0, 4])
    assert cuda_build.LAUNCHES["recon"] == before + 1
    streamed = p.reconstruct_streaming(
        [(s, raw[s:s + 30].clone(), 0) for s in range(0, 100, 30)], floor,
        curve - floor, [0, 4])
    assert cuda_build.LAUNCHES["recon"] == before + 5
    np.testing.assert_array_equal(resident.cpu().numpy(),
                                  streamed.cpu().numpy())


@pytest.mark.parametrize("upscale", [False, True], ids=["u16", "u8"])
def test_live_view_pass_b_once_a_chunk(rng, cuda_device, upscale):
    """With the live view's hook (-d) RawScanProcessor.reconstruct
    launches B3 once a resident chunk, in frame order, into the same
    disks: bit-identical to its one launch without the hook.  The hook
    gets each chunk's columns of the disks on the card and its last raw
    frame turned as np.rot90 turns it."""
    raw, _, _ = _recon_args(rng, cuda_device, True, upscale, 100, 24, 64)
    curve = 12 + 0.03 * np.arange(64)
    floor = np.floor(curve)

    def processor():
        p = RawScanProcessor(24, 64, True, upscale, cuda_device)
        for s in range(0, 100, 30):
            p.accumulate(s, raw[s:s + 30].clone())
        return p

    before = cuda_build.LAUNCHES["recon"]
    whole = processor().reconstruct(floor, curve - floor, [0, 4])
    assert cuda_build.LAUNCHES["recon"] == before + 1
    seen = []

    def hook(columns, start, frame):
        assert columns.device == whole.device
        seen.append((start, columns.cpu().numpy(), frame.cpu().numpy()))

    live = processor().reconstruct(floor, curve - floor, [0, 4],
                                   progress=hook)
    assert cuda_build.LAUNCHES["recon"] == before + 5
    np.testing.assert_array_equal(live.cpu().numpy(), whole.cpu().numpy())
    host = raw.cpu().numpy()
    assert [s for s, _, _ in seen] == [0, 30, 60, 90]
    for start, cols, frame in seen:
        n = cols.shape[2]
        np.testing.assert_array_equal(
            cols, whole[:, :, start:start + n].cpu().numpy())
        np.testing.assert_array_equal(frame, np.rot90(host[start + n - 1]))


def _check_image_hist(img, ty, tx, hs):
    before = cuda_build.LAUNCHES["tile_hist"]
    got = _launch_hist(img, ty, tx, hs)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["tile_hist"] == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        image_tile_histograms_plain(img, ty, tx, hs).cpu().numpy())


def _on_card(img, device, aligned=True):
    """The image on the card, or a contiguous view of it whose rows start
    off the 8-byte grid (the 1-pixel-unit path)."""
    if aligned:
        return t(img, device)
    flat = torch.empty(img.size + 1, dtype=torch.uint8 if img.dtype ==
                       np.uint8 else torch.uint16, device=device)
    view = flat[1:].view(img.shape)
    view.copy_(t(img, device))
    assert view.data_ptr() % 8 != 0
    return view


@pytest.mark.parametrize("shape", [(300, 260), (301, 257)])   # even, odd
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("grid", [(2, 2), (8, 8)])
@pytest.mark.parametrize("aligned", [True, False])
def test_image_hist_kernel_matches_plain(rng, cuda_device, shape, dtype,
                                         grid, aligned):
    hs = 256 if dtype == np.uint8 else 65536
    img = rng.integers(0, hs, shape).astype(dtype)
    img[:200, :100] = 7                 # one hot bin: heavy contention
    img[-3:, -5:] = hs - 1              # the last bin, in the padding
    _check_image_hist(_on_card(img, cuda_device, aligned), *grid, hs)


# tiles that lie wholly in the reflected padding: (40, 25) and (25, 40) at
# 8x8 pad 7 columns or rows onto tiles of 4 (1-pixel units); (28, 28) at
# 8x8 and (40, 40) at 12x12 do the same where the rows allow 8-byte units
@pytest.mark.parametrize("shape,grid", [((40, 25), (8, 8)),
                                        ((25, 40), (8, 8)),
                                        ((28, 28), (8, 8)),
                                        ((40, 40), (12, 12))])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("aligned", [True, False])
def test_image_hist_kernel_tiles_in_padding(rng, cuda_device, shape, grid,
                                            dtype, aligned):
    hs = 256 if dtype == np.uint8 else 65536
    img = rng.integers(0, hs, shape).astype(dtype)
    _check_image_hist(_on_card(img, cuda_device, aligned), *grid, hs)


@pytest.mark.parametrize("grid", [(2, 2), (1, 1)])
def test_image_hist_kernel_bench_image(rng, cuda_device, grid):
    """The bench image's shape (2048 x 2204 u16, the -c path's two calls)
    with the grid sized from the card; a value that fills a whole block's
    slice (65535 counts in one 16-bit counter)."""
    img = rng.integers(0, 65536, (2048, 2204)).astype(np.uint16)
    img[:1000] = rng.integers(900, 1200, (1000, 2204))   # a piled-up sky
    img[1500:] = 40000                                    # one hot value
    _check_image_hist(t(img, cuda_device), *grid, 65536)


def test_feeder_pinned_upload_matches_file(tmp_path, rng, cuda_device):
    from solex_ser_recon_en_torch.io.ser import SerReader, write_ser
    from solex_ser_recon_en_torch.io.feeder import raw_device_chunks

    raw = rng.integers(0, 65536, (23, 16, 40)).astype(np.uint16)
    path = str(tmp_path / "raw.ser")
    write_ser(path, raw)
    it, _, _ = raw_device_chunks(SerReader(path), 4, cuda_device)
    chunks = [c for _, c, _ in it]
    assert all(c.device.type == "cuda" for c in chunks)
    got = np.concatenate([c.cpu().numpy() for c in chunks])
    np.testing.assert_array_equal(got, raw)


# (F, ih, iw, S): odd shapes; F not a multiple of the kernel's 32-frame
# split granule; rows wider than 2048 (iw = 2500: one row tile of 3 rows,
# ih * iw not a multiple of 8, so the element path); a shift count that
# shrinks the row tile (S = 121) and one that needs more than 48 KB of
# shared memory (S = 800); the narrowest frame (iw = 2); then the bench
# width on the bulk path: with a frame tail (F = 67), a row tail (ih = 70
# on 20-row tiles) and the S = 7 sweep; and rows wider than one block
# (iw > 8192: column chunks, element path)
B1_SHAPES = [(37, 100, 60, 3), (37, 100, 60, 1), (70, 13, 2500, 2),
             (40, 20, 300, 121), (33, 3, 300, 800), (5, 3, 2, 1),
             (64, 64, 300, 2), (67, 64, 300, 2), (67, 70, 300, 2),
             (64, 64, 300, 7), (9, 3, 9001, 2)]
#: the copy path each shape must take (aligned frames from torch)
B1_PATHS = {(64, 64, 300, 2): "bulk", (67, 64, 300, 2): "bulk",
            (67, 70, 300, 2): "bulk", (64, 64, 300, 7): "bulk",
            (70, 13, 2500, 2): "element", (5, 3, 2, 1): "element",
            (9, 3, 9001, 2): "element"}


def _b1_inputs(rng, device, F, ih, iw, S, frames=None):
    if frames is None:
        frames = t(rng.integers(0, 65536, (F, ih, iw)).astype(np.uint16),
                   device)
    ind_l = rng.integers(-3, iw + 3, (S, ih)).astype(np.int32)
    ind_l[0, : min(ih, 2)] = iw - 2            # taps at the last columns
    if iw > 2048 and ih >= 4:
        ind_l[0, 2:4] = (2046, 2047)
    max_run = fused_cuda.PLAN_LIMITS["b1_max_run"]
    if iw > max_run:                           # around a column-chunk edge
        ind_l[:2, 1] = (max_run - 2, max_run - 1)
    left_w = rng.random(ih).astype(np.float32)
    return frames, t(ind_l, device), t(left_w, device)


def _check_b1(args, path):
    before = cuda_build.LAUNCHES["shg_fused"]
    paths = dict(FUSED_PATHS)
    out = shg_fused(*args)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["shg_fused"] == before + 1
    assert FUSED_PATHS[path] == paths[path] + 1
    assert sum(FUSED_PATHS.values()) == sum(paths.values()) + 1
    for a, b in zip(out, shg_fused_plain(*args)):
        assert a.dtype == b.dtype == torch.uint16 and a.shape == b.shape
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("F,ih,iw,S", B1_SHAPES)
def test_fused_kernel_matches_plain(rng, cuda_device, F, ih, iw, S):
    args = _b1_inputs(rng, cuda_device, F, ih, iw, S)
    path = fused_plan(args[0].data_ptr(), S, ih, iw)["path"]
    assert path == B1_PATHS.get((F, ih, iw, S), path)
    _check_b1(args, path)


def test_fused_kernel_unaligned_view(rng, cuda_device):
    """A contiguous view whose data pointer is not 16-byte aligned takes
    the element path at a shape that otherwise takes the bulk path."""
    F, ih, iw, S = 64, 64, 300, 2
    flat = t(rng.integers(0, 65536, F * ih * iw + 1).astype(np.uint16),
             cuda_device)
    frames = flat[1:].view(F, ih, iw)
    assert frames.is_contiguous() and frames.data_ptr() % 16 != 0
    assert fused_plan(frames.data_ptr(), S, ih, iw)["path"] == "element"
    _check_b1(_b1_inputs(rng, cuda_device, F, ih, iw, S, frames), "element")


def test_fused_paths_count_the_library_path(rng, cuda_device):
    """A B1 launch counts FUSED_PATHS under the copy path the kernel
    library reports for its frames: bulk on an aligned slab, element on a
    view 2 bytes into it."""
    F, ih, iw, S = 64, 64, 300, 2
    flat = t(rng.integers(0, 65536, F * ih * iw + 1).astype(np.uint16),
             cuda_device)
    for frames, path in ((flat[:-1].view(F, ih, iw), "bulk"),
                         (flat[1:].view(F, ih, iw), "element")):
        assert fused_plan_cuda(frames, S)["path"] == path
        _check_b1(_b1_inputs(rng, cuda_device, F, ih, iw, S, frames), path)


@pytest.mark.parametrize("F,ih,iw,S", B1_SHAPES + [(2000, 2048, 300, 2),
                                                   (2000, 2048, 300, 7)])
def test_fused_plan_matches_kernel_library(cuda_device, F, ih, iw, S):
    """B1's plan from the host library (csrc/plans.cuh built by g++) is the
    one the kernel library (the same header built by nvcc) launches, on
    aligned and unaligned frames."""
    flat = torch.empty(F * ih * iw + 1, dtype=torch.uint16,
                       device=cuda_device)
    for off in (0, 1):
        frames = flat[off:off + F * ih * iw].view(F, ih, iw)
        got = fused_plan_cuda(frames, S)
        want = fused_plan(frames.data_ptr(), S, ih, iw)
        assert {k: got[k] for k in want} == want
        assert got["blocks_per_sm"] >= 1 and got["fper"] % 32 == 0
        nx, ny, nz = got["grid"]
        assert nx == -(-iw // got["xw"]) and ny == -(-ih // got["yb"])
        assert (nz - 1) * got["fper"] < F <= nz * got["fper"]


def test_fused_step_equals_two_pass(rng, cuda_device):
    """shg_forward (kernel B1) equals the two-pass route (torch reductions +
    kernel B3) bit for bit: the same lerp arithmetic."""
    raw = rng.integers(0, 65536, (45, 40, 130)).astype(np.uint16)
    frames = normalize_frames(t(raw, cuda_device), True, False)
    ih, iw = frames.shape[1:]
    curve = iw / 2 + 0.05 * np.arange(ih)
    floor = np.floor(curve)
    ind_l, left_w = build_shift_indices(floor, curve - floor, [10, 0, -7],
                                        iw)
    args = (frames, t(ind_l, cuda_device), t(left_w, cuda_device))
    for a, b in zip(shg_forward(*args), shg_forward_plain(*args)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    np.testing.assert_array_equal(
        frames.cpu().numpy(),
        normalize_frames(t(raw), True, False).numpy())


# (F, ih, iw, S): S = 1, 2, 7, 8, 9, 21 around the N = 8 shift tile; iw =
# 2, 5, 60, 300 (K not a multiple of 4) and 3072 (the widest row B6 takes,
# past 48 KB of shared memory); F not a multiple of the 8-frame M tile; odd
# ih.  Taps anywhere in [-3, iw + 3): out-of-range taps are absent.
B6_SHAPES = [(37, 101, 300, 1), (37, 101, 300, 2), (45, 33, 60, 7),
             (45, 33, 60, 8), (45, 33, 60, 9), (13, 7, 5, 21),
             (21, 9, 2, 2), (64, 64, 300, 21), (9, 5, 3072, 3)]


def _b6_inputs(rng, device, F, ih, iw, S, frames=None):
    if frames is None:
        frames = t(rng.integers(0, 65536, (F, ih, iw)).astype(np.uint16),
                   device)
    ind_l = rng.integers(-3, iw + 3, (S, ih)).astype(np.int32)
    ind_l[0, : min(ih, 2)] = iw - 2            # taps at the last columns
    left_w = rng.random(ih).astype(np.float32)
    return frames, t(ind_l, device), t(left_w, device)


def _check_b6(args):
    before = cuda_build.LAUNCHES["shg_fused_mxu"]
    out = shg_fused_mxu(*args)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["shg_fused_mxu"] == before + 1
    for a, b in zip(out, shg_fused_mxu_plain(*args)):
        assert a.dtype == b.dtype == torch.uint16 and a.shape == b.shape
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("F,ih,iw,S", B6_SHAPES)
def test_fused_mxu_kernel_matches_plain(rng, cuda_device, F, ih, iw, S):
    _check_b6(_b6_inputs(rng, cuda_device, F, ih, iw, S))


def test_fused_mxu_kernel_unaligned_view(rng, cuda_device):
    """A contiguous view whose data pointer is not 16-byte aligned takes
    the element path at a shape that otherwise takes the bulk path."""
    F, ih, iw, S = 64, 64, 300, 2
    flat = t(rng.integers(0, 65536, F * ih * iw + 1).astype(np.uint16),
             cuda_device)
    frames = flat[1:].view(F, ih, iw)
    assert frames.is_contiguous() and frames.data_ptr() % 16 != 0
    assert fused_mxu_plan(flat.data_ptr(), S, ih, iw)["path"] == "bulk"
    assert fused_mxu_plan(frames.data_ptr(), S, ih, iw)["path"] == "element"
    _check_b6(_b6_inputs(rng, cuda_device, F, ih, iw, S, frames))


# the last block's frames are not a multiple of the 8-frame stage (3 of 8
# frames in its last stage), and stage counts that are no multiple of the
# ring's depth: F = 67 in blocks of 32 frames (4 stages and 1 on a ring of
# 3); F = 171 on the bench rows (on an H100: blocks of 64 frames, 8 stages on
# a ring of 3, so the barriers' phases wrap, and a last block of 43 frames);
# a ring of 7 (iw = 60); and the element path (ih * iw not a multiple of 8)
@pytest.mark.parametrize("F,ih,iw,S", [(67, 64, 300, 2), (171, 2048, 300, 2),
                                       (203, 8200, 60, 9),
                                       (203, 2049, 300, 2)])
def test_fused_mxu_partial_last_stage(rng, cuda_device, F, ih, iw, S):
    args = _b6_inputs(rng, cuda_device, F, ih, iw, S)
    plan = fused_mxu_plan_cuda(args[0], S)
    fper, nz = plan["fper"], plan["grid"][1]
    stages = {-(-min(fper, F - z * fper) // 8) for z in range(nz)}
    assert (F - (nz - 1) * fper) % 8 != 0
    if iw == 300:
        assert any(c % plan["D"] for c in stages)
    if F == 171:
        assert any(c % plan["D"] and c > 2 * plan["D"] for c in stages)
    _check_b6(args)


@pytest.mark.parametrize("F,ih,iw,S", B6_SHAPES + [(2000, 2048, 300, 2),
                                                   (2000, 2048, 300, 7)])
def test_fused_mxu_plan_matches_kernel_library(cuda_device, F, ih, iw, S):
    """B6's plan from the host library (csrc/plans.cuh built by g++) is the
    one the kernel library (the same header built by nvcc) launches, on
    aligned and unaligned frames."""
    flat = torch.empty(F * ih * iw + 1, dtype=torch.uint16,
                       device=cuda_device)
    for off in (0, 1):
        frames = flat[off:off + F * ih * iw].view(F, ih, iw)
        got = fused_mxu_plan_cuda(frames, S)
        want = fused_mxu_plan(frames.data_ptr(), S, ih, iw)
        assert {k: got[k] for k in want} == want
        assert got["blocks_per_sm"] >= 1 and got["fper"] % 32 == 0
        ny, nz = got["grid"]
        assert ny == -(-ih // got["yb"])
        assert (nz - 1) * got["fper"] < F <= nz * got["fper"]
    if (F, ih, iw) == (2000, 2048, 300):
        assert want["path"] == "element" and got["blocks_per_sm"] >= 2
        assert fused_mxu_plan(flat.data_ptr(), S, ih, iw)["path"] == "bulk"


@pytest.mark.parametrize("shifts", [[10, 0], list(range(-10, 11, 3))])
def test_fused_mxu_against_b1(rng, cuda_device, shifts):
    """On a real line fit's indices (the windowed K path): B6 equals its
    plain version bit for bit, and B1 in mean and max, its disks within
    1 LSB of B1's."""
    frames = rng.integers(0, 65536, (70, 130, 300)).astype(np.uint16)
    curve = 150 + 0.03 * np.arange(130) - 1e-4 * np.arange(130) ** 2
    floor = np.floor(curve)
    ind_l, left_w = build_shift_indices(floor, curve - floor, shifts, 300)
    args = (t(frames, cuda_device), t(ind_l, cuda_device),
            t(left_w, cuda_device))
    m6, x6, d6 = shg_fused(*args, mxu=True)
    m1, x1, d1 = shg_fused(*args)
    for a, b in zip((m6, x6, d6), shg_fused_mxu_plain(*args)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    np.testing.assert_array_equal(m6.cpu().numpy(), m1.cpu().numpy())
    np.testing.assert_array_equal(x6.cpu().numpy(), x1.cpu().numpy())
    diff = (d6.cpu().numpy().astype(np.int64)
            - d1.cpu().numpy().astype(np.int64))
    assert np.abs(diff).max() <= 1


def _unaligned(arr, device):
    """A contiguous view of ``arr`` on the card that starts one element
    into its allocation."""
    flat = torch.empty(arr.size + 1, dtype=torch.uint8 if arr.dtype ==
                       np.uint8 else torch.uint16, device=device)
    view = flat[1:].view(arr.shape)
    view.copy_(t(arr, device))
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _check_sum_max(chunks):
    """sum_max over the chunks, one launch each into the same accumulators,
    equals torch's reductions over all their frames."""
    dev = chunks[0].device
    total = torch.zeros(chunks[0].shape[1:], dtype=torch.int32, device=dev)
    mx = torch.zeros_like(total)
    before = cuda_build.LAUNCHES["sum_max"]
    for c in chunks:
        sum_max(c, total, mx)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["sum_max"] == before + len(chunks)
    whole = torch.cat(chunks).to(torch.int32)
    if chunks[0].dtype == torch.uint16:
        whole &= 0xFFFF
    np.testing.assert_array_equal(total.cpu().numpy(),
                                  whole.sum(dim=0).cpu().numpy())
    np.testing.assert_array_equal(mx.cpu().numpy(),
                                  whole.amax(dim=0).cpu().numpy())


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("F,ih,iw,S", B1_SHAPES)
def test_sum_max_kernel_matches_plain(rng, cuda_device, F, ih, iw, S, dtype,
                                      aligned):
    """Pass A's kernel on B1's frame shapes (one run, several runs with a
    tail, frames of an odd byte count), u16 and u8, on the bulk path and,
    from a view one element into its allocation, the element path."""
    arr = rng.integers(0, np.iinfo(dtype).max + 1, (F, ih, iw)).astype(dtype)
    arr[F // 2, 0, :2] = np.iinfo(dtype).max
    frames = t(arr, cuda_device) if aligned else _unaligned(arr, cuda_device)
    _check_sum_max([frames])
    if dtype == np.uint16:
        for a, b in zip(mean_max(frames), mean_max_plain(frames)):
            assert a.dtype == b.dtype == torch.uint16
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_mean_max_spill_matches_exact_sum(rng, cuda_device, monkeypatch):
    """``mean_max`` past MAX_FRAMES: the int32 sum spilled into the int64
    fold at each window's edge (both shrunk here), bit-identical to the
    exact uint64 mean and to the CPU's spill."""
    from solex_ser_recon_en_torch.ops import fused_cuda

    monkeypatch.setattr(fused_cuda, "SPILL_FRAMES", 4)
    monkeypatch.setattr(fused_cuda, "MAX_FRAMES", 3)
    arr = rng.integers(60000, 65536, (23, 6, 5)).astype(np.uint16)
    mean, mx = mean_max(t(arr, cuda_device))
    exact = (arr.astype(np.uint64).sum(axis=0) / 23).astype(np.uint16)
    np.testing.assert_array_equal(mean.cpu().numpy(), exact)
    np.testing.assert_array_equal(mx.cpu().numpy(), arr.max(axis=0))
    for a, b in zip((mean, mx), mean_max(torch.from_numpy(arr))):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_sum_max_kernel_raw_chunks(rng, cuda_device, dtype):
    """A raw (81, 300, 2048) chunk as the feeder makes them, and the
    accumulation over several chunks, the last one short and saturated."""
    top = np.iinfo(dtype).max
    arr = rng.integers(0, top + 1, (81 + 81 + 56, 300, 2048)).astype(dtype)
    arr[162:, :7] = top
    frames = t(arr, cuda_device)
    _check_sum_max([frames[:81]])
    _check_sum_max([frames[:81], frames[81:162], frames[162:]])


def test_pass_a_accumulates_through_the_kernel(rng, cuda_device):
    """RawScanProcessor.accumulate launches the sum/max kernel once a chunk
    and gives the plain mean and max of the whole scan."""
    raw = rng.integers(0, 65536, (100, 24, 64)).astype(np.uint16)
    p = RawScanProcessor(24, 64, True, False, cuda_device)
    before = cuda_build.LAUNCHES["sum_max"]
    for s in range(0, 100, 30):
        p.accumulate(s, t(raw[s:s + 30], cuda_device))
    assert cuda_build.LAUNCHES["sum_max"] == before + 4
    mean, mx = p.mean_max()
    cpu = RawScanProcessor(24, 64, True, False, torch.device("cpu"))
    cpu.accumulate(0, t(raw))
    mean_c, mx_c = cpu.mean_max()
    np.testing.assert_array_equal(mean, mean_c)
    np.testing.assert_array_equal(mx, mx_c)


#: pass A's launches as -c makes them: (frames, frame shape, dtype, chunk
#: frames, pieces a chunk): the bench scan's 25 u16 chunks (24 x 81 + 56),
#: its 13 u8 chunks (12 x 163 + 44), a 4-shard mesh's pieces of 14-21
#: frames, a small-frame scan on the split plan
PASS_A_SEQUENCES = {
    "u16 -c": (2000, (300, 2048), torch.uint16, 81, 1),
    "u8 -c": (2000, (300, 2048), torch.uint8, 163, 1),
    "mesh pieces": (2000, (300, 2048), torch.uint16, 81, 4),
    "small split": (200, (448, 96), torch.uint16, 200, 1),
}


def _card_frames(F, shape, dtype, device, seed=20):
    """Random frames made on the card, frame F // 3 saturated in its first
    rows."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if dtype == torch.uint16:
        x = torch.randint(-32768, 32768, (F, *shape), generator=g,
                          dtype=torch.int16, device=device)
        x[F // 3, :3] = -1
        return x.view(torch.uint16)
    x = torch.randint(0, 256, (F, *shape), generator=g, dtype=torch.uint8,
                      device=device)
    x[F // 3, :3] = 255
    return x


@pytest.mark.parametrize("name,F,shape,dtype,aligned", [
    ("u16 chunk", 81, (300, 2048), torch.uint16, True),
    ("u16 tail", 56, (300, 2048), torch.uint16, True),
    ("u8 chunk", 163, (300, 2048), torch.uint8, True),
    ("u8 tail", 44, (300, 2048), torch.uint8, True),
    ("mesh piece", 14, (300, 2048), torch.uint16, True),
    ("slab", 2000, (2048, 300), torch.uint16, True),
    ("small", 200, (448, 96), torch.uint16, True),
    ("small u8", 200, (448, 96), torch.uint8, True),
    ("unaligned u16", 81, (300, 2048), torch.uint16, False),
    ("unaligned u8", 163, (300, 2048), torch.uint8, False),
    ("odd frame", 40, (9001, 3), torch.uint16, True),
])
def test_sum_max_plan_matches_kernel_library(cuda_device, name, F, shape,
                                             dtype, aligned):
    """Pass A's plan from the host library (csrc/plans.cuh built by g++) at
    the card's own slots is the one the kernel library (the same header
    built by nvcc) launches; the bench chunks and the resident slab take
    one full owned wave, small frames the split plan."""
    n = F * shape[0] * shape[1]
    buf = torch.empty(n + 1, dtype=dtype, device=cuda_device)
    frames = buf[:n] if aligned else buf[1:]
    frames = frames.view(F, *shape)
    got = sum_max_plan_cuda(frames)
    want = sum_max_plan(frames.data_ptr(), frames.element_size(), F,
                        shape[0] * shape[1], got["sms"], got["blocks_per_sm"])
    assert {k: got[k] for k in want} == want
    if shape == (300, 2048) or name == "slab":
        assert got["plan"] == "owned"
        assert got["grid"] == (got["sms"] * got["blocks_per_sm"], 1)
    if name.startswith("small"):
        assert got["plan"] == "split"
    assert got["path"] == ("bulk" if aligned and name != "odd frame"
                           else "element")


@pytest.mark.parametrize("name", sorted(PASS_A_SEQUENCES))
def test_sum_max_sequences_match_plain(cuda_device, name):
    """``sum_max`` accumulated over -c's chunk sequences (each mesh piece
    into its shard's pair) equals ``sum_max_plain`` over the same launches
    bit for bit, and ``SUM_MAX_PLANS`` counts each launch under its plan."""
    F, shape, dtype, chunk, pieces = PASS_A_SEQUENCES[name]
    frames = _card_frames(F, shape, dtype, cuda_device)
    accs = [[torch.zeros(shape, dtype=torch.int32, device=cuda_device)
             for _ in range(4)] for _ in range(pieces)]
    for k in fused_cuda.SUM_MAX_PLANS:
        fused_cuda.SUM_MAX_PLANS[k] = 0
    launches = 0
    for a in range(0, F, chunk):
        c = frames[a:a + chunk]
        cuts = [c.shape[0] * k // pieces for k in range(pieces + 1)]
        for k in range(pieces):
            piece = c[cuts[k]:cuts[k + 1]]
            sum_max(piece, accs[k][0], accs[k][1])
            sum_max_plain(piece, accs[k][2], accs[k][3])
            launches += 1
    torch.cuda.synchronize()
    for s, m, ps, pm in accs:
        assert torch.equal(s, ps) and torch.equal(m, pm)
    plan = "split" if name == "small split" else "owned"
    assert fused_cuda.SUM_MAX_PLANS == {"owned": 0, "split": 0,
                                        plan: launches}
    assert launches == {"u16 -c": 25, "u8 -c": 13, "mesh pieces": 100,
                        "small split": 1}[name]


def test_sum_max_unaligned_slice_matches_plain(rng, cuda_device):
    """A bench-sized chunk one element into its allocation: the owned plan
    on the element path, accumulated over three launches."""
    arr = rng.integers(0, 65536, (3 * 27, 300, 2048)).astype(np.uint16)
    frames = _unaligned(arr, cuda_device)
    assert sum_max_plan_cuda(frames[:27])["plan"] == "owned"
    _check_sum_max([frames[:27], frames[27:54], frames[54:]])


# ---- the feed and the product download, on the card ------------------------


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("threads,ring", [(1, 3), (4, 3), (2, 4)])
def test_feed_on_the_card_equals_plain_feed_and_file(rng, cuda_device,
                                                     tmp_path, threads, ring,
                                                     depth):
    from solex_ser_recon_en_torch.io import feeder
    from solex_ser_recon_en_torch.io.ser import SerReader, write_ser

    frames = rng.integers(0, 256 if depth == 8 else 65536,
                          (50, 24, 40)).astype(np.uint8 if depth == 8
                                               else np.uint16)
    path = str(tmp_path / "s.ser")
    write_ser(path, frames)
    reader = SerReader(path)
    new, _, _ = feeder.raw_device_chunks(reader, 7, cuda_device,
                                         threads=threads, depth=ring)
    plain, _, _ = feeder.raw_device_chunks_plain(reader, 7, cuda_device)
    got, want = list(new), list(plain)
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == list(
        range(0, 50, 7))
    def host(c):
        c = c.cpu()
        return (c.view(torch.int16).numpy().view(np.uint16) if depth == 16
                else c.numpy())

    for (_, a, _), (_, b, _) in zip(got, want):
        assert a.is_cuda and a.dtype == b.dtype
        np.testing.assert_array_equal(host(a), host(b))
    np.testing.assert_array_equal(
        np.concatenate([host(c) for _, c, _ in got]), frames)
    assert feeder.FEED["chunks"] == 8 and feeder.FEED["h2d_ms"] > 0


def test_feeds_of_a_session_reuse_the_cached_chunks(rng, cuda_device,
                                                    tmp_path):
    """Each scan of a session feeds on the same upload stream, so the next
    scan's chunks take the blocks the last one freed: the allocator
    reserves no more after the first scan (with a stream a feed it
    reserved one scan more each time)."""
    from solex_ser_recon_en_torch.io import feeder
    from solex_ser_recon_en_torch.io.ser import SerReader, write_ser

    path = str(tmp_path / "s.ser")
    write_ser(path, rng.integers(0, 65536, (24, 256, 512)).astype(np.uint16))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = []
    for _ in range(3):
        it, _, _ = feeder.raw_device_chunks(SerReader(path), 8, cuda_device)
        chunks = [c for _, c, _ in it]
        assert len(chunks) == 3
        del chunks
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda_device))
    assert reserved[0] > 0 and reserved[1] == reserved[2] == reserved[0]


def test_feed_closed_early_on_the_card(rng, cuda_device, tmp_path):
    import threading

    from solex_ser_recon_en_torch.io import feeder, native
    from solex_ser_recon_en_torch.io.ser import SerReader, write_ser

    path = str(tmp_path / "s.ser")
    write_ser(path, rng.integers(0, 65536, (60, 8, 16)).astype(np.uint16))
    closed = native.CALLS["ser_close"]
    it, _, _ = feeder.raw_device_chunks(SerReader(path), 2, cuda_device)
    next(it)
    it.close()
    torch.cuda.synchronize()
    assert native.CALLS["ser_close"] == closed + 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("solex-torch-feed",
                                      "solex-torch-copy"))]


@pytest.mark.parametrize("shape,dtype", [((2048, 2204), np.uint16),
                                         ((5, 33), np.uint16),
                                         ((64, 100), np.uint8)])
def test_png_of_a_device_image_equals_plain(rng, cuda_device, tmp_path, shape,
                                            dtype):
    """The image comes down in bands into pinned memory and each band is
    encoded as it arrives: the same file as the plain encoder's."""
    from solex_ser_recon_en_torch.io import png
    from solex_ser_recon_en_torch.pipeline.products import _save_png_sync

    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    _save_png_sync(a, t(img, cuda_device))
    png.write_png_streaming_plain(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("shape", [(24, 40), (23, 37)])
def test_avi_feed_and_passes_on_the_card_equal_the_8bit_sers(
        rng, cuda_device, tmp_path, shape):
    """A Y800 AVI (RIFF/AVIX segments, planes not evenly spaced) and an
    8-bit SER of the same wide frames: the same u8 chunks on the card,
    then pass A's kernel and B3 give the same mean, max and disks, equal
    to the CPU's; 23 x 37 = 851 bytes a frame sends pass A to its
    granule copies."""
    import os
    import sys

    from solex_ser_recon_en_torch.io import feeder
    from solex_ser_recon_en_torch.io.ser import SerReader, write_ser
    from solex_ser_recon_en_torch.io.video import open_video

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import write_y800_avi

    frames = rng.integers(0, 256, (50, *shape)).astype(np.uint8)
    avi, ser = str(tmp_path / "s.avi"), str(tmp_path / "s.ser")
    write_y800_avi(avi, frames, segment_bytes=20 * (frames[0].size + 8) + 40)
    write_ser(ser, frames)
    assert open_video(avi)._stride is None

    def run(video, dev):
        it, rot, up = feeder.raw_device_chunks(video, 7, dev)
        proc = RawScanProcessor(shape[0], shape[1], rot, up, dev)
        chunks = []
        for start, c, _ in it:
            proc.accumulate(start, c)
            chunks.append(c.cpu())
        mean, mx = proc.mean_max()
        floor = np.full(shape[1], 3, np.int64)
        frac = np.linspace(0.1, 0.9, shape[1])
        disks = proc.reconstruct(floor, frac, [2, 0, -1]).cpu()
        return chunks, mean, mx, disks.view(torch.int16)

    a = run(open_video(avi), cuda_device)
    b = run(SerReader(ser), cuda_device)
    c = run(open_video(avi), torch.device("cpu"))
    for x in (b, c):
        assert len(a[0]) == len(x[0]) == 8
        assert all(torch.equal(p, q) for p, q in zip(a[0], x[0]))
        np.testing.assert_array_equal(a[1], x[1])
        np.testing.assert_array_equal(a[2], x[2])
        assert torch.equal(a[3], x[3])


def test_session_on_the_card_equals_per_file_runs(cuda_device, tmp_path):
    """Three same-shape small scans (two 16-bit, one a Y800 AVI of 8-bit
    frames) and a straggler: the session reads each file through read_scan
    beside the last one's post-processing, and every _clahe.png is the
    bytes of its file run alone; read_scans_batched, called directly,
    groups the three and gives each the disks of its own read_scan."""
    import os
    import sys

    from solex_ser_recon_en_torch.cli import main as cli
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.io.ser import write_ser
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
    from solex_ser_recon_en_torch.pipeline import batch
    from solex_ser_recon_en_torch.pipeline.run import read_scan

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import write_y800_avi

    folder = tmp_path / "in"
    folder.mkdir()
    kw = dict(ih=256, iw=96, depth=16, line_poly=(48.0, 0.02, -1e-4, 2e-7),
              noise=0.002)
    wide = np.rot90(SyntheticScan(frames=200, seed=1, **kw).generate(),
                    k=-1, axes=(1, 2))
    write_ser(str(folder / "a.ser"), wide)
    SyntheticScan(frames=200, seed=2, **kw).write(str(folder / "b.ser"),
                                                  transpose_to_wide=True)
    write_y800_avi(str(folder / "c.avi"),
                   np.ascontiguousarray((wide >> 8).astype(np.uint8)))
    SyntheticScan(frames=150, seed=3, **kw).write(str(folder / "x.ser"),
                                                  transpose_to_wide=True)
    read = []
    orig = cli.read_scan

    def spy(file, *a, **k):
        read.append(os.path.basename(file))
        return orig(file, *a, **k)

    session, alone = tmp_path / "session", tmp_path / "alone"
    cli.read_scan = spy
    try:
        assert cli.main(["-c", "--input-dir", str(folder), "--output-dir",
                         str(session)]) == 0
    finally:
        cli.read_scan = orig
    assert read == ["a.ser", "b.ser", "c.avi", "x.ser"]
    for name in ("a.ser", "b.ser", "c.avi", "x.ser"):
        assert cli.main(["-c", str(folder / name), "--output-dir",
                         str(alone)]) == 0
    names = sorted(p.name for p in session.iterdir() if p.suffix == ".png")
    assert len(names) == 4
    for name in names:
        assert (session / name).read_bytes() == (alone / name).read_bytes()

    opts = Options(shift=[0], clahe_only=True, output_dir=str(tmp_path))
    files = [str(folder / n) for n in ("a.ser", "b.ser", "c.avi", "x.ser")]
    got = batch.read_scans_batched([(f, opts.copy()) for f in files], {},
                                   cuda_device)
    assert sorted(got) == files[:3]
    for f in files[:3]:
        ref = read_scan(f, opts.copy(), cuda_device)
        assert torch.equal(got[f].disk_list.view(torch.int16),
                           ref.disk_list.view(torch.int16))


def test_session_counter_on_the_card(cuda_device, tmp_path):
    """Three distinct scans through handle_files, each post on the pool
    thread beside the next read: every product is the bytes of its file's
    own process_file run, and cli.main.SESSION counts the three."""
    from solex_ser_recon_en_torch.cli import main as cli
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
    from solex_ser_recon_en_torch.pipeline.run import process_file

    folder = tmp_path / "in"
    folder.mkdir()
    kw = dict(ih=256, iw=96, depth=16, line_poly=(48.0, 0.02, -1e-4, 2e-7),
              noise=0.002, frames=200)
    files = []
    for seed in (4, 5, 6):
        path = str(folder / f"s{seed}.ser")
        SyntheticScan(seed=seed, **kw).write(path, transpose_to_wide=True)
        files.append(path)
    session, alone = tmp_path / "session", tmp_path / "alone"
    session.mkdir()
    alone.mkdir()
    assert cli.handle_files(files, Options(
        shift=[0], clahe_only=True, output_dir=str(session)),
        cuda_device) == 3
    s = dict(cli.SESSION)
    assert s["scans"] == 3 and s["post_s"] > 0 and s["read_s"] > 0
    assert s["post_wait_s"] + s["tail_s"] <= s["post_s"] + s["queue_s"]
    for f in files:
        process_file(f, Options(shift=[0], clahe_only=True,
                                output_dir=str(alone)), cuda_device)
    names = sorted(p.name for p in session.glob("*.png"))
    assert len([n for n in names if n.endswith("_clahe.png")]) == 3
    assert names == sorted(p.name for p in alone.glob("*.png"))
    for name in names:
        assert (session / name).read_bytes() == (alone / name).read_bytes()


# ---- the band feed: kernel B3 on band chunks; the host feed launches none --


def _band_scan(tmp_path, wide=True, depth=16):
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan

    path = str(tmp_path / "band.ser")
    SyntheticScan(ih=320, iw=224, frames=150, depth=depth,
                  line_poly=(112.0, 0.02, -1e-4, 0.0), noise=0.002,
                  seed=5).write(path, transpose_to_wide=wide)
    return path


@pytest.mark.parametrize("wide,depth", [(True, 16), (False, 16), (True, 8)])
@pytest.mark.parametrize("slab", [False, True])
def test_recon_on_band_chunks_matches_plain(cuda_device, tmp_path, wide,
                                            depth, slab):
    """Kernel B3 over the band feed's chunks on the card (band-local taps,
    uploaded through the pinned ring) = its plain version on the same
    chunks on the CPU = B3 over the whole frames."""
    from solex_ser_recon_en_torch.geometry.linefit import fit_spectral_line
    from solex_ser_recon_en_torch.io import hostreduce as hr
    from solex_ser_recon_en_torch.io.feeder import (
        band_device_chunks,
        raw_device_chunks,
    )
    from solex_ser_recon_en_torch.io.ser import SerReader
    from solex_ser_recon_en_torch.ops.fused import reconstruct_band

    path = _band_scan(tmp_path, wide, depth)
    r = SerReader(path)
    mean, mx = hr.host_mean_max(r)
    lf = fit_spectral_line(mean, mx)
    shifts = [10, 0, -4]
    x0, x1 = hr.spectral_band(lf.floor, shifts, r.iw)
    band = hr.extract_band(r, x0, x1, 0, r.frame_count) if slab else None
    disks = {}
    for dev in (cuda_device, torch.device("cpu")):
        it, rotate, upscale = band_device_chunks(r, x0, x1, 32, dev,
                                                 slab=band)
        disks[dev.type] = reconstruct_band(
            it, lf.floor, lf.frac, shifts, r.iw, x0, rotate, upscale, dev,
            r.frame_count).cpu()
    torch.cuda.synchronize()
    it, rotate, upscale = raw_device_chunks(r, 32, cuda_device)
    p = RawScanProcessor(r.Height, r.Width, rotate, upscale, cuda_device)
    for start, c, _ in it:
        p.accumulate(start, c)
    full = p.reconstruct(lf.floor, lf.frac, shifts).cpu()
    for d in (disks["cpu"], full):
        assert torch.equal(disks["cuda"].view(torch.int16),
                           d.view(torch.int16))


def test_band_and_host_feeds_on_the_card(cuda_device, tmp_path):
    """``--feed band``: B3 launched, no pass-A launch, disks and
    _clahe.png equal the device feed's; ``--feed host``: no launch of pass
    A, B3, B4 or B5, and the disks are host tensors."""
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.pipeline import run

    path = _band_scan(tmp_path)
    scans = {}
    for feed in ("device", "band", "host"):
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0
        out = tmp_path / feed
        out.mkdir()
        opts = Options(shift=[0], clahe_only=True, feed_mode=feed,
                       output_dir=str(out))
        scans[feed] = run.read_scan(path, opts, cuda_device)
        run.process_scan(scans[feed], opts)
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        if feed == "band":
            assert launches["recon"] >= 1 and launches["sum_max"] == 0
        if feed == "host":
            assert all(launches[k] == 0 for k in
                       ("sum_max", "recon", "hresample", "tile_hist"))
    assert scans["host"].disk_list.device.type == "cpu"
    assert torch.equal(scans["band"].disk_list.view(torch.int16).cpu(),
                       scans["device"].disk_list.view(torch.int16).cpu())
    assert (tmp_path / "band" / "band_shift=0_clahe.png").read_bytes() == \
        (tmp_path / "device" / "band_shift=0_clahe.png").read_bytes()


@pytest.mark.parametrize("F", [37, 2000])
def test_recon_on_a_normalised_slab_matches_plain(rng, cuda_device, F):
    """Kernel B3 as the analyser launches it: the whole normalised (F, ih,
    iw) slab as one chunk, ``rotate=False``, S = 1 (ops/recon.py:
    reconstruct)."""
    from solex_ser_recon_en_torch.ops.recon import reconstruct

    frames = rng.integers(0, 65536, (F, 96, 40)).astype(np.uint16)
    curve = 17.3 + 0.04 * np.arange(96)
    floor = np.floor(curve)
    slab = t(frames, cuda_device)
    for shift in (10, 0, -20):
        for k in cuda_build.LAUNCHES:
            cuda_build.LAUNCHES[k] = 0
        out = reconstruct(slab, floor, curve - floor, [shift])
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["recon"] == 1
        want = reconstruct(slab.cpu(), floor, curve - floor, [shift])
        assert torch.equal(out.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("tiles", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(300, 260), (301, 257)])
def test_hist_kernel_u8_256_bins_by_tile_grid(rng, cuda_device, tiles, shape):
    """Kernel B5 as the CLAHE tool launches it on an 8-bit image: 256 bins,
    a square grid of 1-4 tiles, reflect padding where it does not divide
    the image; the tool's CLAHE on the card equal to the CPU's."""
    from solex_ser_recon_en_torch.ops.clahe import clahe

    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[:100, :80] = 3
    _check_image_hist(t(img, cuda_device), tiles, tiles, 256)
    got = clahe(t(img, cuda_device), 0.8, (tiles, tiles)).cpu().numpy()
    want = clahe(t(img), 0.8, (tiles, tiles)).numpy()
    np.testing.assert_array_equal(got, want)


def test_analyser_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """One upload, pass A once, B3 once for the fit and once a saved
    shift, B4 once and B5 twice a save; mean, max and disks equal the CPU
    analyser's."""
    from solex_ser_recon_en_torch.analyser import SpectralAnalyser
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan

    p = str(tmp_path / "an.ser")
    SyntheticScan(ih=360, iw=300, frames=220, depth=16,
                  line_poly=(150.0, 0.02, -1e-4, 0.0), disk_radius=100.0,
                  squash_y=1.08, noise=0.002, seed=4).write(
                      p, transpose_to_wide=True)
    for k in cuda_build.LAUNCHES:
        cuda_build.LAUNCHES[k] = 0
    a = SpectralAnalyser(p, device=cuda_device)
    torch.cuda.synchronize()
    assert a.transfer_count == 1
    assert cuda_build.LAUNCHES["sum_max"] == 1
    assert cuda_build.LAUNCHES["recon"] == 1
    c = SpectralAnalyser(p, device="cpu")
    np.testing.assert_array_equal(a.mean_img, c.mean_img)
    assert a.state.anchor_x == c.state.anchor_x
    for k in cuda_build.LAUNCHES:
        cuda_build.LAUNCHES[k] = 0
    cc, _ = a.save(0, str(tmp_path / "out"))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["recon"] == 1
    assert cuda_build.LAUNCHES["hresample"] == 1
    assert cuda_build.LAUNCHES["tile_hist"] == 2
    assert cc.is_cuda and a.transfer_count == 1
    for shift in (0, 10):
        assert torch.equal(a._recon_at(shift).cpu().view(torch.int16),
                           c._recon_at(shift).view(torch.int16))


# ---- kernels on another card than the current one; the mesh on the card ----


@pytest.fixture
def two_cards():
    """cuda:0 and cuda:1; skips with the reason where there are fewer
    cards (decided when the test runs)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a kernel launched for a tensor "
                    "on cuda:1 from a thread whose current card is cuda:0")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _on_card_one_cases(rng, dev):
    """(name, kernel call, plain call) of every kernel, inputs on ``dev``."""
    rotate, upscale = True, False
    raw, ind_l, left_w = _recon_args(rng, dev, rotate, upscale, 70, 24, 64)
    mat, _ = get_correction_matrix(0.15, 0.93)
    m3 = np.eye(3)
    m3[:2, :2] = mat
    imgs = rng.integers(0, 65536, (2, 300, 257)).astype(np.uint16)
    f01 = t(imgs, dev).to(torch.int32).to(torch.float32) / 65536.0
    w_args = warp_inputs(f01, m3, 310, 270, f01[:, 0, 0])
    img = t(rng.integers(0, 65536, (301, 257)).astype(np.uint16), dev)
    b1 = _b1_inputs(rng, dev, 40, 48, 300, 2)
    frames = t(rng.integers(0, 65536, (33, 24, 64)).astype(np.uint16), dev)

    def pass_a(fn):
        total = torch.zeros((24, 64), dtype=torch.int32, device=dev)
        mx = torch.zeros_like(total)
        fn(frames, total, mx)
        return total, mx

    from solex_ser_recon_en_torch.ops import rowstats
    from solex_ser_recon_en_torch.ops.clahe import clahe_levels
    from solex_ser_recon_en_torch.ops.fused_cuda import sum_max_plain
    from solex_ser_recon_en_torch.pipeline import products

    gain = t(rng.uniform(0.9, 1.1, 301).astype(np.float32), dev)

    def on_cpu(fn, *args):
        """The twin on CPU copies (the product chain's kernels equal it as
        it runs there), brought to ``dev``."""
        out = fn(*(a.cpu() for a in args))
        return tuple(o.to(dev) for o in (out if isinstance(out, tuple)
                                         else (out,)))

    def levels(x):
        return clahe_levels(x, 0.8, 2, 2, 65536)

    return [
        ("row_gain", lambda: rowstats.apply_row_gain(img, gain),
         lambda: on_cpu(rowstats.apply_row_gain, img, gain)),
        ("clahe_blend", lambda: levels(img), lambda: on_cpu(levels, img)),
        ("stretch", lambda: products._products_body(img),
         lambda: on_cpu(products._products_body, img)),
        ("recon", lambda: recon_chunks([raw], ind_l, left_w, rotate, upscale),
         lambda: recon_chunks_plain([raw], ind_l, left_w, rotate, upscale)),
        ("hresample", lambda: hresample(*w_args),
         lambda: hresample_plain(*w_args)),
        ("tile_hist", lambda: _launch_hist(img, 2, 2, 65536),
         lambda: image_tile_histograms_plain(img, 2, 2, 65536)),
        ("shg_fused", lambda: shg_fused(*b1), lambda: shg_fused_plain(*b1)),
        ("shg_fused_mxu", lambda: shg_fused_mxu(*b1),
         lambda: shg_fused_mxu_plain(*b1)),
        ("sum_max", lambda: pass_a(sum_max), lambda: pass_a(sum_max_plain)),
    ]


def test_kernels_launch_on_their_tensors_card(rng, two_cards):
    """Each kernel, for tensors on cuda:1, launched while cuda:0 is the
    thread's current card (B5 needs its 128 KB shared-memory attribute set
    on cuda:1 too): the output lies on cuda:1 and equals the plain
    version's; the current card stays cuda:0."""
    card0, card1 = two_cards
    torch.cuda.set_device(card0)
    before = dict(cuda_build.LAUNCHES)
    for name, kernel, plain in _on_card_one_cases(rng, card1):
        assert torch.cuda.current_device() == 0
        got = kernel()
        torch.cuda.synchronize(card1)
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.device == card1, name
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.uint16
                               else a, b.view(torch.int16)
                               if b.dtype == torch.uint16 else b), name
        assert cuda_build.LAUNCHES[name] > before[name], name
        assert torch.cuda.current_device() == 0


def _mesh_run(path, out, device, mesh=None):
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.pipeline.run import process_file

    opts = Options(shift=[0, 3], clahe_only=True, output_dir=str(out),
                   feed_mode="device", frame_chunk=64)
    process_file(path, opts, device, mesh=mesh)
    return (out / "m_shift=0_clahe.png").read_bytes()


def _mesh_scan(tmp_path):
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan

    p = str(tmp_path / "m.ser")
    SyntheticScan(ih=256, iw=96, frames=203, depth=16,
                  line_poly=(48.0, 0.02, -1e-4, 2e-7), noise=0.002,
                  seed=1).write(p, transpose_to_wide=True)
    return p


def test_frame_mesh_on_one_card_equals_no_mesh(cuda_device, tmp_path):
    """A 4-shard mesh over the one card repeated: pass A once a piece, B3
    once a shard, the same ``_clahe.png`` bytes."""
    from solex_ser_recon_en_torch.parallel.mesh import make_mesh

    p = _mesh_scan(tmp_path)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = _mesh_run(p, tmp_path / "a", cuda_device)
    for k in cuda_build.LAUNCHES:
        cuda_build.LAUNCHES[k] = 0
    got = _mesh_run(p, tmp_path / "b", cuda_device,
                    make_mesh({"frame": 4}, devices=[cuda_device] * 4))
    assert got == want
    assert cuda_build.LAUNCHES["recon"] == 4
    assert cuda_build.LAUNCHES["sum_max"] == 4 * 3 + 4   # 64, 64, 64, 11


def test_frame_mesh_on_distinct_cards_equals_one_card(two_cards, tmp_path):
    from solex_ser_recon_en_torch.parallel.mesh import mesh_from_options

    card0, _ = two_cards
    p = _mesh_scan(tmp_path)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = _mesh_run(p, tmp_path / "a", card0)
    mesh = mesh_from_options({"frame": 2}, card0)
    assert mesh.row(0) == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert _mesh_run(p, tmp_path / "b", card0, mesh) == want


# ---- the ellipse fit's small ops: the card equals the CPU -----------------
# (the Canny on the card is csrc/canny.cu, held bit for bit to the plain
# twin of ops/canny.py on the CPU; ops/blur.py:box_blur and the twin's
# float steps are plain torch ops that both devices round correctly; the CPU
# side is held to the JAX package in tests/test_torch_canny.py)


def _canny_kernel_vs_twin(img, sigma, low, high, device):
    """The kernel's magnitude (as int32 bits), sector and edge map on the
    card against the twin's on the CPU; returns the card's edge map."""
    from solex_ser_recon_en_torch.ops import canny

    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    mag_k, sec_k = canny.gradients(x.to(device), sigma)
    mag_t, sec_t = canny.gradients(x, sigma)
    assert torch.equal(mag_k.cpu().view(torch.int32), mag_t.view(torch.int32))
    assert torch.equal(sec_k.cpu(), sec_t)
    edges = canny.canny(x.to(device), sigma, low, high).cpu()
    assert torch.equal(edges, canny.canny(x, sigma, low, high))
    return edges


CANNY_THRESHOLDS = {"flooded": (0.05, 0.075), "graded": (650.0, 975.0)}


@pytest.mark.parametrize("shape", [(257, 256), (512, 500), (600, 560)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["flooded", "graded"])
def test_canny_on_the_card_equals_the_cpu(cuda_device, kind, shape):
    """The Canny's kernels (csrc/canny.cu) on the card against the twin on
    the CPU: magnitude bits, sector and edge map."""
    from torch_parity import flooded_ellipse, graded_ellipse

    make = flooded_ellipse if kind == "flooded" else graded_ellipse
    edges = _canny_kernel_vs_twin(make(*shape, 0), 2.0,
                                  *CANNY_THRESHOLDS[kind], cuda_device)
    assert edges.any()


def test_canny_float_steps_on_the_card_equal_the_cpu(rng, cuda_device):
    """atan2f and the once-rounded multiply-add on wide random inputs."""
    from solex_ser_recon_en_torch.ops import canny

    n = 200_000
    y, x, c = (torch.from_numpy((rng.standard_normal(n) * 10.0 ** rng.uniform(
        -4, 6, n)).astype(np.float32)) for _ in range(3))
    assert torch.equal(canny._atan2f(y.to(cuda_device),
                                     x.to(cuda_device)).cpu(),
                       canny._atan2f(y, x))
    assert torch.equal(canny._fma32(y.to(cuda_device), x.to(cuda_device),
                                    c.to(cuda_device)).cpu(),
                       canny._fma32(y, x, c))


@pytest.mark.parametrize("sigma", [1.5, 1.0, 0.5])
@pytest.mark.parametrize("kind", ["flooded", "graded"])
def test_canny_kernel_retry_sigmas_equal_the_twin(cuda_device, kind, sigma):
    """get_edge_list's retries: 13, 9 and 5 taps."""
    from torch_parity import flooded_ellipse, graded_ellipse

    make = flooded_ellipse if kind == "flooded" else graded_ellipse
    assert _canny_kernel_vs_twin(make(512, 500, 2), sigma,
                                 *CANNY_THRESHOLDS[kind], cuda_device).any()


def test_canny_kernel_where_the_twin_redoes_a_pass(cuda_device, monkeypatch):
    """The 0/65536 ellipse: the twin's float64 sums fall halfway and it
    redoes both blur passes; the kernel's fused multiply-adds agree."""
    from solex_ser_recon_en_torch.ops import canny

    from torch_parity import halfway_ellipse

    calls = []
    round_sum = canny._round_sum
    monkeypatch.setattr(canny, "_round_sum",
                        lambda p, c: calls.append(1) or round_sum(p, c))
    img = halfway_ellipse(300, 280, 5)
    assert _canny_kernel_vs_twin(img, 2.0, 0.05, 0.075, cuda_device).any()
    assert len(calls) >= 2 * 16


@pytest.mark.parametrize("shape", [(33, 65), (97, 130), (65, 64), (130, 31),
                                   (5, 3), (2, 2), (40, 7), (7, 40)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_canny_kernel_on_odd_shapes(cuda_device, shape):
    """Shapes that are no multiple of either kernel's tile, and shapes
    narrower than the blur's halo, down to the reflected border's least."""
    from torch_parity import graded_ellipse

    img = graded_ellipse(*shape, 3)
    img[:, shape[1] // 2:] += 20000.0
    _canny_kernel_vs_twin(img, 2.0, 650.0, 975.0, cuda_device)


@pytest.mark.parametrize("value", [0.0, 1.0, 100.0])
def test_canny_kernel_of_a_constant_image_has_no_edges(cuda_device, value):
    img = np.full((200, 190), value, dtype=np.float32)
    assert not _canny_kernel_vs_twin(img, 2.0, 0.05, 0.075,
                                     cuda_device).any()


def test_canny_kernel_hysteresis_follows_a_weak_snake(cuda_device):
    """A weak band winding over the image from one strong segment: the
    edge map is the twin's, it reaches the last band, and the tiles took
    several rounds; with the thresholds swapped, strong pixels below the
    low threshold seed their neighbours only."""
    from solex_ser_recon_en_torch.ops import canny

    from torch_parity import weak_snake

    img, (low, high), rows = weak_snake()
    canny.CANNY_ROUNDS.update(rounds=0, most=0)
    edges = _canny_kernel_vs_twin(img, 1.0, low, high, cuda_device)
    assert edges[rows[-1] - 3:rows[-1] + 8].any()
    assert canny.CANNY_ROUNDS["most"] >= 3, canny.CANNY_ROUNDS
    _canny_kernel_vs_twin(img, 1.0, high, low, cuda_device)


def test_canny_launches_count_the_kernel(cuda_device):
    """CANNY_LAUNCHES counts a card's call as ``kernel`` and CANNY_ROUNDS
    its rounds; a blur wider than the kernel's radius raises."""
    from solex_ser_recon_en_torch.ops import canny

    from torch_parity import flooded_ellipse

    img = torch.from_numpy(flooded_ellipse(512, 500, 0)).to(cuda_device)
    for k in canny.CANNY_LAUNCHES:
        canny.CANNY_LAUNCHES[k] = 0
    canny.CANNY_ROUNDS.update(rounds=0, most=0)
    canny.canny(img, 2.0, 0.05, 0.075)
    assert canny.CANNY_LAUNCHES == {"kernel": 1, "plain": 0}
    assert canny.CANNY_ROUNDS["rounds"] >= 1
    with pytest.raises(ValueError, match="taps"):
        canny.canny(img, 2.5)


@pytest.mark.parametrize("kx,ky", [(5, 5), (2, 2), (7, 3)])
def test_box_blur_on_the_card_equals_the_cpu(rng, cuda_device, kx, ky):
    """The ellipse fit's blurs of a downscaled disk (block means of u16 /
    65536): the card divides by a device tensor, not by a host scalar."""
    from solex_ser_recon_en_torch.ops.blur import box_blur

    img = torch.from_numpy((rng.integers(0, 16 * 65536, (128, 125))
                            / (16 * 65536.0)).astype(np.float32))
    assert torch.equal(box_blur(img.to(cuda_device), kx, ky).cpu(),
                       box_blur(img, kx, ky))


# ---- the transversalium row statistics (csrc/rowstats.cu) against the plain
# twin (ops/rowstats.py: strip_mask + row_log_ratio_stats) on the card.
# Chord bounds, medians, MADs and kept counts bit for bit; mean_all and
# mean_r (float32 sums in another order) within 1e-6 of the row's mean
# absolute log ratio over what was summed (or of the value, the larger).


def _row_stats_case(name):
    """(image, circle, borders) of one case: the bench frame (u16 and the
    de-vignetted float form), integer rows with ties, 0/0 (NaN), f/0
    (+inf), 0/f (-inf) and chords of 0, 1, 2, 3, ... pixels, float rows
    with -0.0 and negatives, borders that cut the chords, the backup
    geometry of pipeline/run.py, rows wider than the shared stage, a
    circle above the image."""
    from torch_parity import limb_darkened_disk

    rng = np.random.default_rng(ROW_STATS_CASES.index(name))
    if name in ("bench_u16", "bench_f32"):
        stripes = 1 + 0.02 * np.sin(np.arange(2048) / 3.0)[:, None]
        img = np.round(limb_darkened_disk(2048, 2204, 5) * stripes).astype(
            np.uint16)
        img[1000, 700:720] = 0              # 0/0 and 0/f inside the disk
        img[1201, 900:905] = 0
        if name == "bench_f32":
            img = img.astype(np.float32) * np.float32(1.0003)
            img[900, 800:810] = -0.0
        return img, (1101.7, 1023.4, 790.3), [0.0, 0.0, 2203.0, 2047.0]
    if name in ("ties_odd", "ties_even"):
        img = rng.integers(0, 4, (96, 128)).astype(np.uint16)
        img[10:13] = 0                      # rows of NaN: the median NaN
        img[20, ::2] = 0                    # half NaN
        img[30:33] = 1                      # rows of 0: the MAD 0
        cx = 64.5 if name == "ties_odd" else 64.0
        return img, (cx, 48.0, 40.0), [0.0, 0.0, 127.0, 95.0]
    if name == "float_specials":
        vals = np.array([-0.0, 0.0, 1.0, 2.0, 0.5, -1.0, 3.0],
                        dtype=np.float32)
        img = vals[rng.integers(0, len(vals), (40, 64))]
        return img, (31.0, 20.0, 18.0), [0.0, 0.0, 63.0, 39.0]
    if name == "cut_borders":
        img = limb_darkened_disk(256, 300, 9)
        return img, (150.0, 128.0, 110.0), [60.0, 40.5, 230.0, 200.0]
    if name == "backup":
        img = limb_darkened_disk(300, 340, 11)
        return img, (0.0, 0.0, 99999.0), [0.0, 30.0 + 20, 339.0, 270.0 - 20]
    if name == "wide":
        img = rng.integers(900, 1100, (10, 9000)).astype(np.uint16)
        return img, (4500.0, 5.0, 6000.0), [0.0, 0.0, 8999.0, 9.0]
    assert name == "above"
    img = limb_darkened_disk(64, 80, 13)
    return img, (40.0, -500.0, 100.0), [0.0, 0.0, 79.0, 63.0]


ROW_STATS_CASES = ["bench_u16", "bench_f32", "ties_odd", "ties_even",
                   "float_specials", "cut_borders", "backup", "wide", "above"]


def _same_bits(a, b):
    """Equal bit for bit, any NaN equal to any NaN."""
    a, b = a.cpu(), b.cpu()
    assert torch.equal(a.isnan(), b.isnan())
    keep = ~a.isnan()
    assert torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))


def _close_sums(got, want, scale):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])   # NaN == NaN here
    d = np.abs(got[fin].astype(np.float64) - want[fin])
    assert (d <= 1e-6 * np.maximum(np.abs(want[fin]), scale[fin])).all(), \
        d.max()


@pytest.mark.parametrize("name", ROW_STATS_CASES)
def test_row_stats_kernel_matches_the_plain_twin(cuda_device, name):
    from solex_ser_recon_en_torch.ops import rowstats
    from solex_ser_recon_en_torch.ops.dtypes import as_f32
    from solex_ser_recon_en_torch.pipeline.transversalium import (
        _strip_bounds_host,
    )

    img_np, circle, borders = _row_stats_case(name)
    img = t(img_np, cuda_device)
    h, w = img.shape
    valid, _, _ = rowstats.strip_mask(
        h, w, np.asarray(circle, dtype=np.float32),
        np.asarray(borders, dtype=np.float32), cuda_device)
    all_p, r_p, det_p = rowstats.row_log_ratio_stats(img, valid, detail=True)
    before = rowstats.ROW_STATS_LAUNCHES["kernel"]
    all_k, r_k, det_k = rowstats._launch_row_stats(img, circle, borders,
                                                   detail=True)
    all_k2, r_k2 = rowstats.row_stats(img, circle, borders)
    assert rowstats.ROW_STATS_LAUNCHES["kernel"] == before + 2
    for a, b in ((all_k, all_k2), (r_k, r_k2)):     # two launches, one result
        _same_bits(a, b)

    row_ok, lo, hi = _strip_bounds_host(h, w, circle, borders)
    np.testing.assert_array_equal(det_k["row_ok"].cpu().numpy(), row_ok)
    np.testing.assert_array_equal(det_k["x_lo"].cpu().numpy(), lo)
    np.testing.assert_array_equal(det_k["x_hi"].cpu().numpy(), hi)
    xs = torch.arange(w, device=cuda_device)
    mask = (det_k["row_ok"][:, None] & (xs >= det_k["x_lo"][:, None])
            & (xs < det_k["x_hi"][:, None]))
    assert torch.equal(mask, valid)
    _same_bits(det_k["med"], det_p["med"])
    _same_bits(det_k["mdev"], det_p["mdev"])
    assert torch.equal(det_k["nk"], det_p["nk"])

    # the scale of each sum: the mean |rat| of what it summed (the twin's
    # keep, from its median and MAD); rows with a non-finite value compare
    # exactly
    f = as_f32(img)
    rat = torch.log(f / torch.cat([f[:1], f[:-1]], dim=0))
    dist = (rat - det_p["med"][:, None]).abs()
    mdev = det_p["mdev"][:, None]
    s = torch.where(mdev > 0, dist / mdev.clamp(min=1e-30),
                    torch.zeros_like(dist))
    keep = valid & (s < 2.0)
    for got, want, mask in ((all_k, all_p, valid), (r_k, r_p, keep)):
        mass = torch.where(mask, rat.abs(), torch.zeros_like(rat)).double()
        scale = (mass.sum(dim=1) / mask.sum(dim=1).clamp(min=1)).cpu().numpy()
        _close_sums(got, want, np.nan_to_num(scale, nan=0.0, posinf=0.0))
    assert torch.equal(keep.sum(dim=1), det_p["nk"])
    n = valid.sum(dim=1).cpu().numpy()
    assert int(n.sum()) > 0 or name == "above"


@pytest.mark.parametrize("name", ["bench_u16", "bench_f32", "cut_borders"])
def test_transversalium_gain_on_the_card_matches_the_cpu(cuda_device, name):
    """The gain c from the kernel's mean_r against the CPU twin's, 1e-6
    relative, one kernel launch a call."""
    from solex_ser_recon_en_torch.ops import rowstats
    from solex_ser_recon_en_torch.pipeline.transversalium import (
        transversalium_gain,
    )

    img_np, circle, borders = _row_stats_case(name)
    img = t(img_np)
    before = dict(rowstats.ROW_STATS_LAUNCHES)
    got = transversalium_gain(img.to(cuda_device), circle, borders, 301)
    want = transversalium_gain(img, circle, borders, 301)
    assert rowstats.ROW_STATS_LAUNCHES == {
        "kernel": before["kernel"] + 1, "plain": before["plain"] + 1}
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert got[1:3] == want[1:3]
    assert np.abs(got[0] - 1).max() > 1e-4      # it corrects something


# ---- the product chain (csrc/products.cu) against the plain twin on the
# CPU: the row gain, CLAHE's LUTs and blend, the stretches' limits and the
# stretches, bit for bit; kernel B5 twice a product, as before.

_CHAIN_KERNELS = ("row_gain", "tile_hist", "clahe_lut", "clahe_blend",
                  "stretch_params", "stretch")


def _reset_chain_counts():
    from solex_ser_recon_en_torch.pipeline import products

    for k in cuda_build.LAUNCHES:
        cuda_build.LAUNCHES[k] = 0
    for k in products.PRODUCTS_LAUNCHES:
        products.PRODUCTS_LAUNCHES[k] = 0


def _same_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.is_cuda and g.dtype == w.dtype
            assert torch.equal(g.cpu().view(torch.int16), w.view(torch.int16))


@pytest.mark.parametrize("kind", ["f64", "u16", "f32", "bench"])
def test_row_gain_kernel_equals_the_twin(cuda_device, kind):
    """One launch; saturation at both ends, a zero and a negative gain,
    NaN and infinities of a float image, a float64 image (the de-vignetted
    frame) taken as float32, rows that do not hold a whole number of
    eight-pixel runs (97 x 131), and the bench product."""
    from solex_ser_recon_en_torch.ops import rowstats

    from test_torch_products_kernel import row_gain_case
    from torch_parity import bench_product

    img, gain = bench_product(0) if kind == "bench" else row_gain_case(kind)
    _reset_chain_counts()
    got = rowstats.apply_row_gain(t(img, cuda_device), t(gain, cuda_device))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["row_gain"] == 1
    want = rowstats.apply_row_gain(t(img), t(gain))
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def test_row_gain_kernel_on_an_unaligned_view(cuda_device):
    """A view that starts one pixel into its storage takes the kernel's
    pixel-by-pixel path."""
    from solex_ser_recon_en_torch.ops import rowstats

    from test_torch_products_kernel import row_gain_case

    img, gain = row_gain_case("u16")
    flat = t(img, cuda_device).reshape(-1)
    base = torch.empty(flat.numel() + 1, dtype=torch.uint16,
                       device=cuda_device)
    base[1:] = flat
    view = base[1:].view(img.shape)
    got = rowstats.apply_row_gain(view, t(gain, cuda_device))
    want = rowstats.apply_row_gain(t(img), t(gain))
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("clip_limit", [0.0, 0.8])
@pytest.mark.parametrize("hist_size,grid,shape", [
    (65536, (2, 2), (2048, 2204)), (65536, (2, 2), (301, 257)),
    (65536, (3, 5), (600, 1024)), (65536, (1, 1), (300, 260)),
    (256, (1, 1), (300, 260)), (256, (2, 2), (301, 257)),
    (256, (3, 3), (300, 260)), (256, (4, 4), (301, 257))],
    ids=lambda v: str(v))
def test_clahe_kernels_equal_the_twin(cuda_device, hist_size, grid, shape,
                                      clip_limit):
    """clahe_levels on the card (B5, one LUT launch, one blend launch)
    against the twin on the CPU: the levels, the LUTs and the whole
    image's histogram where the grid pads nothing."""
    from solex_ser_recon_en_torch.ops import clahe as clahe_mod

    from test_torch_products_kernel import u8_image
    from torch_parity import bench_product

    ty, tx = grid
    img = (u8_image(shape, ty) if hist_size == 256
           else bench_product(1, *shape)[0])
    _reset_chain_counts()
    got, full = clahe_mod.clahe_levels(t(img, cuda_device), clip_limit, tx,
                                       ty, hist_size, return_full_hist=True)
    torch.cuda.synchronize()
    assert {k: cuda_build.LAUNCHES[k] for k in
            ("tile_hist", "clahe_lut", "clahe_blend")} == {
        "tile_hist": 1, "clahe_lut": 1, "clahe_blend": 1}
    want, want_full = clahe_mod.clahe_levels(t(img), clip_limit, tx, ty,
                                             hist_size, return_full_hist=True)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (full is None) == (want_full is None)
    if full is not None:
        assert torch.equal(full.cpu(), want_full)
    h, w = shape
    _, _, _, clip, scale = clahe_mod._clahe_plan(h, w, clip_limit, tx, ty,
                                                 hist_size)
    hist = clahe_mod.image_tile_histograms(t(img), ty, tx, hist_size)
    luts, _ = clahe_mod._launch_clahe_lut(hist.to(cuda_device), clip, scale,
                                          False)
    assert torch.equal(luts.cpu().to(torch.int32),
                       clahe_mod._clahe_luts_plain(hist, clip, scale,
                                                   hist_size))


@pytest.mark.parametrize("want", [(False, False), (True, True),
                                  (True, False), (False, True)], ids=str)
@pytest.mark.parametrize("shape", [(2048, 2204), (301, 257)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_product_chain_on_the_card_equals_the_cpu(cuda_device, shape, want):
    """_products_body on the card, counted ``kernel``: cl1, cc and the
    stretches asked for equal the twin's on the CPU; B5 twice (three times
    for the odd shape's disk histogram when a stretch of it is wanted),
    one launch of each of the LUTs, the blend, the limits and the
    stretches."""
    from solex_ser_recon_en_torch.pipeline import products

    from torch_parity import bench_product

    img, _ = bench_product(2, *shape)
    _reset_chain_counts()
    got = products._products_body(t(img, cuda_device), want)
    torch.cuda.synchronize()
    stretched = want[0] or want[1]
    odd = shape[1] % 2 == 1
    assert products.PRODUCTS_LAUNCHES == {"kernel": 1, "plain": 0}
    assert {k: cuda_build.LAUNCHES[k] for k in _CHAIN_KERNELS} == {
        "row_gain": 0, "tile_hist": 2 + (stretched and odd), "clahe_lut": 1,
        "clahe_blend": 1, "stretch_params": 1, "stretch": 1}
    _same_outputs(got, products._products_body(t(img), want))


@pytest.mark.parametrize("want", [(False, False), (True, True)], ids=str)
def test_gained_chain_on_the_card_equals_the_cpu(cuda_device, want):
    """The scan's chain on the bench product: the row gain, then the
    products, seven launches and B5's two."""
    from solex_ser_recon_en_torch.pipeline import products

    from torch_parity import bench_product

    img, gain = bench_product(0)
    _reset_chain_counts()
    got = products._products_core_gained(t(img, cuda_device),
                                          t(gain, cuda_device), want)
    torch.cuda.synchronize()
    assert {k: cuda_build.LAUNCHES[k] for k in _CHAIN_KERNELS} == {
        "row_gain": 1, "tile_hist": 2, "clahe_lut": 1, "clahe_blend": 1,
        "stretch_params": 1, "stretch": 1}
    _same_outputs(got, products._products_core_gained(t(img), t(gain), want))


def test_products_stage_of_a_scan_launches_at_most_10(cuda_device, tmp_path):
    """A -cw0 scan under the profiler: the kernels and memsets its
    ``products`` stage launched (chip_profile.by_stage) number at most 10,
    and the chain ran on the kernels alone."""
    import json
    import sys

    from solex_ser_recon_en_torch.cli import main as cli_main
    from solex_ser_recon_en_torch.io.png import read_png
    from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
    from solex_ser_recon_en_torch.pipeline import products

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_profile

    p = str(tmp_path / "scan.ser")
    SyntheticScan(ih=360, iw=300, frames=220, depth=16,
                  line_poly=(150.0, 0.02, -1e-4, 0.0), disk_radius=90.0,
                  squash_y=1.08, trans_stripes=0.08, noise=0.002,
                  seed=4).write(p, transpose_to_wide=True)
    args = ["-cw0", p, "--output-dir", str(tmp_path / "out")]
    assert cli_main.main(args) == 0              # builds, warms the pools
    _reset_chain_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(activities=acts,
                                experimental_config=every_thread) as prof:
        assert cli_main.main(args) == 0
        torch.cuda.synchronize()
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in chip_profile.DEVICE_CATS]
    stages = chip_profile.by_stage(events, device)
    assert 0 < stages["products"][0] <= 10, dict(stages)
    assert products.PRODUCTS_LAUNCHES["kernel"] > 0
    assert products.PRODUCTS_LAUNCHES["plain"] == 0
    assert read_png(str(tmp_path / "out" / "scan_shift=0_clahe.png")).max()
