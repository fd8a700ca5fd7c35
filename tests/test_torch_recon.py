"""Pass A / pass B of the PyTorch port vs the JAX package (CPU).

Kernel B3 (csrc/recon.cu) runs only on the card; on the CPU its wrapper
takes the plain version, which these tests hold against the JAX recon.
Tolerances: mean/max exact; disks within 1 LSB (XLA:CPU contracts the
lerp's ``w*a + (1-w)*b`` into an FMA, the port rounds each product — the
JAX package's own Pallas-vs-XLA contract, tests/test_fused_pallas.py).
"""

import jax
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.ops.fused import RawScanProcessor as JaxProcessor
from solex_ser_recon_en_tpu.ops.pallas_recon import recon_pallas
from solex_ser_recon_en_torch.ops import cuda_build
from solex_ser_recon_en_torch.ops.fused import RawScanProcessor, launch_groups
from solex_ser_recon_en_torch.ops.recon import (
    build_shift_indices,
    recon_chunks_plain,
    recon_onehot,
    recon_plain,
)
from solex_ser_recon_en_torch.ops.recon_cuda import recon, recon_chunks

from torch_parity import lsb_diff, t

CPU = torch.device("cpu")


@pytest.mark.parametrize("F,ih,iw,shifts", [
    (37, 100, 60, [-2, 0, 3]),
    (9, 40, 24, [10, 0, -5, 5, 7]),
])
def test_recon_plain_matches_pallas(rng, F, ih, iw, shifts):
    frames = rng.integers(0, 65536, (F, ih, iw), dtype=np.uint16)
    curve = iw / 2 + 0.03 * np.arange(ih) - 1e-4 * np.arange(ih) ** 2
    floor = np.floor(curve)
    ref = np.asarray(recon_pallas(frames, floor, curve - floor, shifts))
    ind_l, left_w = build_shift_indices(floor, curve - floor, shifts, iw)
    out = recon_plain(t(frames), t(ind_l), t(left_w), False, False).numpy()
    assert out.shape == ref.shape == (len(shifts), ih, F)
    mx, frac = lsb_diff(out, ref)
    assert mx <= 1 and frac < 0.01


def _raw_case(rng, rotate, upscale, F=40):
    H, W = (24, 64) if rotate else (64, 24)
    dtype = np.uint8 if upscale else np.uint16
    raw = rng.integers(0, 256 if upscale else 65536, size=(F, H, W),
                       dtype=dtype)
    return raw, H, W


@pytest.mark.parametrize("rotate,upscale", [(True, False), (False, False),
                                            (True, True), (False, True)])
def test_raw_processor_matches_jax(rng, rotate, upscale):
    raw, H, W = _raw_case(rng, rotate, upscale)
    F = raw.shape[0]
    jp = JaxProcessor(H, W, rotate, upscale, frame_count=F)
    tp = RawScanProcessor(H, W, rotate, upscale, CPU)
    for s in range(0, F, 13):
        jp.accumulate(s, jax.device_put(raw[s:s + 13]))
        tp.accumulate(s, t(raw[s:s + 13]))
    mean_j, max_j = jp.mean_max()
    mean_t, max_t = tp.mean_max()
    np.testing.assert_array_equal(mean_t, mean_j)
    np.testing.assert_array_equal(max_t, max_j)

    curve = tp.iw / 2 + 0.05 * np.arange(tp.ih)
    floor = np.floor(curve).astype(np.int64)
    shifts = [-5, 0, 3]
    disks_j = np.asarray(jp.reconstruct(floor, curve - floor, shifts))
    disks_t = tp.reconstruct(floor, curve - floor, shifts)
    assert disks_t.dtype == torch.uint16
    mx, frac = lsb_diff(disks_t.numpy(), disks_j)
    assert mx <= 1 and frac < 0.02


def test_pass_b_independent_of_chunking(rng):
    """Kernel B3 / its plain version have no shape-dependent arithmetic:
    pass B is bit-identical for any feed chunking (no merge copy needed)."""
    raw, H, W = _raw_case(rng, True, False, F=30)
    curve = 12 + 0.03 * np.arange(W)
    floor = np.floor(curve).astype(np.int64)
    outs = []
    for step in (30, 7, 1):
        p = RawScanProcessor(H, W, True, False, CPU)
        for s in range(0, 30, step):
            p.accumulate(s, t(raw[s:s + step]))
        outs.append(p.reconstruct(floor, curve - floor, [0, 4]).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_recon_wrapper_dispatch(rng):
    """CPU tensors take the plain version without launching; devices that
    are neither CPU nor CUDA are refused."""
    raw, H, W = _raw_case(rng, True, False, F=5)
    ind_l = torch.full((1, W), 3, dtype=torch.int32)
    left_w = torch.full((W,), 0.25, dtype=torch.float32)
    before = cuda_build.LAUNCHES["recon"]
    out = recon(t(raw), ind_l, left_w, True, False)
    assert cuda_build.LAUNCHES["recon"] == before
    np.testing.assert_array_equal(
        out.numpy(), recon_plain(t(raw), ind_l, left_w, True, False).numpy())
    with pytest.raises(ValueError, match="unsupported device"):
        recon(t(raw).to("meta"), ind_l.to("meta"), left_w.to("meta"),
              True, False)


def _ser(tmp_path, raw):
    from solex_ser_recon_en_tpu.io.ser import SerReader, write_ser

    path = str(tmp_path / "raw.ser")
    write_ser(path, raw)
    return SerReader(path)


@pytest.mark.parametrize("depth", [8, 16])
def test_feeder_cpu_chunks_are_raw_frames(tmp_path, rng, depth):
    from solex_ser_recon_en_torch.io.feeder import raw_device_chunks

    raw = rng.integers(0, 2 ** depth, (23, 16, 40)).astype(
        np.uint8 if depth == 8 else np.uint16)
    reader = _ser(tmp_path, raw)
    it, rotate, upscale = raw_device_chunks(reader, 5, CPU)
    assert rotate and upscale == (depth == 8)
    got = [(s, c.numpy()) for s, c in it]
    assert [s for s, _ in got] == [0, 5, 10, 15, 20]
    np.testing.assert_array_equal(np.concatenate([c for _, c in got]), raw)


def _uneven_chunks(raw, C):
    """The feeder's chunking: C frames a chunk, the last one short."""
    return [(s, raw[s:s + C]) for s in range(0, raw.shape[0], C)]


@pytest.mark.parametrize("rotate,upscale", [(True, False), (False, False),
                                            (True, True), (False, True)])
def test_recon_chunks_plain_matches_jax(rng, rotate, upscale):
    """One pass-B launch over uneven chunks (its plain version) against the
    JAX RawScanProcessor.reconstruct on the same frames (C2: 1 LSB)."""
    raw, H, W = _raw_case(rng, rotate, upscale, F=47)
    jp = JaxProcessor(H, W, rotate, upscale, frame_count=47)
    chunks = _uneven_chunks(raw, 13)                   # 13, 13, 13, 8
    for s, c in chunks:
        jp.accumulate(s, jax.device_put(c))
    ih, iw = (W, H) if rotate else (H, W)
    curve = iw / 2 + 0.05 * np.arange(ih)
    floor = np.floor(curve).astype(np.int64)
    shifts = [-5, 0, 3]
    ind_l, left_w = build_shift_indices(floor, curve - floor, shifts, iw)
    ours = recon_chunks_plain([t(c) for _, c in chunks], t(ind_l),
                              t(left_w), rotate, upscale)
    ref = np.asarray(jp.reconstruct(floor, curve - floor, shifts))
    assert ours.shape == ref.shape == (3, ih, 47)
    mx, frac = lsb_diff(ours.numpy(), ref)
    assert mx <= 1 and frac < 0.02
    # into a larger tensor at an offset: only those frames are written
    out = torch.zeros((3, ih, 60), dtype=torch.uint16)
    recon_chunks([t(c) for _, c in chunks], t(ind_l), t(left_w), rotate,
                 upscale, out, 9)
    np.testing.assert_array_equal(out[:, :, 9:56].numpy(), ours.numpy())
    assert not out[:, :, :9].numpy().any() and not out[:, :, 56:].numpy().any()


@pytest.mark.parametrize("step", [13, 1, 47])
def test_streaming_equals_resident_pass_b(rng, step):
    """reconstruct (one launch over the resident chunks) and
    reconstruct_streaming (one launch per chunk) give identical disks."""
    raw, H, W = _raw_case(rng, True, False, F=47)
    curve = 12 + 0.03 * np.arange(W)
    floor = np.floor(curve).astype(np.int64)
    p = RawScanProcessor(H, W, True, False, CPU)
    for s, c in _uneven_chunks(raw, step):
        p.accumulate(s, t(c))
    resident = p.reconstruct(floor, curve - floor, [0, 4, -3])
    streamed = p.reconstruct_streaming(
        [(s, t(c)) for s, c in _uneven_chunks(raw, step)], floor,
        curve - floor, [0, 4, -3])
    np.testing.assert_array_equal(resident.numpy(), streamed.numpy())
    assert resident.shape == (3, W, 47)


def _fake(n):
    return torch.empty((n, 2, 3), dtype=torch.uint16)


@pytest.mark.parametrize("sizes,groups", [
    ([81] * 24 + [56], [25]),                  # the bench scan: one launch
    ([5] * 600 + [3], [256, 256, 89]),         # past the pointer table
    ([4] * 257, [256, 1]),                     # one past the table
    ([4] * 512 + [1], [256, 256, 1]),
    ([7], [1]),
])
def test_launch_groups(sizes, groups):
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    chunks = [(s, _fake(n)) for s, n in zip(starts, sizes)]
    got = launch_groups(chunks[::-1], sum(sizes))     # any order
    assert [len(g) for _, g in got] == groups
    assert got[0][0] == 0
    for (start, g), (nxt, _) in zip(got, got[1:]):
        assert start + sum(c.shape[0] for c in g) == nxt
        assert all(c.shape[0] == g[0].shape[0] for c in g[:-1])


def test_launch_groups_refuse_gaps():
    with pytest.raises(ValueError, match="starts at frame 5, not 4"):
        launch_groups([(0, _fake(4)), (5, _fake(4))], 9)
    with pytest.raises(ValueError, match="pass A counted"):
        launch_groups([(0, _fake(4))], 5)


_GAP = ([(0, 4), (5, 4)], "starts at frame 5, not 4")
_SHORT = ([(0, 4), (4, 4)], "pass A counted 10")


@pytest.mark.parametrize("pairs,match,streaming", [
    ([(0, 4), (4, 2), (6, 4)], "every chunk but the last", False),
    ([(0, 4), (4, 6)], "every chunk but the last", False),
    (*_GAP, False), (*_SHORT, False), (*_GAP, True), (*_SHORT, True),
])
def test_pass_b_refuses_what_the_feeder_cannot_make(rng, pairs, match,
                                                    streaming):
    """Both pass-B paths refuse chunks that do not tile pass A's frames in
    order, instead of leaving disk frames unwritten; the resident path's
    one launch also refuses a short chunk that is not the last or a longer
    one after the first (the feeder makes neither)."""
    raw, H, W = _raw_case(rng, True, False, F=10)
    p = RawScanProcessor(H, W, True, False, CPU)
    p.accumulate(0, t(raw))
    curve = 12 + 0.03 * np.arange(W)
    floor = np.floor(curve).astype(np.int64)
    chunks = [(s, t(raw[s:s + n])) for s, n in pairs]
    with pytest.raises(ValueError, match=match):
        if streaming:
            p.reconstruct_streaming(chunks, floor, curve - floor, [0])
        else:
            p._chunks = chunks
            p.reconstruct(floor, curve - floor, [0])


def test_recon_chunks_checks_its_launch(rng):
    """The wrapper refuses what one launch cannot take, on any device."""
    ind_l = torch.zeros((1, 3), dtype=torch.int32)
    left_w = torch.zeros((3,), dtype=torch.float32)
    with pytest.raises(ValueError, match="every chunk but the last"):
        recon_chunks([_fake(4), _fake(5)], ind_l, left_w, True, False)
    with pytest.raises(ValueError, match="chunks, 1 to 256"):
        recon_chunks([_fake(1)] * 257, ind_l, left_w, True, False)
    with pytest.raises(ValueError, match="out must be"):
        recon_chunks([_fake(4)], ind_l, left_w, True, False,
                     torch.empty((1, 3, 6), dtype=torch.uint16), 3)
    with pytest.raises(TypeError, match="chunk 1"):
        recon_chunks([_fake(4), _fake(4).to(torch.uint8)], ind_l, left_w,
                     True, False)


def test_recon_onehot_restores_matmul_precision(rng):
    """recon_onehot switches TF32 off for its own matmul only: a caller's
    float32 matmul precision and TF32 flag survive it, and its disks do
    not depend on them."""
    frames = rng.integers(0, 65536, (9, 20, 16)).astype(np.uint16)
    curve = 7 + 0.05 * np.arange(20)
    floor = np.floor(curve)
    ind_l, left_w = build_shift_indices(floor, curve - floor, [0, 2], 16)
    args = (t(frames), t(ind_l), t(left_w))
    precision = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    want = recon_onehot(*args)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        got = recon_onehot(*args)
        assert torch.get_float32_matmul_precision() == "medium"
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_recon_plain_clips_taps(rng):
    """Out-of-range tap columns are clipped to [0, iw-2] (the contract the
    kernel shares), matching an explicitly clipped index set."""
    raw, H, W = _raw_case(rng, True, False, F=4)      # iw = H = 24
    left_w = t(np.linspace(0, 1, W).astype(np.float32))
    wild = np.arange(-20, W - 20, dtype=np.int32)[None] * 2
    clipped = np.clip(wild, 0, H - 2)
    np.testing.assert_array_equal(
        recon_plain(t(raw), t(wild), left_w, True, False).numpy(),
        recon_plain(t(raw), t(clipped), left_w, True, False).numpy())
