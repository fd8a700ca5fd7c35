"""The fused single-pass step of the PyTorch port vs the JAX package (CPU).

Kernel B1 (csrc/fused.cu) runs only on the card; on the CPU its wrapper
takes the plain version, which these tests hold against the JAX step: the
Pallas kernels in interpret mode (windowed ``_kernel_win`` through the
public entry, full-width ``_kernel`` through ``_shg_fused(..., win=0)``)
and the XLA step ``shg_forward_xla``.  Inputs are made with numpy from a
seed.

Tolerances: mean and max bit-exact (integer sums and maxima).  Disks
within 1 LSB on at most 1% of pixels: XLA:CPU contracts the lerp's
``w*a + (1-w)*b`` into an FMA in the vector body of its loops, while the
port rounds each product and the sum separately (ROADMAP C).  The Pallas
kernels in interpret mode run through XLA:CPU too, with the same effect
(measured on these cases: at most 1 LSB on at most 0.2% of pixels).
Against the port's own ``recon_plain`` the disks are bit-exact (the same
arithmetic).  Pass A (``sum_max``, ``mean_max``; the sum/max kernel runs
only on the card, CPU tensors take torch's reductions): bit-exact against
the JAX RawScanProcessor and against ``mean_max_plain``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.io.feeder import (
    normalize_frames as jax_normalize_frames,
)
from solex_ser_recon_en_tpu.models.shg import (
    example_inputs as jax_example_inputs,
    shg_forward_xla,
)
from solex_ser_recon_en_tpu.ops.fused import (
    RawScanProcessor as JaxProcessor,
)
from solex_ser_recon_en_tpu.ops.fused_pallas import (
    _shg_fused,
    _window_for_indices,
    shg_fused_pallas,
)
from solex_ser_recon_en_torch import bench_device
from solex_ser_recon_en_torch import models as port_models
from solex_ser_recon_en_torch.config import Options
from solex_ser_recon_en_torch.io.feeder import normalize_frames
from solex_ser_recon_en_torch.models.shg import (
    example_inputs,
    shg_forward,
    shg_forward_plain,
)
from solex_ser_recon_en_torch.ops import cuda_build, fused_cuda
from solex_ser_recon_en_torch.ops.fused import RawScanProcessor
from solex_ser_recon_en_torch.ops.fused_cuda import (
    MAX_FRAMES,
    fused_plan,
    mean_max,
    mean_max_plain,
    shg_fused,
    shg_fused_plain,
    sum_max,
)
from solex_ser_recon_en_torch.ops.recon import build_shift_indices, recon_plain
from solex_ser_recon_en_torch.pipeline import run as port_run

from torch_parity import lsb_diff, t

CPU = torch.device("cpu")
FB, YB = 8, 32   # the JAX tests' Pallas block sizes (tests/test_fused_pallas.py)

# (F, ih, iw, shifts, line): tests/test_fused_pallas.py:23-29 and :44-57,
# plus a 300-px spectral window on which the JAX entry takes the 128-lane
# windowed kernel
CASES = {
    "unaligned": (37, 100, 60, [-2, 0, 3], "cubic"),
    "aligned_s1": (16, 128, 32, [0], "cubic"),
    "s5": (9, 40, 24, [10, 0, -5, 5, 7], "cubic"),
    "edge_clipping": (12, 48, 20, [-30, 0, 30], "edge"),
    "windowed": (24, 256, 300, [-3, 0, 4], "cubic"),
    # the bench-width shapes of B1's card tests
    # (tests/test_torch_cuda_kernels.py:B1_SHAPES): bulk path, a frame tail,
    # a row tail, the S = 7 sweep of bench_kernels.SWEEP
    "bench_width": (64, 64, 300, [10, 0], "cubic"),
    "frame_tail": (67, 64, 300, [10, 0], "cubic"),
    "row_tail": (67, 70, 300, [10, 0], "cubic"),
    "sweep_s7": (64, 64, 300, list(range(-10, 11, 3)), "cubic"),
}


def _case(name, seed=11):
    F, ih, iw, shifts, line = CASES[name]
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 65536, (F, ih, iw), dtype=np.uint16)
    y = np.arange(ih)
    curve = (iw / 2 + 0.03 * y - 1e-4 * y ** 2 if line == "cubic"
             else 1.0 + 0.02 * y)
    floor = np.floor(curve)
    ind_l, left_w = build_shift_indices(floor, curve - floor, shifts, iw)
    return frames, ind_l, left_w


def _jax_step(ref, frames, ind_l, left_w):
    if ref == "pallas":
        return shg_fused_pallas(frames, ind_l, left_w, fb=FB, yb=YB)
    if ref == "pallas_full":
        w2 = jnp.asarray(left_w)[None, :]
        return _shg_fused(jnp.asarray(frames), jnp.asarray(ind_l), w2, FB,
                          YB, 0)
    return shg_forward_xla(frames, ind_l, left_w)


@pytest.mark.parametrize("ref", ["pallas", "pallas_full", "xla"])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_plain_matches_jax(name, ref):
    frames, ind_l, left_w = _case(name)
    mean, mx, disks = shg_fused_plain(t(frames), t(ind_l), t(left_w))
    jm, jx, jd = (np.asarray(a) for a in _jax_step(ref, frames, ind_l,
                                                   left_w))
    np.testing.assert_array_equal(mean.numpy(), jm)
    np.testing.assert_array_equal(mx.numpy(), jx)
    assert disks.shape == jd.shape == (ind_l.shape[0],) + frames.shape[1::-1]
    d_max, d_frac = lsb_diff(disks.numpy(), jd)
    assert d_max <= 1 and d_frac <= 0.01


def test_windowed_case_takes_the_window():
    """The JAX entry runs the 128-lane windowed body (_kernel_win) on the
    'windowed' case, so the comparison above covers B1's TPU body."""
    _, ind_l, _ = _case("windowed")
    assert _window_for_indices(ind_l, CASES["windowed"][2], YB) == 128


@pytest.mark.parametrize("name", list(CASES))
def test_fused_disks_equal_recon_plain(name):
    frames, ind_l, left_w = _case(name)
    _, _, disks = shg_fused_plain(t(frames), t(ind_l), t(left_w))
    ref = recon_plain(t(frames), t(ind_l), t(left_w), False, False)
    np.testing.assert_array_equal(disks.numpy(), ref.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_shg_forward_matches_plain_on_cpu(name):
    """On the CPU shg_forward takes B1's plain version without a launch,
    and equals the two-pass route."""
    frames, ind_l, left_w = _case(name)
    args = (t(frames), t(ind_l), t(left_w))
    before = dict(cuda_build.LAUNCHES)
    out = shg_forward(*args)
    assert cuda_build.LAUNCHES == before
    for a, b in zip(out, shg_forward_plain(*args)):
        assert a.dtype == b.dtype == torch.uint16
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kwargs", [{}, dict(F=9, ih=40, iw=24, S=5, seed=3)])
def test_example_inputs_match_jax(kwargs):
    for a, b in zip(example_inputs(**kwargs), jax_example_inputs(**kwargs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_models_package_exports():
    assert port_models.shg_forward is shg_forward
    assert port_models.example_inputs is example_inputs


@pytest.mark.parametrize("rotate,upscale", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_normalize_frames_matches_jax(rotate, upscale):
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256 if upscale else 65536, (6, 9, 14)).astype(
        np.uint8 if upscale else np.uint16)
    out = normalize_frames(t(raw), rotate, upscale)
    ref = np.asarray(jax_normalize_frames(raw, rotate, upscale))
    assert out.is_contiguous()
    assert str(out.dtype).endswith(str(ref.dtype))
    np.testing.assert_array_equal(out.numpy(), ref)


def _bad_inputs():
    frames = torch.zeros((4, 6, 5), dtype=torch.uint16)
    ind_l = torch.zeros((2, 6), dtype=torch.int32)
    left_w = torch.zeros((6,), dtype=torch.float32)
    big = torch.zeros((32768, 1, 2), dtype=torch.uint16)
    return {
        "frames_dtype": ((frames.to(torch.int32), ind_l, left_w), TypeError),
        "ind_l_rows": ((frames, ind_l[:, :5].contiguous(), left_w),
                       TypeError),
        "left_w_dtype": ((frames, ind_l, left_w.double()), TypeError),
        "not_contiguous": ((frames.transpose(1, 2).transpose(1, 2)[:, :, :4],
                            ind_l, left_w), ValueError),
        "too_many_frames": ((big, torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros((1,), dtype=torch.float32)),
                            ValueError),
        "meta_device": ((frames.to("meta"), ind_l.to("meta"),
                         left_w.to("meta")), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_shg_fused_rejects(case):
    args, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        shg_fused(*args)


def test_fused_plan_bench_slab_takes_bulk():
    """The resident bench slab (2000 x 2048 x 300, aligned) takes the bulk
    path: 20-row runs (750 16-byte chunks on 256 threads), 1 frame a stage,
    6 stages in the ring (csrc/fused.cu's header note)."""
    for S in (2, 7):
        plan = fused_plan(4096, S, 2048, 300)
        assert plan["path"] == "bulk"
        assert (plan["yb"], plan["xw"], plan["K"], plan["D"], plan["fb"]) == (
            20, 300, 1, 6, 32)


@pytest.mark.parametrize("ptr,ih,iw,path", [
    (4096, 64, 300, "bulk"),
    (4098, 64, 300, "element"),        # a view 2 bytes into an allocation
    (4104, 64, 300, "element"),        # 8-byte aligned only
    (4096, 13, 2500, "element"),       # ih * iw not a multiple of 8
    (4096, 3, 2, "element"),
    (4096, 3, 9001, "element"),        # column chunks
    (4096, 8, 9000, "element"),
    (4096, 8, 8192, "bulk"),           # the widest row a block holds
])
def test_fused_plan_path(ptr, ih, iw, path):
    assert fused_plan(ptr, 2, ih, iw)["path"] == path


def _old_b1_accepts(S, iw):
    """Whether the previous B1 launch (one frame per barrier, a 2048-element
    block) fitted its shared memory: the inputs the new one must accept."""
    xw, yb = (iw, min(8, 2048 // iw)) if iw <= 2048 else (2047, 1)

    def smem(yb):
        return (((4 * yb * (xw + 1)) + 15) & ~15) + 64 * S * yb + 4 * S * yb \
            + 4 * yb
    while yb > 1 and smem(yb) > 48 * 1024:
        yb -= 1
    return smem(yb) <= fused_cuda.PLAN_LIMITS["max_smem"]


@pytest.mark.parametrize("iw", [2, 60, 300, 2048, 2049, 2500, 8192, 9001,
                                100000])
def test_fused_plan_geometry(iw):
    """For every S the previous kernel took (and more), the plan fits the
    opt-in shared memory, keeps a thread's work within its 4 chunks, uses
    the bulk path only where the copies are 16-byte multiples, and refuses
    nothing the previous kernel took."""
    limits = fused_cuda.PLAN_LIMITS
    max_smem, max_run = limits["max_smem"], limits["b1_max_run"]
    for ptr in (4096, 4098):
        for ih in (1, 3, 13, 70, 2048):
            for S in (1, 2, 7, 121, 800, 3000, 3500, 5000, 12000):
                plan = fused_plan(ptr, S, ih, iw)
                if plan is None:
                    assert not _old_b1_accepts(S, iw)
                    continue
                run = plan["xw"] + 1 if plan["xw"] < iw else plan["yb"] * iw
                assert plan["smem"] <= max_smem
                assert run <= max_run == 8 * 4 * limits["threads"]
                assert 1 <= plan["yb"] <= ih and plan["xw"] <= max_run
                assert plan["K"] in (1, 2, 4, 8) and 2 <= plan["D"] <= 8
                assert plan["fb"] in (8, 16, 32)
                if plan["xw"] < iw:
                    assert plan["yb"] == 1 and plan["path"] == "element"
                if plan["path"] == "bulk":
                    assert ptr % 16 == 0 and ih * iw % 8 == 0
                    assert plan["yb"] * iw % 8 == 0


STAGE_KEYS = {"n_frames", "slab_mb", "feed_s_measured", "link_gbps_measured",
              "device_meanmax_s", "host_linefit_s", "device_recon_s",
              "post_s", "post_stages_ms", "device_resident_e2e_s"}


def test_decomposition_cpu_matches_read_scan(basic_scan, tmp_path):
    """The resident legs on the CPU: the fused step's mean and disks equal
    the -c path's read_scan on the same file bit for bit, and the post
    stage writes the product."""
    path = basic_scan["path"]
    dec = bench_device.device_attached_decomposition(
        path, CPU, out_dir=str(tmp_path / "decomp"))
    assert set(dec.stages) == STAGE_KEYS
    assert dec.stages["n_frames"] == basic_scan["frames"].shape[0]
    assert all(v > 0 for k, v in dec.stages.items()
               if k.endswith("_s") or k == "slab_mb")
    scan = port_run.read_scan(path, Options(shift=[0], clahe_only=True,
                                            output_dir=str(tmp_path)), CPU)
    assert scan.shifts == bench_device.SHIFTS
    np.testing.assert_array_equal(dec.mean.numpy(), scan.mean_img)
    np.testing.assert_array_equal(dec.disks.numpy(), scan.disk_list.numpy())
    np.testing.assert_array_equal(dec.max.numpy(),
                                  basic_scan["frames"].max(axis=0))
    png = tmp_path / "decomp" / "decomp_shift=0_clahe.png"
    assert png.exists() and png.stat().st_size > 0


def test_bench_device_cli_prints_one_json_line(basic_scan, tmp_path, capsys):
    rc = bench_device.main([basic_scan["path"], "--device", "cpu",
                            "--output-dir", str(tmp_path)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    stages = json.loads(lines[-1])
    assert STAGE_KEYS <= set(stages) and stages["device"] == "cpu"
    assert os.path.exists(tmp_path / "decomp_shift=0_clahe.png")


def test_device_only_fps_cpu(basic_scan):
    fps = bench_device.device_only_fps(basic_scan["path"], CPU)
    assert np.isfinite(fps) and fps > 0


# pass A: (frames, height, width, chunk length) of the raw scan
PASS_A_CASES = [(100, 24, 64, 30), (37, 9, 14, 13), (50, 16, 40, 50)]


@pytest.mark.parametrize("rotate,upscale", [(False, False), (True, False),
                                            (False, True), (True, True)])
@pytest.mark.parametrize("F,H,W,step", PASS_A_CASES)
def test_sum_max_accumulates_like_jax_pass_a(F, H, W, step, rotate, upscale):
    """sum_max over uneven raw chunks (u16, or u8 for an 8-bit scan) into
    one pair of accumulators equals the whole scan's sum and max, and the
    port's RawScanProcessor on it equals the JAX one bit for bit; on the
    normalised layout the same chunks give mean_max_plain of the slab."""
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256 if upscale else 65536, (F, H, W)).astype(
        np.uint8 if upscale else np.uint16)
    total = torch.zeros((H, W), dtype=torch.int32)
    mx = torch.zeros((H, W), dtype=torch.int32)
    before = dict(cuda_build.LAUNCHES)
    jp = JaxProcessor(H, W, rotate, upscale)
    tp = RawScanProcessor(H, W, rotate, upscale, CPU)
    for s in range(0, F, step):
        sum_max(t(raw[s:s + step]), total, mx)
        jp.accumulate(s, jnp.asarray(raw[s:s + step]))
        tp.accumulate(s, t(raw[s:s + step]))
    assert cuda_build.LAUNCHES == before
    np.testing.assert_array_equal(total.numpy(), raw.sum(axis=0,
                                                         dtype=np.int64))
    np.testing.assert_array_equal(mx.numpy(), raw.max(axis=0))
    for a, b in zip(tp.mean_max(), jp.mean_max()):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    norm = normalize_frames(t(raw), rotate, upscale)
    ntotal = torch.zeros(norm.shape[1:], dtype=torch.int32)
    nmx = torch.zeros_like(ntotal)
    for s in range(0, F, step):
        sum_max(norm[s:s + step], ntotal, nmx)
    mean_p, max_p = mean_max_plain(norm)
    np.testing.assert_array_equal((ntotal // F).numpy(),
                                  mean_p.to(torch.int32).numpy())
    np.testing.assert_array_equal(nmx.numpy(), max_p.to(torch.int32).numpy())
    if not upscale:      # x256 then mean truncates differently from raw mean
        np.testing.assert_array_equal(mean_p.numpy(), tp.mean_max()[0])
    np.testing.assert_array_equal(max_p.numpy(), tp.mean_max()[1])


@pytest.mark.parametrize("name", list(CASES))
def test_mean_max_takes_plain_on_cpu(name):
    frames, _, _ = _case(name)
    before = dict(cuda_build.LAUNCHES)
    out = mean_max(t(frames))
    assert cuda_build.LAUNCHES == before
    for a, b in zip(out, mean_max_plain(t(frames))):
        assert a.dtype == b.dtype == torch.uint16
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(out[1].numpy(), frames.max(axis=0))


def test_accumulate_refuses_a_scan_past_the_int32_bound():
    """The int32 frame sum is exact up to MAX_FRAMES frames over the whole
    scan: the chunk that would pass it is refused, before it is counted."""
    p = RawScanProcessor(1, 2, False, False, CPU)
    chunk = torch.zeros((16384, 1, 2), dtype=torch.uint16)
    p.accumulate(0, chunk, keep=False)
    p.accumulate(16384, chunk[:16383], keep=False)
    assert p.count == MAX_FRAMES == 32767
    with pytest.raises(ValueError, match="32767"):
        p.accumulate(32767, chunk[:1], keep=False)
    assert p.count == MAX_FRAMES


def _bad_sum_max():
    frames = torch.zeros((4, 6, 5), dtype=torch.uint16)
    acc = torch.zeros((6, 5), dtype=torch.int32)
    return {
        "frames_dtype": ((frames.to(torch.int32), acc, acc.clone()),
                         TypeError),
        "frames_2d": ((frames[0], acc, acc.clone()), TypeError),
        "not_contiguous": ((frames[:, :, :4], acc[:, :4].contiguous(),
                            acc[:, :4].contiguous()), ValueError),
        "empty": ((frames[:0], acc, acc.clone()), ValueError),
        "acc_dtype": ((frames, acc.to(torch.int64), acc), TypeError),
        "acc_shape": ((frames, acc[:5].contiguous(), acc), TypeError),
        "too_many_frames": ((torch.zeros((32768, 1, 2), dtype=torch.uint16),
                             torch.zeros((1, 2), dtype=torch.int32),
                             torch.zeros((1, 2), dtype=torch.int32)),
                            ValueError),
        "meta_device": ((frames.to("meta"), acc.to("meta"), acc.to("meta")),
                        ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_sum_max()))
def test_sum_max_rejects(case):
    args, exc = _bad_sum_max()[case]
    with pytest.raises(exc):
        sum_max(*args)
