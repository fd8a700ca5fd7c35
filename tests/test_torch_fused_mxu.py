"""Kernel B6 (the tensor-core fused step), the one-hot route and the shoot-out
of the PyTorch port vs the JAX package (CPU).

Kernel B6 (csrc/fused_mxu.cu) runs only on the card; on the CPU its wrapper
takes the plain version, which these tests hold against the JAX MXU kernel
(``shg_fused_pallas(..., mxu=True)``, Pallas interpret mode, the block
sizes of tests/test_fused_pallas.py), against a dense float64 one-hot
contraction and against B1's plain version.  Inputs are made with numpy
from a seed.

Tolerances:
- mean and max bit-exact everywhere (integer sums and maxima).
- B6 plain vs the dense float64 contraction: bit-identical.  Both form
  round_f64(a*w + b*(1-w)) from exact products; this is the proof that the
  gather form repeats the kernel's FP64 arithmetic.
- B6 plain vs the JAX MXU kernel, B1 plain, and the one-hot route vs
  ``_recon_onehot`` / ``shg_forward_xla``: disks within 1 LSB on at most 1%
  of pixels.  Float32 and float64 sums of the same two products differ in
  the last bit, which moves the truncation to u16 by one at integer
  boundaries (XLA:CPU also contracts the f32 sum into an FMA).
- ``warp_projective`` vs JAX: the FMA bound of tests/test_torch_warp_fast.py
  (5e-7 + 2 float32 ulp of the largest source coordinate); against the
  port's own ``warp_projective_u16`` on u16/65536 input: bit-identical.
- B6's launch plan (``fused_mxu_plan``, the Python mirror of
  csrc/fused_mxu.cu:make_plan): exact integer geometry.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.models.shg import shg_forward_xla
from solex_ser_recon_en_tpu.ops.fused_pallas import shg_fused_pallas
from solex_ser_recon_en_tpu.ops.recon import _recon_onehot
from solex_ser_recon_en_tpu.ops.warp import (
    warp_projective as jax_warp_projective,
)
from solex_ser_recon_en_torch import bench_kernels
from solex_ser_recon_en_torch.models.shg import shg_forward_onehot
from solex_ser_recon_en_torch.ops import cuda_build
from solex_ser_recon_en_torch.ops.fused_cuda import (
    B1_MAX_SMEM,
    MXU_MAX_IW,
    fused_mxu_plan,
    mxu_frame_stride,
    shg_fused,
    shg_fused_mxu,
    shg_fused_mxu_plain,
    shg_fused_plain,
)
from solex_ser_recon_en_torch.ops.recon import recon_onehot
from solex_ser_recon_en_torch.ops.warp import (
    warp_projective,
    warp_projective_u16,
)

from test_torch_cuda_kernels import B6_SHAPES
from test_torch_fused import CASES, FB, YB, _case
from test_torch_warp_fast import _jax_bound, _pipeline_matrix
from torch_parity import lsb_diff, t

# the four cases of tests/test_fused_pallas.py:23-56
JAX_CASES = ["unaligned", "aligned_s1", "s5", "edge_clipping"]


def _wild_case(seed=4):
    """Tap columns anywhere in [-3, iw + 3): out-of-range taps are absent
    from the comb of the TPU kernel (its iota compare matches no column)."""
    rng = np.random.default_rng(seed)
    F, ih, iw, S = 11, 36, 20, 4
    frames = rng.integers(0, 65536, (F, ih, iw), dtype=np.uint16)
    ind_l = rng.integers(-3, iw + 3, (S, ih)).astype(np.int32)
    left_w = rng.random(ih).astype(np.float32)
    return frames, ind_l, left_w


def _dense_f64(frames, ind_l, left_w):
    """disks from a dense float64 one-hot contraction (torch.bmm), batched
    over rows: comb (ih, S, iw) against frames (ih, iw, F)."""
    fr = t(frames).to(torch.float64).permute(1, 2, 0)
    iw = frames.shape[2]
    l = t(ind_l).long().t()[:, :, None]
    w = t(left_w)[:, None, None]
    cols = torch.arange(iw)
    comb = (torch.where(cols == l, w.double(), 0.0)
            + torch.where(cols == l + 1, (1.0 - w).double(), 0.0))
    out = torch.bmm(comb, fr).to(torch.float32).clamp(0, 65535)
    return out.to(torch.int32).to(torch.uint16).permute(1, 0, 2).numpy()


def _assert_step_close(ours, ref):
    mean, mx, disks = (np.asarray(a) for a in ours)
    jm, jx, jd = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(mean, jm)
    np.testing.assert_array_equal(mx, jx)
    assert disks.shape == jd.shape and disks.dtype == jd.dtype == np.uint16
    d_max, d_frac = lsb_diff(disks, jd)
    assert d_max <= 1 and d_frac <= 0.01, (d_max, d_frac)


@pytest.mark.parametrize("name", JAX_CASES)
def test_mxu_plain_matches_jax_mxu_kernel(name):
    frames, ind_l, left_w = _case(name)
    ours = shg_fused_mxu_plain(t(frames), t(ind_l), t(left_w))
    ref = shg_fused_pallas(frames, ind_l, left_w, fb=FB, yb=YB, mxu=True)
    _assert_step_close(ours, ref)


def test_mxu_plain_matches_jax_on_out_of_range_taps():
    frames, ind_l, left_w = _wild_case()
    ours = shg_fused_mxu_plain(t(frames), t(ind_l), t(left_w))
    ref = shg_fused_pallas(frames, ind_l, left_w, fb=FB, yb=YB, mxu=True)
    _assert_step_close(ours, ref)


@pytest.mark.parametrize("name", list(CASES) + ["wild"])
def test_mxu_plain_equals_dense_f64_contraction(name):
    frames, ind_l, left_w = _wild_case() if name == "wild" else _case(name)
    _, _, disks = shg_fused_mxu_plain(t(frames), t(ind_l), t(left_w))
    np.testing.assert_array_equal(disks.numpy(),
                                  _dense_f64(frames, ind_l, left_w))


@pytest.mark.parametrize("name", list(CASES))
def test_mxu_plain_vs_b1_plain(name):
    frames, ind_l, left_w = _case(name)
    args = (t(frames), t(ind_l), t(left_w))
    _assert_step_close(shg_fused_mxu_plain(*args), shg_fused_plain(*args))


def test_mxu_switch_takes_plain_on_cpu():
    """shg_fused(..., mxu=True) is B6: on the CPU its plain version, with
    no launch counted."""
    frames, ind_l, left_w = _case("s5")
    args = (t(frames), t(ind_l), t(left_w))
    before = dict(cuda_build.LAUNCHES)
    outs = [shg_fused(*args, mxu=True), shg_fused_mxu(*args)]
    assert cuda_build.LAUNCHES == before
    for out in outs:
        for a, b in zip(out, shg_fused_mxu_plain(*args)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_mxu_rejects_rows_wider_than_its_tile():
    frames = torch.zeros((2, 3, MXU_MAX_IW + 1), dtype=torch.uint16)
    ind_l = torch.zeros((1, 3), dtype=torch.int32)
    left_w = torch.zeros((3,), dtype=torch.float32)
    with pytest.raises(ValueError, match="shg_fused_mxu"):
        shg_fused_mxu(frames, ind_l, left_w)
    with pytest.raises(TypeError, match="shg_fused_mxu"):
        shg_fused_mxu(frames.to(torch.int32), ind_l, left_w)


@pytest.mark.parametrize("S", [2, 7])
def test_mxu_plan_bench_slab_takes_bulk(S):
    """The resident bench slab (2000 x 2048 x 300, aligned) takes the bulk
    path: 4-row runs, 8-frame stages of 8 x 2448 bytes, 3 stages in the
    ring, and a block small enough for 3 blocks an SM (csrc/fused_mxu.cu's
    header note)."""
    plan = fused_mxu_plan(4096, S, 2048, 300)
    assert plan["path"] == "bulk"
    assert (plan["yb"], plan["D"], plan["fb"], plan["stride"]) == (
        4, 3, 32, 2448)
    assert 3 * (plan["smem"] + 1024) <= 233472     # an SM's 228 KB


@pytest.mark.parametrize("ptr,ih,iw,path", [
    (4096, 64, 300, "bulk"),
    (4098, 64, 300, "element"),        # a view 2 bytes into an allocation
    (4104, 64, 300, "element"),        # 8-byte aligned only
    (4096, 101, 300, "element"),       # ih * iw not a multiple of 8
    (4096, 9, 2, "element"),           # 9 x 2: shorter than one granule
    (4096, 7, 5, "element"),
    (4096, 8, 5, "bulk"),              # 8 rows of 5: one 80-byte run
    (4096, 5, 3072, "bulk"),           # the widest row, one row a block
    (4098, 5, 3072, "element"),
])
def test_mxu_plan_path(ptr, ih, iw, path):
    assert fused_mxu_plan(ptr, 2, ih, iw)["path"] == path


@pytest.mark.parametrize("F,ih,iw,S", B6_SHAPES + [(2000, 2048, 300, 2),
                                                   (2000, 2048, 300, 7),
                                                   (64, 2048, 300, 800),
                                                   (64, 2048, 3072, 4096)])
@pytest.mark.parametrize("ptr", [4096, 4098])
def test_mxu_plan_geometry(ptr, F, ih, iw, S):
    """The plan fits the opt-in shared memory, keeps a block's run within
    3072 elements, and takes the bulk path only where every copy is a
    16-byte multiple from a 16-byte aligned address."""
    plan = fused_mxu_plan(ptr, S, ih, iw)
    yb, D, fb = plan["yb"], plan["D"], plan["fb"]
    assert plan["smem"] <= B1_MAX_SMEM == 232448
    assert 1 <= yb <= min(ih, 8) and yb * iw <= MXU_MAX_IW
    assert 2 <= D <= 8 and fb in (8, 16, 32)
    stride = plan["stride"]
    assert stride == mxu_frame_stride(yb * iw)
    # room for the run and the element path's 0-7 element offset
    assert stride % 128 == 16 and stride >= 2 * yb * iw + 32
    nsg = -(-S // 8)
    assert plan["smem"] == (64 + D * 8 * stride
                            + ((2 * S * yb * fb + 15) & ~15)
                            + 16 * yb + 8 * yb * nsg + 32 * yb * nsg)
    if plan["path"] == "bulk":
        assert ptr % 16 == 0 and ih * iw % 8 == 0 and yb * iw % 8 == 0
    else:
        assert ptr % 16 or ih * iw % 8 or all(
            r * iw % 8 for r in range(1, min(ih, 8, MXU_MAX_IW // iw) + 1))


@pytest.mark.parametrize("iw", [2, 300, 3072])
def test_mxu_plan_refuses_only_what_cannot_fit(iw):
    """Every shift count up to a few thousand has a plan; one whose staging
    tile alone exceeds a block's shared memory has none."""
    for S in (1, 8, 9, 121, 800, 4096):
        assert fused_mxu_plan(4096, S, 2048, iw) is not None
    assert fused_mxu_plan(4096, 20000, 2048, iw) is None


@pytest.mark.parametrize("n", [2, 10, 40, 300, 600, 1200, 2400, 3072])
def test_mxu_stage_stride_is_bank_conflict_free(n):
    """An A fragment (lane = 4 * frame + column: 8 frames x 4 consecutive
    u16 of one row) read from a bulk-path stage touches every one of the 32
    four-byte banks at most once, wherever the row starts."""
    stride = mxu_frame_stride(n)
    for start in range(64):                    # u16 offset of the 4 columns
        words = {}
        for lane in range(32):
            frame, col = divmod(lane, 4)
            word = (frame * stride + 2 * (start + col)) // 4
            assert words.setdefault(word % 32, word) == word, (n, start)


@pytest.mark.parametrize("name", list(CASES))
def test_onehot_route_matches_jax(name):
    frames, ind_l, left_w = _case(name)
    args = (t(frames), t(ind_l), t(left_w))
    _assert_step_close(shg_forward_onehot(*args),
                       shg_forward_xla(frames, ind_l, left_w))
    ref = _recon_onehot(frames, ind_l, left_w, iw=frames.shape[2])
    d_max, d_frac = lsb_diff(recon_onehot(*args).numpy(), np.asarray(ref))
    assert d_max <= 1 and d_frac <= 0.01


def test_onehot_route_keeps_float32_matmuls_exact(monkeypatch):
    """recon_onehot's matmul runs with TF32 off and the precision at
    'highest', whatever the caller had set; the caller's setting is back
    afterwards."""
    frames, ind_l, left_w = _case("s5")
    old = torch.get_float32_matmul_precision()
    seen = []
    bmm = torch.bmm

    def spy(*a, **k):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
        return bmm(*a, **k)

    monkeypatch.setattr(torch, "bmm", spy)
    try:
        torch.set_float32_matmul_precision("high")
        recon_onehot(t(frames), t(ind_l), t(left_w))
        assert seen == [("highest", False)]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.parametrize("case", [
    (0.15, 0.93, -13.4, 7.3, 300, 257, 310, 270),
    (-0.4, 1.18, 4.2, -9.7, 300, 257, 280, 300),
    (1.2, 1.45, -60.0, 199.5, 220, 150, 230, 160),
])
def test_warp_projective_matches_jax(case, rng):
    phi, ratio, tx, ty, h, w, oh, ow = case
    m3 = _pipeline_matrix(phi, ratio, tx, ty)
    m3[1, 0] = 0.015          # a general affine map, not unit-y
    img = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    f01 = img.astype(np.float32) / np.float32(65536)
    ours = warp_projective(t(f01), m3, oh, ow, cval=0.013).numpy()
    ref = np.asarray(jax_warp_projective(jnp.asarray(f01), jnp.asarray(m3),
                                         oh, ow, cval=0.013))
    d = np.abs(ours - ref)
    assert d.max() <= _jax_bound(m3, oh, ow), d.max()
    assert (d > 5e-7).mean() < 0.1
    np.testing.assert_array_equal(
        ours, warp_projective_u16(t(img), m3, oh, ow, cval=0.013).numpy())


def test_bench_kernels_cpu_prints_every_row(capsys):
    rc = bench_kernels.main(["--device", "cpu", "--frames", "24", "--ih",
                             "40", "--iw", "32", "--reps", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    tags = [r["tag"] for r in rec["rows"]]
    assert rec["device"] == "cpu" and rec["shape"] == [24, 40, 32]
    assert len(tags) == len(set(tags)) == 14
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rec["rows"])
    for tag in tags:
        assert any(line.startswith(tag) for line in lines[:-1]), tag


def test_bench_kernels_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_kernels.main(["--frames", "8", "--ih", "8", "--iw", "8"])


@pytest.mark.parametrize("src,consts", [
    ("fused_mxu.cu", {"kMaxRows": 2, "kStageTarget": "48 * 1024",
                      "kRingTarget": 12345}),
    ("sum_max.cu", {"kChunks": 3, "kRingTarget": "72 * 1024"}),
])
def test_ring_probe_rewrites_each_constant_once(src, consts):
    """chip_ring_probe.py builds variants of the two ring kernels by writing
    over constants of their sources: each must be there exactly once (the
    script stops otherwise)."""
    import chip_ring_probe

    text = (cuda_build.CSRC / src).read_text()
    out = chip_ring_probe.with_constants(text, consts, 1)
    for name, value in consts.items():
        assert f" {name} = {value};" in out
    assert "__launch_bounds__(kThreads, 1)" in out
    assert out.count("\n") == text.count("\n")
    with pytest.raises(SystemExit):
        chip_ring_probe.with_constants(text, {"kNoSuchConstant": 1}, None)
