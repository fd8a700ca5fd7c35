"""The port's device Canny (ops/canny.py) against the JAX package's (CPU).

The ellipse fit sends every blob above 65536 px (the bench scan's
512 x 500 downscale among them) to ops/canny.py, and the flooded 0/65000
image has exact ties between neighbouring gradient magnitudes, so one
float32 ulp moves edge points through the non-maximum suppression.  The
tolerance is therefore none: the magnitude equals ``jnp.hypot``'s and the
sector the JAX expression's, bit for bit, and the edge maps are equal.  The
JAX side is the package's own jitted code on XLA:CPU (its ``canny``, and
its private stages jitted the same way for the intermediates).

At the bench scan's size ``ellipse_to_circle`` then fits the same ellipse
(ratio and phi within 1e-9, as the small-disk stage test asks).  The warp
after it is not bit-equal: measured on two 2048 x 2000 disks, 2 LSB on
0.350% and 0.351% of pixels; the bound is 2 LSB on < 1%.  The cause is
XLA:CPU's contraction of the warp's coordinate and row-lerp multiply-adds
into FMAs (ROADMAP C2): with those contracted the same way in a copy of the
port's warp inputs, the difference falls to 1 LSB on 0.0015% (bound 1 LSB
on < 0.01%; the rest is the horizontal lerp's own contraction).
"""

import math
from fractions import Fraction
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.geometry import correct as jax_correct
from solex_ser_recon_en_tpu.ops import canny as jax_canny
from solex_ser_recon_en_tpu.ops.warp_fast import unit_y_row, window_for
from solex_ser_recon_en_torch import interop
from solex_ser_recon_en_torch.geometry.correct import ellipse_to_circle
from solex_ser_recon_en_torch.ops import canny, warp_fast

from torch_parity import (
    flooded_ellipse,
    graded_ellipse,
    limb_darkened_disk,
    lsb_diff,
)

KINDS = {"flooded": flooded_ellipse, "graded": graded_ellipse}
# flooded: the pipeline's thresholds (median of the [0, 1) disk / 10);
# graded: thresholds inside its gradient range, so hysteresis grows edges
THRESHOLDS = {"flooded": (0.05, 0.075), "graded": (650.0, 975.0)}


@partial(jax.jit, static_argnames=("sigma",))
def _jax_stages(img, sigma):
    k = jax_canny._gaussian_kernel_1d(sigma)
    sm = jax_canny._conv1d(jax_canny._conv1d(img, k, 0), k, 1)
    norm = jax_canny._conv1d(
        jax_canny._conv1d(jnp.ones_like(img), k, 0), k, 1)
    sm = sm / jnp.maximum(norm, 1e-12)
    gy, gx = jax_canny._sobel(sm)
    ang = jnp.arctan2(gy, gx)
    ang = jnp.where(ang < 0, ang + jnp.pi, ang)
    sector = jnp.floor_divide(ang + jnp.pi / 8, jnp.pi / 4).astype(
        jnp.int32) % 4
    return jnp.hypot(gy, gx), sector


def jax_gradients(image: np.ndarray, sigma: float = 2.0):
    """(magnitude, sector) by the JAX Canny's own expressions, jitted."""
    return [np.asarray(a) for a in _jax_stages(jnp.asarray(image), sigma)]


def check_canny(image, sigma, low, high):
    mag_j, sector_j = jax_gradients(image, sigma)
    mag_t, sector_t = canny.gradients(torch.from_numpy(image), sigma)
    np.testing.assert_array_equal(mag_t.numpy().view(np.int32),
                                  mag_j.view(np.int32))
    np.testing.assert_array_equal(sector_t.numpy(), sector_j)
    edges_j = np.asarray(jax_canny.canny(jnp.asarray(image), sigma=sigma,
                                         low_threshold=low,
                                         high_threshold=high))
    edges_t = canny.canny(torch.from_numpy(image), sigma, low, high).numpy()
    assert edges_j.sum() > 0
    np.testing.assert_array_equal(edges_t, edges_j)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(257, 256), (512, 500), (600, 560)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", list(KINDS))
def test_canny_equals_jax(kind, shape, seed):
    check_canny(KINDS[kind](*shape, seed), 2.0, *THRESHOLDS[kind])


@pytest.mark.parametrize("sigma", [1.5, 1.0, 0.5])
def test_canny_retry_sigmas_equal_jax(sigma):
    """get_edge_list retries with sigma lowered by 0.5 when it finds no
    edge: 13, 9 and 5 taps."""
    check_canny(flooded_ellipse(512, 500, 2), sigma, *THRESHOLDS["flooded"])


def test_blur_redone_exactly_where_a_sum_falls_halfway(monkeypatch):
    """A float64 sum halfway between two float32 values sends the pass to
    the round-to-odd sums; forced here on every exactly representable sum
    (a zero among them), the result is the JAX Canny's all the same."""
    calls = []
    round_sum = canny._round_sum
    monkeypatch.setattr(canny, "_HALF29", 0)
    monkeypatch.setattr(canny, "_round_sum",
                        lambda p, c: calls.append(1) or round_sum(p, c))
    for kind in KINDS:
        check_canny(KINDS[kind](300, 280, 5), 2.0, *THRESHOLDS[kind])
    assert len(calls) >= 2 * 2 * 16


def test_atan2f_equals_xla():
    """jnp.arctan2 on XLA:CPU (libm's atan2f) on every argument reduction
    branch, signed zeros, x = 1, huge and tiny quotients."""
    rng = np.random.default_rng(3)
    n = 400_000
    y = rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 6, n)
    x = rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 6, n)
    # quotients at the reduction thresholds 7/16, 11/16, 19/16, 39/16, 2^25
    edge = np.array([0.4375, 0.6875, 1.1875, 2.4375, 2.0 ** 25, 2.0 ** -29])
    xs = 10.0 ** rng.uniform(-3, 4, 100_000)
    ye = xs * edge[rng.integers(0, len(edge), 100_000)] * (
        1 + rng.uniform(-1e-6, 1e-6, 100_000))
    special = np.array([0.0, -0.0, 1.0, -1.0, 1e-30, 3e38, 0.4375, 2.4375])
    sy, sx = np.meshgrid(special, special)
    y = np.concatenate([y, ye, sy.ravel()]).astype(np.float32)
    x = np.concatenate([x, xs, sx.ravel()]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = canny._atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _round_f32(v: Fraction) -> np.float32:
    """The float32 nearest the exact value ``v`` (ties to even)."""
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                     int(np.array(c).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """a * b + c rounded once, also where the float64 sum lands on a
    float32 midpoint that the exact sum misses (a double rounding)."""
    rng = np.random.default_rng(4)
    a = (rng.standard_normal(300) * 10.0 ** rng.integers(-8, 8, 300))
    b = (rng.standard_normal(300) * 10.0 ** rng.integers(-8, 8, 300))
    c = (rng.standard_normal(300) * 10.0 ** rng.integers(-8, 8, 300))
    u = 2.0 ** -23
    hard = [(2.0 ** -12 * (1 + u), 2.0 ** -12 * (1 - u), 1 + u),
            (-(2.0 ** -12) * (1 + u), 2.0 ** -12 * (1 - u), -(1 + u)),
            (2.0 ** -12 * (1 + 3 * u), -(2.0 ** -12) * (1 - 3 * u), 1.0),
            (2.0 ** -12 * (1 + u), 2.0 ** -12 * (1 + u), 1 + u)]
    a = np.concatenate([a, [h[0] for h in hard]]).astype(np.float32)
    b = np.concatenate([b, [h[1] for h in hard]]).astype(np.float32)
    c = np.concatenate([c, [h[2] for h in hard]]).astype(np.float32)
    got = canny._fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(p)) * Fraction(float(q))
                                + Fraction(float(r)))
                     for p, q, r in zip(a, b, c)], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the first hard case: plain float64 rounds it the other way
    naive = np.float32(np.float64(a[300]) * np.float64(b[300])
                       + np.float64(c[300]))
    assert naive != want[300]


@pytest.fixture(scope="module")
def bench_disk_fits():
    """Both packages' ellipse_to_circle on a 2048 x 2000 disk (the bench
    scan's disk shape; its 512 x 500 downscale takes the device Canny),
    the JAX side on its separable warp (its TPU gate)."""
    disk = limb_darkened_disk(2048, 2000, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_correct, "_use_fast_warp",
                   lambda m: bool(unit_y_row(m) and window_for(m) > 0))
        geo_j = interop.geometry(jax_correct.ellipse_to_circle(
            jnp.asarray(disk)))
    geo_t = ellipse_to_circle(interop.tensor(disk))
    return disk, geo_j, geo_t


def test_ellipse_to_circle_at_bench_size(bench_disk_fits):
    _, geo_j, geo_t = bench_disk_fits
    assert math.isclose(geo_t.ratio, 1.08, rel_tol=0.01)
    assert geo_t.ratio == pytest.approx(geo_j.ratio, rel=1e-9)
    assert geo_t.phi == pytest.approx(geo_j.phi, abs=1e-9)
    np.testing.assert_allclose(geo_t.circle, geo_j.circle, atol=1e-6)
    np.testing.assert_allclose(geo_t.borders, geo_j.borders, atol=1e-6)
    np.testing.assert_allclose(geo_t.mat3, geo_j.mat3, atol=1e-12)
    mx, frac = lsb_diff(geo_t.image.numpy(), geo_j.image.numpy())
    assert mx <= 2 and frac < 0.01


def _warp_inputs_contracted(images_f01, mat3, out_h, out_w, cval):
    """ops/warp_fast.py:warp_inputs with the multiply-adds XLA:CPU fuses
    (the first product of each coordinate sum, the vertical lerp) rounded
    once, as its FMAs do."""
    K, h, w_in = images_f01.shape
    m = torch.as_tensor(np.asarray(mat3), dtype=torch.float32)
    cval_f = cval.to(torch.float32).reshape(K, 1, 1)
    xs = torch.arange(out_w, dtype=torch.float32)
    ys = torch.arange(out_h, dtype=torch.float32)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")

    def affine(row, x, y):
        return canny._fma32(row[0].expand_as(x), x, row[1] * y) + row[2]

    sx = affine(m[0], gx, gy) / affine(m[2], gx, gy)
    sy_col = affine(m[1], xs[:1].expand_as(ys), ys)
    x0 = torch.floor(sx)
    dx = sx - x0
    x0i = x0.to(torch.int32)
    y0 = torch.floor(sy_col)
    dy = (sy_col - y0)[:, None]
    y0i = y0.to(torch.int32)
    ok0 = ((y0i >= 0) & (y0i < h))[:, None]
    ok1 = ((y0i + 1 >= 0) & (y0i + 1 < h))[:, None]
    r0 = images_f01.index_select(1, y0i.clamp(0, h - 1).long())
    r1 = images_f01.index_select(1, (y0i + 1).clamp(0, h - 1).long())
    a = torch.where(ok0, r0, cval_f)
    b = torch.where(ok1, r1, cval_f)
    V = canny._fma32(a, (1.0 - dy).expand_as(a), b * dy)
    val0 = ((x0i >= 0) & (x0i < w_in)).to(torch.float32)
    val1 = ((x0i + 1 >= 0) & (x0i + 1 < w_in)).to(torch.float32)
    w0 = (1.0 - dx) * val0
    w1 = dx * val1
    cadd = cval_f * ((1.0 - dx) * (1.0 - val0) + dx * (1.0 - val1))
    return V.contiguous(), x0i.contiguous(), w0, w1, cadd.contiguous()


def test_bench_warp_difference_is_xla_contraction(bench_disk_fits,
                                                  monkeypatch):
    disk, geo_j, _ = bench_disk_fits
    monkeypatch.setattr(warp_fast, "warp_inputs", _warp_inputs_contracted)
    geo_c = ellipse_to_circle(interop.tensor(disk))
    mx, frac = lsb_diff(geo_c.image.numpy(), geo_j.image.numpy())
    assert mx <= 1 and frac < 1e-4
