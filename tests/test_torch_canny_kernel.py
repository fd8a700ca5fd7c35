"""The device Canny's per-pixel arithmetic (csrc/canny.cuh) against the
plain twin (ops/canny.py), on the CPU.

csrc/canny.cu runs on the card only, but its arithmetic lives in a header
that the host library builds too (csrc/canny.cpp, g++ with contraction
off): here that build is held to the twin bit for bit, element by element
(fdlibm's atan2f, the once-rounded multiply-add, the magnitude, the sector)
and over whole images (blur, support norm, Sobel, suppression, thresholds
and a hysteresis flooded by the kernel's rule).  The card's tiles are
tested on the card (tests/test_torch_cuda_kernels.py).  Also here: the
CPU path is the twin, counted ``plain``, and another device raises.
"""

import numpy as np
import pytest
import torch

from solex_ser_recon_en_torch.io import native
from solex_ser_recon_en_torch.ops import canny

from torch_parity import (
    flooded_ellipse,
    graded_ellipse,
    halfway_ellipse,
    weak_snake,
)

KINDS = {"flooded": flooded_ellipse, "graded": graded_ellipse}
THRESHOLDS = {"flooded": (0.05, 0.075), "graded": (650.0, 975.0)}


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def host_elementwise(name, *arrays, out_dtype=np.float32):
    """solex_canny_<name>_host of the host library over float32 arrays."""
    arrays = [_f32(a) for a in arrays]
    out = np.empty(arrays[0].shape, dtype=out_dtype)
    fn = getattr(native.get_lib(), f"solex_canny_{name}_host")
    assert fn(*(a.ctypes.data for a in arrays), arrays[0].size,
              out.ctypes.data) == 0
    return out


def host_canny(img, sigma, low, high):
    """(magnitude, sector, classes, edges) of the host build's Canny."""
    img = _f32(img)
    h, w = img.shape
    taps = np.ascontiguousarray(canny._gaussian_kernel_1d(sigma))
    mag = np.empty((h, w), np.float32)
    sec = np.empty((h, w), np.int32)
    cls = np.empty((h, w), np.uint8)
    out = np.empty((h, w), np.uint8)
    assert native.get_lib().solex_canny_host(
        img.ctypes.data, h, w, taps.ctypes.data, len(taps), low, high,
        mag.ctypes.data, sec.ctypes.data, cls.ctypes.data,
        out.ctypes.data) == 0
    return mag, sec, cls, out.astype(bool)


def twin_sobel(img, sigma):
    """The twin's (d/dy, d/dx), its steps as _gradients_plain takes them."""
    x = torch.from_numpy(_f32(img))
    k = canny._gaussian_kernel_1d(sigma)
    sm = canny._conv1d(canny._conv1d(x, k, 0), k, 1)
    norm = canny._support_norm(*x.shape, float(sigma), "cpu")
    return canny._sobel(sm / torch.clamp(norm, min=1e-12))


def wide_values(rng, n=200_000):
    """The card tests' wide random float32 values (three arrays)."""
    return [(rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 6, n)).astype(
        np.float32) for _ in range(3)]


def check_image(img, sigma, low, high):
    """The host build's magnitude, sector, classes and edges = the twin's."""
    mag, sec, cls, edges = host_canny(img, sigma, low, high)
    mag_t, sec_t = canny._gradients_plain(torch.from_numpy(_f32(img)), sigma)
    np.testing.assert_array_equal(mag.view(np.int32),
                                  mag_t.numpy().view(np.int32))
    np.testing.assert_array_equal(sec, sec_t.numpy())
    lo, st = (m.numpy() for m in canny._classes(mag_t, sec_t, low, high))
    want = np.where(lo, np.where(st, 2, 1), np.where(st, 3, 0))
    np.testing.assert_array_equal(cls, want)
    edges_t = canny._canny_plain(torch.from_numpy(_f32(img)), sigma, low,
                                 high).numpy()
    np.testing.assert_array_equal(edges, edges_t)
    return edges


def test_host_atan2f_equals_the_twin():
    """fdlibm's atan2f: the card tests' wide values, signed zeros, the
    axes, x = +-1, and quotients at every reduction threshold."""
    y, x, _ = wide_values(np.random.default_rng(7))
    rng = np.random.default_rng(8)
    edge = np.array([0.4375, 0.6875, 1.1875, 2.4375, 2.0 ** 25, 2.0 ** -29])
    xs = 10.0 ** rng.uniform(-3, 4, 50_000)
    ye = xs * edge[rng.integers(0, len(edge), 50_000)] * (
        1 + rng.uniform(-1e-6, 1e-6, 50_000))
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 1e-30, -1e-30,
                        3e38, -3e38, 0.4375, 2.4375, 1e-40])
    sy, sx = np.meshgrid(special, special)
    y = _f32(np.concatenate([y, ye, -ye, sy.ravel()]))
    x = _f32(np.concatenate([x, xs, -xs, sx.ravel()]))
    got = host_elementwise("atan2f", y, x)
    want = canny._atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_host_fma_equals_the_twin():
    """The blur's multiply-add, rounded once: wide values and the double
    roundings of tests/test_torch_canny.py::test_fma32_rounds_once."""
    a, b, c = wide_values(np.random.default_rng(7))
    u = 2.0 ** -23
    hard = np.array([(2.0 ** -12 * (1 + u), 2.0 ** -12 * (1 - u), 1 + u),
                     (-(2.0 ** -12) * (1 + u), 2.0 ** -12 * (1 - u), -(1 + u)),
                     (2.0 ** -12 * (1 + 3 * u), -(2.0 ** -12) * (1 - 3 * u),
                      1.0),
                     (2.0 ** -12 * (1 + u), 2.0 ** -12 * (1 + u), 1 + u)])
    a, b, c = (_f32(np.concatenate([v, hard[:, i]]))
               for i, v in enumerate((a, b, c)))
    got = host_elementwise("fma", a, b, c)
    want = canny._fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_host_hypot_equals_the_twin():
    y, x, _ = wide_values(np.random.default_rng(9))
    special = np.array([0.0, -0.0, 1.0, -1.0, 3.0, 4.0, 1e-30, 3e38])
    sy, sx = np.meshgrid(special, special)
    y = _f32(np.concatenate([y, x, sy.ravel()]))
    x = _f32(np.concatenate([x, x, sx.ravel()]))
    got = host_elementwise("hypot", y, x)
    want = canny._hypot32(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind", list(KINDS))
def test_host_sector_equals_the_twin_on_the_bench_image(kind):
    """The sector of the twin's own gradients of a 512 x 500 image (the
    bench scan's downscale): exact ties of the flooded kind included."""
    gy, gx = twin_sobel(KINDS[kind](512, 500, 0), 2.0)
    got = host_elementwise("sector", gy.numpy(), gx.numpy(),
                           out_dtype=np.int32)
    np.testing.assert_array_equal(got, canny._sector(gy, gx).numpy())


@pytest.mark.parametrize("sigma", [2.0, 1.5, 1.0, 0.5])
@pytest.mark.parametrize("shape", [(257, 256), (512, 500)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", list(KINDS))
def test_host_canny_equals_the_twin(kind, shape, sigma):
    edges = check_image(KINDS[kind](*shape, 1), sigma, *THRESHOLDS[kind])
    assert edges.any()


def test_host_blur_where_the_twin_redoes_a_pass(monkeypatch):
    """The 0/65536 ellipse: the twin's float64 sums fall halfway and it
    redoes both blur passes with exact sums; the fma chain needs no redo."""
    calls = []
    round_sum = canny._round_sum
    monkeypatch.setattr(canny, "_round_sum",
                        lambda p, c: calls.append(1) or round_sum(p, c))
    img = halfway_ellipse(300, 280, 5)
    canny._gradients_plain(torch.from_numpy(img), 2.0)
    assert len(calls) >= 2 * 16
    check_image(img, 2.0, 0.05, 0.075)


@pytest.mark.parametrize("shape", [(5, 3), (2, 2), (40, 7), (33, 65)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_host_canny_on_small_and_odd_shapes(shape):
    """Shapes narrower than the blur's reach, down to the reflected
    border's least: the twin's padding and reflection everywhere."""
    img = graded_ellipse(*shape, 3)
    img[:, shape[1] // 2:] += 20000.0
    check_image(img, 2.0, 650.0, 975.0)


@pytest.mark.parametrize("value", [0.0, 1.0, 100.0])
def test_host_canny_of_a_constant_image_has_no_edges(value):
    """The blur's rounding leaves gradients below the 1e-3 floor (at
    65000 it would not: 0.087)."""
    assert not check_image(np.full((64, 80), value, np.float32), 2.0,
                           0.05, 0.075).any()


def test_host_hysteresis_follows_a_weak_snake():
    """Weak edges reached from a strong segment along a band that winds
    over the whole image; strong pixels below the low threshold seed
    their neighbours but stay out of the map."""
    img, (low, high), rows = weak_snake()
    edges = check_image(img, 1.0, low, high)
    assert edges[rows[-1] - 3:rows[-1] + 8].any()
    check_image(img, 1.0, high, low)            # high below low


def test_cpu_path_is_the_twin_counted_plain():
    img = torch.from_numpy(flooded_ellipse(64, 60, 0))
    before = dict(canny.CANNY_LAUNCHES)
    edges = canny.canny(img, 2.0, 0.05, 0.075)
    mag, sec = canny.gradients(img)
    assert canny.CANNY_LAUNCHES == {"kernel": before["kernel"],
                                    "plain": before["plain"] + 2}
    assert torch.equal(edges, canny._canny_plain(img, 2.0, 0.05, 0.075))
    assert torch.equal(mag, canny._gradients_plain(img, 2.0)[0])
    assert sec.dtype == torch.int32


def test_another_device_raises():
    img = torch.empty((64, 60), dtype=torch.float32, device="meta")
    before = dict(canny.CANNY_LAUNCHES)
    with pytest.raises(ValueError, match="meta"):
        canny.canny(img)
    with pytest.raises(ValueError, match="meta"):
        canny.gradients(img)
    assert canny.CANNY_LAUNCHES == before
