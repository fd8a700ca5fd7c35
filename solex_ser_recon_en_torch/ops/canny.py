"""Canny edge detection on the device.

Counterpart of solex_ser_recon_en_tpu/ops/canny.py.  reference:
ellipse_to_circle.py:244-250 — skimage.feature.canny(sigma=2, thresholds
from the image median) on the flooded (0/65000) downscaled disk; the
consumer is an outlier-robust ellipse fit, so only the blob outline
matters.

Gaussian blur (shifted multiply-adds, constant padding, divided by the
blurred support mask as skimage does) -> Sobel gradients (shifted
multiply-adds, reflect borders) -> quantised-direction non-maximum
suppression -> double threshold -> hysteresis by masked dilation, looped
in Python until a fixed point.  No convolution (cuDNN would use TF32 on
CUDA).

Every float32 value up to the sector is the one the JAX package's jitted
Canny computes on XLA:CPU, bit for bit, and the same on the CPU and on
CUDA.  The flooded image has exact ties between neighbouring magnitudes,
so one ulp anywhere moves edge points through the non-maximum
suppression.  Each step is a separate elementwise op that both devices
round correctly (no divisor is a host scalar: CUDA divides by one as a
multiply by its reciprocal), and what XLA:CPU does besides is written out:

- it contracts each ``acc + k * x`` of the blur into a fused multiply-add
  (LLVM, FPOpFusion::Fast): here the exact product is added to the
  accumulator in float64 and rounded once to float32 (``_conv1d``);
- the second pass over the support mask adds its centre tap uncontracted
  (``_support_norm``);
- ``jnp.hypot`` is max * sqrt(1 + (min / max)^2), the inner sum contracted;
- ``jnp.arctan2`` is a call of libm's atan2f: ``_atan2f`` is glibc's
  (fdlibm's) float algorithm, step for step; the sector's floor division
  by pi/4 is exact, so it is compared against the exact multiples.

``canny`` and ``gradients`` are the entry points: on CUDA tensors the
hand-written kernels of csrc/canny.cu (one launch for the gradients, the
suppression and the thresholds; one a hysteresis round, the host reading
one flag a round), whose per-pixel arithmetic (csrc/canny.cuh) is this
twin's with the rounding written as CUDA's _rn intrinsics; on CPU tensors
the plain twin below; any other device raises.  ``CANNY_LAUNCHES`` counts
the calls by path and ``CANNY_ROUNDS`` the kernel path's hysteresis
rounds.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

#: calls of ``canny`` and ``gradients`` by path: ``kernel`` (CUDA tensors)
#: or ``plain`` (CPU tensors); reset by callers that count one run
CANNY_LAUNCHES = {"kernel": 0, "plain": 0}
#: the kernel path's hysteresis rounds (one launch each): their sum and the
#: most that one call took
CANNY_ROUNDS = {"rounds": 0, "most": 0}
_count_lock = threading.Lock()


def _count(path: str, rounds: int = 0) -> None:
    with _count_lock:          # a session posts from its pool thread
        CANNY_LAUNCHES[path] += 1
        CANNY_ROUNDS["rounds"] += rounds
        CANNY_ROUNDS["most"] = max(CANNY_ROUNDS["most"], rounds)

# fdlibm s_atanf.c / e_atan2f.c (glibc sysdeps/ieee754/flt-32)
_ATANHI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
           1.5707962513e+00)
_ATANLO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
           7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
       -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
       6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
       -3.6531571299e-02, 1.6285819933e-02)
_PI32 = 3.1415927410e+00
_PI_O_2 = 1.5707963705e+00
_PI_LO = -8.7422776573e-08
_TINY = 1.0e-30


def _gaussian_kernel_1d(sigma: float) -> np.ndarray:
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _f32(v) -> float:
    """The float32 nearest ``v``, as a Python float: a multiply, add or
    subtract with it rounds in float32 on both devices."""
    return float(np.float32(v))


def _round_sum(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The float32 nearest the exact p + c of two float64 tensors: their
    float64 sum is rounded to odd (its TwoSum error sets the last bit when
    the sum is inexact), and a float64 rounded to odd rounds to float32 as
    the exact sum would."""
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    trunc = bits - (torch.signbit(s) != torch.signbit(e)).long()
    return torch.where(e == 0, bits, trunc | 1).view(torch.float64).float()


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return _round_sum(a.double() * b.double(), c.double())


# a float64 whose low 29 significand bits are 1 << 28 lies halfway between
# two float32 values (normal range; XLA:CPU flushes subnormals anyway)
_LOW29 = (1 << 29) - 1
_HALF29 = 1 << 28


def _conv1d(img: torch.Tensor, k: np.ndarray, dim: int,
            plain_centre: bool = False, exact: bool = False) -> torch.Tensor:
    """Zero-padded correlation along ``dim``: x0 * k0 + x1 * k1 + ... in
    XLA:CPU's contraction, fma(x0, k0, x1 * k1) then fma(xi, ki, acc);
    ``plain_centre``: the centre tap's product rounded and added.

    Each fused multiply-add is the float64 sum of the exact product and
    the float32 accumulator, rounded to float32: one rounding, unless the
    float64 sum fell exactly halfway between two float32 values.  Where
    that happens anywhere, the pass is redone with ``_round_sum`` at every
    tap (``exact``)."""
    r = len(k) // 2
    pad = [0, 0, 0, 0]
    pad[2 * (1 - dim): 2 * (1 - dim) + 2] = [r, r]   # F.pad: last dim first
    xp = F.pad(img, pad).double()
    n = img.shape[dim]

    def x(i):
        return xp.narrow(dim, i, n)

    if len(k) == 1:
        return (x(0) * float(k[0])).float()
    halfway = None

    def fma(i, c):   # x_i * k_i (exact in float64) + c
        nonlocal halfway
        if exact:
            return _round_sum(x(i) * float(k[i]), c.double())
        s = torch.add(c.double(), x(i), alpha=float(k[i]))
        tie = (s.view(torch.int64) & _LOW29) == _HALF29
        halfway = tie if halfway is None else halfway | tie
        return s.float()

    acc = fma(0, (x(1) * float(k[1])).float())
    for i in range(2, len(k)):
        if plain_centre and i == r:
            acc = acc + (x(i) * float(k[i])).float()
        else:
            acc = fma(i, acc)
    if halfway is not None and bool(halfway.any()):
        return _conv1d(img, k, dim, plain_centre, exact=True)
    return acc


@functools.lru_cache(maxsize=8)
def _support_norm(h: int, w: int, sigma: float, device: str) -> torch.Tensor:
    """The blurred support mask the blur is divided by, as XLA:CPU computes
    it: its second pass reads the centre tap as the row's loop-invariant
    value, a product hoisted out of the loop and added, not contracted.
    It depends on the shape alone, so it is made once a shape."""
    k = _gaussian_kernel_1d(sigma)
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    return _conv1d(_conv1d(ones, k, 0), k, 1, plain_centre=True)


def _reflect_pad1(img: torch.Tensor) -> torch.Tensor:
    """jnp.pad(img, 1, mode="reflect") for a 2-D tensor."""
    img = torch.cat([img[1:2], img, img[-2:-1]], dim=0)
    return torch.cat([img[:, 1:2], img, img[:, -2:-1]], dim=1)


def _sobel(img: torch.Tensor):
    """ndi.sobel-compatible gradients with reflect borders (taps -1, 0, 1,
    2: every product is exact, so contraction changes nothing)."""
    smooth = (1.0, 2.0, 1.0)
    deriv = (-1.0, 0.0, 1.0)
    h, w = img.shape

    def sep(ky, kx):
        pad = _reflect_pad1(img)
        rows = 0
        for i in range(3):
            rows = rows + ky[i] * pad.narrow(0, i, h)
        out = 0
        for i in range(3):
            out = out + kx[i] * rows.narrow(1, i, w)
        return out

    return sep(deriv, smooth), sep(smooth, deriv)   # d/dy, d/dx


def _hypot32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """jnp.hypot as XLA:CPU runs it: hi * sqrt(fma(r, r, 1)), r = lo / hi
    (hi = 0 gives 0; the square root rounded once, through float64)."""
    ay, ax = y.abs(), x.abs()
    hi, lo = torch.maximum(ay, ax), torch.minimum(ay, ax)
    one = torch.ones_like(hi)
    r = lo / torch.where(hi == 0, one, hi)
    root = _fma32(r, r, one).double().sqrt().float()
    return torch.where(hi == 0, hi, hi * root)


def _pick(idx: torch.Tensor, table) -> torch.Tensor:
    """float32 table[idx] for a small table of constants."""
    out = torch.full(idx.shape, _f32(table[-1]), device=idx.device)
    for i in range(len(table) - 2, -1, -1):
        out = torch.where(idx == i, _f32(table[i]), out)
    return out


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's float atan (glibc __atanf), every branch evaluated and the
    right one selected per element."""
    ix = x.view(torch.int32) & 0x7FFFFFFF
    ax = x.abs()
    reduced = ix >= 0x3EE00000                      # |x| >= 0.4375
    idx = ((ix >= 0x3F300000).int() + (ix >= 0x3F980000).int()
           + (ix >= 0x401C0000).int())
    xr = torch.where(idx == 0, (2.0 * ax - 1.0) / (ax + 2.0),
                     torch.where(idx == 1, (ax - 1.0) / (ax + 1.0),
                                 torch.where(idx == 2,
                                             (ax - 1.5) / (1.5 * ax + 1.0),
                                             -ax.reciprocal())))
    xr = torch.where(reduced, xr, x)
    z = xr * xr
    w = z * z
    at = [_f32(v) for v in _AT]
    s1 = z * (at[0] + w * (at[2] + w * (at[4] + w * (at[6] + w * (
        at[8] + w * at[10])))))
    s2 = w * (at[1] + w * (at[3] + w * (at[5] + w * (at[7] + w * at[9]))))
    hi, lo = _pick(idx, _ATANHI), _pick(idx, _ATANLO)
    big = hi - ((xr * (s1 + s2) - lo) - xr)
    out = torch.where(reduced, torch.where(x < 0, -big, big),
                      xr - xr * (s1 + s2))
    inf_lim = _f32(np.float32(_ATANHI[3]) + np.float32(_ATANLO[3]))
    out = torch.where(ix >= 0x4C000000,                 # |x| >= 2^25
                      torch.where(x > 0, inf_lim, -inf_lim), out)
    return torch.where(ix < 0x31000000, x, out)         # |x| < 2^-29


def _atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's atan2f (fdlibm __ieee754_atan2f) for finite float32 y, x,
    with XLA:CPU's flush of a subnormal quotient to zero."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)   # 2 * sign(x) + sign(y)
    k = (iy - ix) >> 23
    q = (y / torch.where(ix == 0, torch.ones_like(x), x)).abs()
    q = torch.where(q < 2.0 ** -126, 0.0, q)
    z = _atanf(q)
    f32 = np.float32
    pi, pi_lo = f32(_PI32), f32(_PI_LO)
    z = torch.where(k > 60, _f32(f32(_PI_O_2) + f32(0.5) * pi_lo), z)
    z = torch.where((hx < 0) & (k < -60), 0.0, z)
    out = torch.where(m == 0, z, torch.where(
        m == 1, -z, torch.where(m == 2, float(pi) - (z - float(pi_lo)),
                                (z - float(pi_lo)) - float(pi))))
    half_pi = _f32(f32(_PI_O_2) + f32(_TINY))
    out = torch.where(ix == 0, torch.where(hy < 0, -half_pi, half_pi), out)
    pi_t = _f32(pi + f32(_TINY))
    at_zero = torch.where(m < 2, y, torch.where(m == 2, pi_t, -pi_t))
    out = torch.where(iy == 0, at_zero, out)
    return torch.where(hx == 0x3F800000, _atanf(y), out)   # x = 1: atanf(y)


def _sector(gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """floor((atan2 folded to [0, pi) + pi/8) / (pi/4)) % 4 in float32 as
    the JAX package computes it; the quotient's floor is exact, taken as a
    count of the exact multiples of pi/4 (float32) at or below it."""
    ang = _atan2f(gy, gx)
    ang = torch.where(ang < 0, ang + _f32(math.pi), ang)
    a = (ang + _f32(math.pi / 8)).double()
    n = sum((a >= _f32(math.pi / 4) * j).int() for j in (1, 2, 3, 4))
    return n % 4


def _shift(p: torch.Tensor, dy: int, dx: int, shape) -> torch.Tensor:
    return p[1 + dy: 1 + dy + shape[0], 1 + dx: 1 + dx + shape[1]]


def _dilate(m: torch.Tensor) -> torch.Tensor:
    p = F.pad(m.to(torch.uint8), (1, 1, 1, 1)).bool()
    acc = m
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc | _shift(p, dy, dx, m.shape)
    return acc


def _gradients_plain(image: torch.Tensor, sigma: float):
    img = image.to(torch.float32)
    k = _gaussian_kernel_1d(sigma)
    sm = _conv1d(_conv1d(img, k, 0), k, 1)
    norm = _support_norm(*img.shape, float(sigma), str(img.device))
    sm = sm / torch.clamp(norm, min=1e-12)
    gy, gx = _sobel(sm)
    return _hypot32(gy, gx), _sector(gy, gx)


def _classes(mag: torch.Tensor, sector: torch.Tensor, low_threshold: float,
             high_threshold: float):
    """(low, strong): the pixels that survive the non-maximum suppression,
    the border and the floor, at or above each threshold."""
    pad = F.pad(mag, (1, 1, 1, 1))

    def nb(dy, dx):
        return _shift(pad, dy, dx, mag.shape)

    neighbours = [
        (nb(0, 1), nb(0, -1)),    # sector 0: horizontal gradient
        (nb(1, 1), nb(-1, -1)),   # sector 1: diagonal
        (nb(1, 0), nb(-1, 0)),    # sector 2: vertical
        (nb(1, -1), nb(-1, 1)),   # sector 3: anti-diagonal
    ]
    keep = torch.zeros(mag.shape, dtype=torch.bool, device=mag.device)
    for s, (a, b) in enumerate(neighbours):
        keep = keep | ((sector == s) & (mag >= a) & (mag >= b))
    border = torch.zeros_like(keep)
    border[1:-1, 1:-1] = True
    # tiny absolute magnitude floor: a constant image yields no edges
    keep = keep & border & (mag > 1e-3)
    return keep & (mag >= low_threshold), keep & (mag >= high_threshold)


def _canny_plain(image: torch.Tensor, sigma: float, low_threshold: float,
                 high_threshold: float) -> torch.Tensor:
    mag, sector = _gradients_plain(image, sigma)
    low, strong = _classes(mag, sector, low_threshold, high_threshold)
    cur = _dilate(strong) & low
    # hysteresis: grow the strong edges through the weak mask
    while True:
        nxt = _dilate(cur) & low
        if torch.equal(nxt, cur):
            return cur
        cur = nxt


def _launch_canny(image: torch.Tensor, sigma: float, low_threshold: float,
                  high_threshold: float, detail: bool = False):
    """csrc/canny.cu on a CUDA image: the edge map, or with ``detail`` the
    (magnitude, sector) of the gradient kernel alone."""
    img = image.to(torch.float32).contiguous()
    h, w = img.shape
    taps = np.ascontiguousarray(_gaussian_kernel_1d(sigma))
    if not 3 <= len(taps) <= 2 * cuda_build.CANNY_MAX_RADIUS + 1:
        raise ValueError(f"canny: sigma {sigma} gives {len(taps)} taps; the "
                         "kernel takes a radius of 1 to "
                         f"{cuda_build.CANNY_MAX_RADIUS}")
    if h < 2 or w < 2:
        raise ValueError(f"canny: a {h} x {w} image has no reflected border")
    dev = img.device
    cls = torch.empty((h, w), dtype=torch.uint8, device=dev)
    flag = torch.empty((1,), dtype=torch.int32, device=dev)
    mag = torch.empty((h, w), dtype=torch.float32, device=dev) if detail \
        else None
    sec = torch.empty((h, w), dtype=torch.int32, device=dev) if detail \
        else None
    rounds = ctypes.c_int(0)
    with torch.cuda.device(dev):
        lib = cuda_build.lib()
        stream = cuda_build.stream_handle(dev)
        rc = lib.solex_canny_gradients(
            img.data_ptr(), h, w, taps.ctypes.data, len(taps),
            low_threshold, high_threshold, cls.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (mag, sec)),
            flag.data_ptr(), stream)
        cuda_build.check(rc, "canny_gradients")
        if detail:
            _count("kernel")
            return mag, sec
        edges = torch.empty((h, w), dtype=torch.bool, device=dev)
        rc = lib.solex_canny_hysteresis(cls.data_ptr(), edges.data_ptr(), h,
                                        w, flag.data_ptr(),
                                        ctypes.byref(rounds), stream)
        cuda_build.check(rc, "canny_hysteresis")
    _count("kernel", rounds.value)
    return edges


def _check_plain(image: torch.Tensor) -> None:
    if image.device.type != "cpu":
        raise ValueError(f"canny: unsupported device {image.device}")
    _count("plain")


def gradients(image: torch.Tensor, sigma: float = 2.0):
    """(magnitude, sector) of the blurred image, as the JAX Canny's: float32
    and int32 (H, W) on ``image``'s device."""
    if image.device.type == "cuda":
        return _launch_canny(image, sigma, 0.0, 0.0, detail=True)
    _check_plain(image)
    return _gradients_plain(image, sigma)


def canny(image: torch.Tensor, sigma: float = 2.0,
          low_threshold: float = 0.1, high_threshold: float = 0.2
          ) -> torch.Tensor:
    """Boolean edge map (H, W) on ``image``'s device."""
    if image.device.type == "cuda":
        return _launch_canny(image, sigma, low_threshold, high_threshold)
    _check_plain(image)
    return _canny_plain(image, sigma, low_threshold, high_threshold)
