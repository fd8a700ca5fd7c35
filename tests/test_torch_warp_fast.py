"""Separable warp of the PyTorch port (kernel B4's plain version) vs the
JAX package's separable and four-term warps (CPU).

Tolerances:
- port separable vs port four-term: 5e-7, the JAX package's own contract
  (tests/test_warp_fast.py) — only the separable sum order differs.
- port vs JAX: XLA:CPU contracts the coordinate expression
  ``m00*x + m01*y`` into an FMA inside its vectorised loop (and in the
  other operand order in the loop's tail), so a source coordinate can
  differ by one float32 ulp of its magnitude, which moves the output by up
  to that ulp times the tap difference (<= 1).  Bound: 5e-7 + 2 ulp of the
  largest source coordinate; pixels beyond 5e-7 stay under 10% (the
  vector-loop tail is 15 of 400 columns, 3.8%, on an AVX-512 host).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.geometry.ellipse import get_correction_matrix
from solex_ser_recon_en_tpu.ops.warp import (
    warp_projective_u16 as jax_warp_projective_u16,
)
from solex_ser_recon_en_tpu.ops.warp_fast import (
    warp_unit_y_u16 as jax_warp_unit_y_u16,
    warp_unit_y_u16_batched as jax_warp_unit_y_u16_batched,
)
from solex_ser_recon_en_torch.ops.warp import warp_projective_u16
from solex_ser_recon_en_torch.ops.warp_fast import (
    hresample,
    unit_y_row,
    warp_unit_y_u16,
    window_for,
)

from torch_parity import t


def _pipeline_matrix(phi, ratio, tx, ty):
    mat, _ = get_correction_matrix(phi, ratio)
    m3 = np.zeros((3, 3))
    m3[:2, :2] = mat
    m3[2, 2] = 1.0
    return m3 @ np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1.0]])


CASES = [  # tests/test_warp_fast.py:32-40
    # phi, ratio, tx, ty, h, w, out_h, out_w
    (0.15, 0.93, -13.4, 7.3, 300, 257, 310, 270),
    (-0.4, 1.18, 4.2, -9.7, 300, 257, 280, 300),
    (0.0, 1.0, 0.0, 0.0, 128, 128, 128, 128),
    (0.02, 0.78, 100.0, -0.0001, 200, 384, 260, 400),
    (1.2, 1.45, -60.0, 199.5, 220, 150, 230, 160),  # fully off the bottom
    (0.3, 0.9, -5.0, -250.0, 220, 150, 230, 160),   # fully off the top
]


def _jax_bound(m3, oh, ow):
    corners = np.array([[0, 0, 1], [ow, 0, 1], [0, oh, 1], [ow, oh, 1]],
                       dtype=np.float64)
    coord = np.abs(corners @ m3.T)[:, :2].max()
    return 5e-7 + 2 * float(np.spacing(np.float32(coord)))


def _assert_close_to_jax(ours, ref, bound):
    d = np.abs(ours - ref)
    assert d.max() <= bound, (d.max(), bound)
    assert (d > 5e-7).mean() < 0.1


@pytest.mark.parametrize("case", CASES)
def test_separable_matches_jax_and_four_term(case, rng):
    phi, ratio, tx, ty, h, w, oh, ow = case
    m3 = _pipeline_matrix(phi, ratio, tx, ty)
    assert unit_y_row(m3) and window_for(m3) > 0
    img = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    cval = 0.013
    ours = warp_unit_y_u16(t(img), m3, oh, ow,
                           cval=torch.tensor([cval], dtype=torch.float32))
    ours = ours.numpy()
    four = warp_projective_u16(t(img), m3, oh, ow, cval=cval).numpy()
    np.testing.assert_allclose(ours, four, atol=5e-7)

    bound = _jax_bound(m3, oh, ow)
    ref_fast = np.asarray(jax_warp_unit_y_u16(img, m3, oh, ow, cval=cval))
    ref_four = np.asarray(jax_warp_projective_u16(
        jnp.asarray(img), jnp.asarray(m3), oh, ow, cval=cval))
    _assert_close_to_jax(ours, ref_fast, bound)
    _assert_close_to_jax(ours, ref_four, bound)
    _assert_close_to_jax(four, ref_four, bound)


def test_identity_is_exact(rng):
    img = rng.integers(0, 65536, (64, 128)).astype(np.uint16)
    out = warp_unit_y_u16(t(img), np.eye(3), 64, 128,
                          cval=torch.zeros(1, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(out, img.astype(np.float32) / 65536.0)


def test_batched_per_image_cval(rng):
    """A batch with cval=None warps each image with its own [0, 0] pixel,
    bit-identical to the per-image calls."""
    m3 = _pipeline_matrix(0.3, 0.9, -5.0, 3.5)
    imgs = rng.integers(0, 65536, (3, 100, 256)).astype(np.uint16)
    batch = warp_unit_y_u16(t(imgs), m3, 110, 270).numpy()
    for k in range(3):
        one = warp_unit_y_u16(t(imgs[k]), m3, 110, 270).numpy()
        np.testing.assert_array_equal(batch[k], one)
    ref = np.asarray(jax_warp_unit_y_u16_batched(imgs, m3, 110, 270,
                                                 cval=None))
    _assert_close_to_jax(batch, ref, _jax_bound(m3, 110, 270))


def test_hresample_taps_outside_row_contribute_zero():
    """Taps left of column 0 or right of the last column add exactly 0
    (the TPU kernel's unmatched iota), whatever their weight."""
    V = torch.arange(1, 7, dtype=torch.float32).reshape(1, 1, 6)
    loc = torch.tensor([[-2, -1, 0, 4, 5, 7]], dtype=torch.int32)
    w0 = torch.full((1, 6), 0.5)
    w1 = torch.full((1, 6), 0.25)
    cadd = torch.full((1, 1, 6), 0.125)
    out = hresample(V, loc, w0, w1, cadd)[0, 0].tolist()
    assert out == [0.125, 0.25 + 0.125, 0.5 + 0.5 + 0.125,
                   2.5 + 1.5 + 0.125, 3.0 + 0.125, 0.125]
