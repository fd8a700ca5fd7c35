"""Host (numpy) warp twins — jax-free module.

Split out of ops/warp.py so jax-free consumers (benchmarks/refshims — the
reference's forked Pool workers must never touch a jax-threaded parent)
can load this file directly without importing the package.
"""

from __future__ import annotations


def warp_projective_host(
    image: "np.ndarray",
    mat3: "np.ndarray",
    out_h: int,
    out_w: int,
    cval: float = 0.0,
):
    """numpy float32 twin of warp_projective for the host pipeline.

    On CPU-only (or throttled-link host-mode) runs the warp is the last
    XLA dispatch left in the pipeline; this twin mirrors the device math
    op for op in float32 (same grid, same four-tap constant-cval
    bilinear), agreeing to reduction-order rounding (<=1 LSB after the
    u16 store, the tolerance every warp consumer already grants).
    """
    import numpy as np

    image = image.astype(np.float32, copy=False)
    h, w_in = image.shape
    xs = np.arange(out_w, dtype=np.float32)
    ys = np.arange(out_h, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    m = mat3.astype(np.float32)
    w = m[2, 0] * gx + m[2, 1] * gy + m[2, 2]
    sx = (m[0, 0] * gx + m[0, 1] * gy + m[0, 2]) / w
    sy = (m[1, 0] * gx + m[1, 1] * gy + m[1, 2]) / w

    cval = np.float32(cval)
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    dx = (sx - x0).astype(np.float32)
    dy = (sy - y0).astype(np.float32)
    x0i = x0.astype(np.int32)
    y0i = y0.astype(np.int32)
    flat = image.reshape(-1)

    def sample(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w_in)
        yc = np.clip(yi, 0, h - 1)
        xc = np.clip(xi, 0, w_in - 1)
        return np.where(valid, flat[yc * w_in + xc], cval)

    out = (
        sample(y0i, x0i) * (1 - dy) * (1 - dx)
        + sample(y0i, x0i + 1) * (1 - dy) * dx
        + sample(y0i + 1, x0i) * dy * (1 - dx)
        + sample(y0i + 1, x0i + 1) * dy * dx
    )
    return out



def warp_to_u16_host(warped01: "np.ndarray"):
    """numpy twin of warp_to_u16 (clip-instead-of-wrap u16 store)."""
    import numpy as np

    return np.clip(warped01 * 65536.0, 0, 65535).astype(np.uint16)
