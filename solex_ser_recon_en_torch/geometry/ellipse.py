"""Direct least-squares ellipse fit and the circularisation matrix.

A numpy copy of solex_ser_recon_en_tpu/geometry/ellipse.py (that package
imports jax on import, so the port carries its own copy).

reference: ellipse_to_circle.py:35-91 — the reference uses the ``lsq-ellipse``
package (Halir & Flusser's numerically-stable direct conic LSQ) plus a
two-pass outlier-rejecting fit (``two_step``) and a 2x2 stretch+unrotate
correction matrix.  We implement Halir-Flusser ourselves (host numpy: the
edge sets are a few hundred points, float64 wanted) with the same parameter
conventions, so downstream math matches.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def rot(x: float) -> np.ndarray:
    """Rotation convention of the reference (ellipse_to_circle.py:35-36)."""
    return np.array([[np.cos(x), np.sin(x)], [-np.sin(x), np.cos(x)]])


def get_correction_matrix(phi: float, r: float) -> Tuple[np.ndarray, float]:
    """Inverse of the stretch-then-unrotate map that circularises the disk.

    reference: ellipse_to_circle.py:39-50 — stretch by r along the phi axis,
    unrotate by theta so the result is axis-aligned, normalise so the matrix
    has bottom row [0, 1].
    """
    stretch = rot(phi) @ np.array([[r, 0.0], [0.0, 1.0]]) @ rot(-phi)
    theta = np.arctan(stretch[1, 0] / stretch[0, 0])
    correction = rot(theta) @ stretch
    correction[1, 0] = 0.0
    correction /= correction[1, 1]
    return np.linalg.inv(correction), float(theta)


def fit_ellipse(points: np.ndarray):
    """Halir-Flusser direct least-squares conic fit.

    points: (N, 2) in (u, v) coordinates.
    Returns (center (2,), width, height, phi): semi-axis ``width`` along the
    direction at angle ``phi`` from the u-axis, ``height`` perpendicular —
    the same convention as lsq-ellipse's ``as_parameters`` consumed at
    ellipse_to_circle.py:57-59.
    """
    pts = np.asarray(points, dtype=np.float64)
    u, v = pts[:, 0], pts[:, 1]
    D1 = np.stack([u * u, u * v, v * v], axis=1)
    D2 = np.stack([u, v, np.ones_like(u)], axis=1)
    S1 = D1.T @ D1
    S2 = D1.T @ D2
    S3 = D2.T @ D2
    T = -np.linalg.solve(S3, S2.T)
    M = S1 + S2 @ T
    # premultiply by C1^-1, C1 = [[0,0,2],[0,-1,0],[2,0,0]]
    M = np.array([M[2] / 2.0, -M[1], M[0] / 2.0])
    eigval, eigvec = np.linalg.eig(M)
    cond = 4 * eigvec[0] * eigvec[2] - eigvec[1] ** 2
    a1 = eigvec[:, np.real(cond) > 0][:, 0].real
    coef = np.concatenate([a1, T @ a1])  # a, b, c, d, e, f
    a, b, c, d, e, f = coef

    # conic -> geometric parameters
    A = np.array([[a, b / 2.0], [b / 2.0, c]])
    bvec = np.array([d, e])
    center = -0.5 * np.linalg.solve(A, bvec)
    k0 = f - 0.25 * bvec @ np.linalg.solve(A, bvec)
    lam, vecs = np.linalg.eigh(A)  # ascending
    axes2 = -k0 / lam
    if np.any(axes2 <= 0):
        raise ValueError("conic fit is not an ellipse")
    semi = np.sqrt(axes2)
    # width = axis along eigvec[:,0]'s angle
    phi = math.atan2(vecs[1, 0], vecs[0, 0])
    width, height = float(semi[0]), float(semi[1])
    # normalise phi into (-pi/2, pi/2]
    if phi <= -math.pi / 2:
        phi += math.pi
    elif phi > math.pi / 2:
        phi -= math.pi
    return center, width, height, phi


def ellipse_points(center, width, height, phi, n: int = 100) -> np.ndarray:
    """Parametric sample of the fitted ellipse (diagnostics plot)."""
    t = np.linspace(0, 2 * np.pi, n)
    u = width * np.cos(t)
    v = height * np.sin(t)
    R = np.array([[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]])
    pts = (R @ np.stack([u, v])).T + np.asarray(center)
    return pts


def two_step(points: np.ndarray):
    """Two-pass ellipse fit with radial-outlier rejection and phi folding.

    reference: ellipse_to_circle.py:62-91.  Returns
    (center (2,), height, phi, ratio, kept_points, ellipse_pts).
    """
    center, width, height, phi = fit_ellipse(points)
    mat, _ = get_correction_matrix(phi, height / width)
    Xr = mat @ (points - np.asarray(center)).T * height
    values = np.linalg.norm(Xr, axis=0) - 1
    kept = points[values > -np.max(values)]
    center, width, height, phi = fit_ellipse(kept)
    ell_pts = ellipse_points(center, width, height, phi)
    ratio = width / height
    # fold phi into +/- pi/4 by relabelling the axes (reference :81-89)
    for _ in range(2):
        if phi > math.pi / 4:
            phi -= math.pi / 2
            ratio = 1 / ratio
            height = height / ratio
        if phi < -math.pi / 4:
            phi += math.pi / 2
            ratio = 1 / ratio
            height = height / ratio
    return np.asarray(center), height, phi, ratio, kept, ell_pts
