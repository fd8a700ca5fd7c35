"""Geometric correction: ellipse fit -> circularisation warp.

Counterpart of solex_ser_recon_en_tpu/geometry/correct.py.  reference:
ellipse_to_circle.py:94-145 (correct_image) and :294-342
(ellipse_to_circle).  The 3x3 matrix math stays on the host in float64;
the warp runs on the disk's device: the separable path (ops/warp_fast.py,
kernel B4) for every matrix with second row [0, 1, ty] — all the
pipeline builds — and the four-term warp (ops/warp.py) otherwise.  In the
host pipeline (utils/placement.py, the ``host`` feed) the disks are CPU
tensors and the warp is the native library's (ops/warp.py:warp_host_u16;
a sweep's shifts through ``warp_u16_u16_batch``), as in the JAX package's
host branches.  The ellipse fit's small ops go where the feed puts them
(geometry/edges.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.native import warp_u16_batch
from ..ops.dtypes import widen
from ..ops.warp import warp_host_u16, warp_projective_u16, warp_to_u16
from ..ops.warp_fast import unit_y_row, warp_unit_y_u16, window_for
from ..utils.placement import host_pipeline, small_ops_device
from ..utils.timer import span
from .edges import get_edge_list
from .ellipse import get_correction_matrix, two_step

Circle = Tuple[float, float, float]
NO_CIRCLE: Circle = (-1, -1, -1)


@dataclass
class GeometryResult:
    image: Optional[torch.Tensor]  # corrected uint16 image (None: not warped)
    circle: Circle                 # (cx, cy, radius) or NO_CIRCLE
    ratio: float
    phi: float                     # radians
    borders: list                  # [minx, miny, maxx, maxy] in corrected frame
    mat3: np.ndarray = None
    # diagnostics for the _ellipse_fit.png plot
    raw_edges: np.ndarray = None
    kept_edges: np.ndarray = None
    ellipse_pts: np.ndarray = None


def _correction_mat3(shape, phi: float, ratio: float):
    """(mat, theta, mat3, tx, ty, out_h, out_w) for an image of ``shape``."""
    mat, theta = get_correction_matrix(phi, ratio)
    mat3 = np.zeros((3, 3))
    mat3[:2, :2] = mat
    mat3[2, 2] = 1.0
    h, w = shape
    corners = np.array([[0, 0], [0, h], [w, 0], [w, h]], dtype=np.float64)
    new_corners = (np.linalg.inv(mat) @ corners.T).T
    new_h = float(np.max(new_corners[:, 1]) - np.min(new_corners[:, 1]))
    new_w = float(np.max(new_corners[:, 0]) - np.min(new_corners[:, 0]))
    tx, ty = float(np.min(new_corners[:, 0])), float(np.min(new_corners[:, 1]))
    mat3 = mat3 @ np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1.0]])
    return (mat, theta, mat3, tx, ty, int(math.ceil(new_h)),
            int(math.ceil(new_w)))


def correction_geometry(
    shape: Tuple[int, int],
    phi: float,
    ratio: float,
    center: np.ndarray,
    height: float,
    log: Optional[Callable[[str], None]] = None,
) -> Tuple[Circle, np.ndarray, int, int]:
    """The pure-matrix half of correct_image: (circle, mat3, out_h, out_w).

    reference: ellipse_to_circle.py:94-111,119-145.
    """
    mat, theta, mat3, tx, ty, out_h, out_w = _correction_mat3(shape, phi, ratio)
    new_center = (
        np.linalg.inv(mat) @ np.asarray(center, dtype=np.float64).T
    ).T - np.array([tx, ty])
    new_radius = height * np.sqrt(np.abs(ratio / np.linalg.det(mat)))
    if log is not None:
        np.set_printoptions(suppress=True)
        log("Y/X ratio : " + "{:.3f}".format(ratio))
        log("Tilt angle : " + "{:.3f}".format(math.degrees(phi)) + " degrees")
        log("Linear transform correction matrix : \n" + str(mat))
        log(
            "Disk position, radius : "
            + (
                (str(new_center) + ", " + "{:.3f}".format(new_radius))
                if height != -1.0
                else "UNKNOWN"
            )
        )
        log("Unrotation : " + "{:.3f}".format(math.degrees(theta)) + " degrees")
        np.set_printoptions(suppress=False)
    circle = (float(new_center[0]), float(new_center[1]), float(new_radius))
    return circle, mat3, out_h, out_w


def _warp_u16(images: torch.Tensor, mat3: np.ndarray, out_h: int,
              out_w: int) -> torch.Tensor:
    """Warp uint16 images (K, h, w), each with cval = its [0, 0] pixel,
    -> uint16 (K, out_h, out_w).  In the host pipeline: the native warp
    of CPU tensors (one image: ``warp_u16_u16``; several:
    ``warp_u16_u16_batch``)."""
    if host_pipeline():
        ds = [im.numpy() for im in images]
        cvals = [float(d[0, 0]) / 65536.0 for d in ds]
        if len(ds) == 1:
            warped = warp_host_u16(ds[0], mat3, out_h, out_w, cvals[0])[None]
        else:
            warped = warp_u16_batch(ds, mat3, out_h, out_w, cvals, None)
        return torch.from_numpy(warped)
    if unit_y_row(mat3) and window_for(mat3) > 0:
        return warp_to_u16(warp_unit_y_u16(images, mat3, out_h, out_w))
    cvals = widen(images[:, 0, 0]).cpu().numpy() / 65536.0
    return torch.stack([
        warp_to_u16(warp_projective_u16(img, mat3, out_h, out_w, float(cv)))
        for img, cv in zip(images, cvals)
    ])


def correct_image(
    image: torch.Tensor,
    phi: float,
    ratio: float,
    center: np.ndarray,
    height: float,
    log: Optional[Callable[[str], None]] = None,
) -> Tuple[torch.Tensor, Circle, np.ndarray]:
    """Circularise a uint16 ``image`` given the ellipse tilt/ratio: builds
    the inverse map, translates so nothing clips, warps with cval =
    image[0, 0], rescales the circle.  Returns (uint16 image, circle, mat3).
    """
    circle, mat3, out_h, out_w = correction_geometry(
        image.shape, phi, ratio, center, height, log=log
    )
    return _warp_u16(image[None], mat3, out_h, out_w)[0], circle, mat3


def correct_images_batched(
    disks: torch.Tensor,
    phi: float,
    ratio: float,
    log: Optional[Callable[[str], None]] = None,
):
    """Circularise a stack of uint16 disks (K, ih, F) sharing one (phi,
    ratio) — a Doppler sweep — in one batched warp.  Same per-image result
    as correct_image(center=-1, height=-1).  Returns (uint16 (K, H', W'),
    circle, mat3)."""
    mat, theta, mat3, tx, ty, out_h, out_w = _correction_mat3(
        disks.shape[1:], phi, ratio
    )
    warped = _warp_u16(disks, mat3, out_h, out_w)
    new_center = (np.linalg.inv(mat) @ np.array([-1.0, -1.0]).T).T - np.array([tx, ty])
    new_radius = -1.0 * np.sqrt(np.abs(ratio / np.linalg.det(mat)))
    if log is not None:
        np.set_printoptions(suppress=True)
        log("Y/X ratio : " + "{:.3f}".format(ratio))
        log("Tilt angle : " + "{:.3f}".format(math.degrees(phi)) + " degrees")
        log("Linear transform correction matrix : \n" + str(mat))
        log("Disk position, radius : UNKNOWN")
        log("Unrotation : " + "{:.3f}".format(math.degrees(theta)) + " degrees")
        np.set_printoptions(suppress=False)
    circle = (float(new_center[0]), float(new_center[1]), float(new_radius))
    return warped, circle, mat3


def downscale_mean(image_u16: torch.Tensor, factor: int = 4) -> np.ndarray:
    """Zero-padded block mean of image/65536 on the device -> host float64.

    Block sums of u16/65536 values are exact in float32, so the mean is
    exact whatever the summation order."""
    h, w = image_u16.shape
    ph, pw = (-h) % factor, (-w) % factor
    img = widen(image_u16).to(torch.float32) / 65536.0
    if ph or pw:
        img = F.pad(img, (0, pw, 0, ph))
    small = img.reshape((h + ph) // factor, factor, (w + pw) // factor,
                        factor).mean(dim=(1, 3))
    return small.cpu().numpy().astype(np.float64)


def ellipse_to_circle(
    image_u16: torch.Tensor,
    log: Optional[Callable[[str], None]] = None,
    need_image: bool = True,
) -> GeometryResult:
    """Fit the limb ellipse on a disk image and circularise it.

    reference: ellipse_to_circle.py:294-342 — edges on a 4x block-mean
    downscale (on the device), scaled back; the ellipse fit gives (phi,
    ratio); the warp circularises; borders come from the kept edge points
    mapped into the corrected frame.  ``need_image=False`` skips the warp
    (the hidden ellipse-fit shift yields no product).
    """
    factor = 4
    with span("downscale"):
        small = downscale_mean(image_u16, factor)
    X, raw_X = get_edge_list(small, small_ops_device(image_u16.device))
    with span("fit"):
        X = X * factor
        raw_X = raw_X * factor
        center_yx, height, phi, ratio, X_f, ell_pts = two_step(X)
        center = np.array([center_yx[1], center_yx[0]])  # (x, y)

        if need_image:
            fixed, circle, mat3 = correct_image(
                image_u16, phi, ratio, center, height, log=log
            )
        else:
            fixed = None
            circle, mat3, _, _ = correction_geometry(
                image_u16.shape, phi, ratio, center, height, log=log
            )

        # transform kept edge points into the corrected frame for the borders
        pts = np.ones((X_f.shape[0], 3))
        pts[:, 0] = X_f[:, 1]  # x
        pts[:, 1] = X_f[:, 0]  # y
        pts_t = (np.linalg.inv(mat3) @ pts.T).T
        borders = [
            float(np.min(pts_t[:, 0])),
            float(np.min(pts_t[:, 1])),
            float(np.max(pts_t[:, 0])),
            float(np.max(pts_t[:, 1])),
        ]
    return GeometryResult(
        image=fixed,
        circle=circle,
        ratio=float(ratio),
        phi=float(phi),
        borders=borders,
        mat3=mat3,
        raw_edges=raw_X,
        kept_edges=X_f,
        ellipse_pts=ell_pts * 1.0,
    )
