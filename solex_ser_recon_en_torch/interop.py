"""Carry stage state from the JAX package's results into this package.

The system has no learned weights; what passes from one stage to the next
is the ``Options`` dataclass (each package has its own copy, with the same
fields), the line fit, the ellipse geometry (with the edge points its
figure reads), the FITS header, the transversalium gains and the disks.  These
helpers turn the JAX package's results (numpy fields, or arrays that
``np.asarray`` accepts) into this package's stage inputs, so a test can
feed each port stage exactly what the JAX stage before it produced.  No
jax import: the arrays are converted through numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry.correct import GeometryResult
from .geometry.linefit import LineFit
from .pipeline.run import ScanResult


def tensor(a, device="cpu") -> torch.Tensor:
    """Any array (numpy, JAX) -> a tensor on ``device`` (copied)."""
    return torch.from_numpy(np.array(np.asarray(a), copy=True)).to(device)


def _optional(a, dtype=None):
    return None if a is None else np.array(np.asarray(a), dtype=dtype,
                                           copy=True)


def linefit(lf) -> LineFit:
    """The JAX LineFit's numpy fields -> the port's LineFit."""
    return LineFit(
        poly=np.asarray(lf.poly, dtype=np.float64),
        curve=np.asarray(lf.curve, dtype=np.float64),
        floor=np.asarray(lf.floor, dtype=np.int64),
        frac=np.asarray(lf.frac, dtype=np.float64),
        y1=int(lf.y1),
        y2=int(lf.y2),
        sharp_min=_optional(getattr(lf, "sharp_min", None)),
        mask_good=_optional(getattr(lf, "mask_good", None)),
    )


def geometry(geo, device="cpu") -> GeometryResult:
    """The JAX GeometryResult -> the port's (image as a tensor), with what
    the ellipse-fit figure reads."""
    return GeometryResult(
        image=None if geo.image is None else tensor(geo.image, device),
        circle=tuple(float(v) for v in geo.circle),
        ratio=float(geo.ratio),
        phi=float(geo.phi),
        borders=[float(v) for v in geo.borders],
        mat3=np.asarray(geo.mat3, dtype=np.float64),
        raw_edges=_optional(geo.raw_edges, np.float64),
        kept_edges=_optional(geo.kept_edges, np.float64),
        ellipse_pts=_optional(geo.ellipse_pts, np.float64),
    )


def gains(c) -> np.ndarray:
    """Transversalium gain vector (H,) -> float64 numpy."""
    return np.asarray(c, dtype=np.float64)


def scan_result(scan, device="cpu") -> ScanResult:
    """The JAX read_scan result (device-feed form: one (S, ih, F) disk
    array) -> the port's ScanResult with the disks on ``device``."""
    return ScanResult(
        disk_list=tensor(scan.disk_list, device),
        shifts=list(scan.shifts),
        shift_requested=list(scan.shift_requested),
        backup_bounds=tuple(int(v) for v in scan.backup_bounds),
        header=dict(scan.header),
        basefich0=scan.basefich0,
        mean_img=scan.mean_img,
        linefit=None if scan.linefit is None else linefit(scan.linefit),
    )
