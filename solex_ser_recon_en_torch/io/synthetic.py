"""Synthetic spectroheliograph scan generator (test/bench fixture).

The port's own copy of solex_ser_recon_en_tpu/io/synthetic.py: the same
seed gives the same frames.

Renders a physically-plausible fake Sol'Ex scan with *known* ground truth so
every pipeline stage has an analytically checkable answer:

- each frame is a slit spectrum: rows = spatial position along the slit,
  columns = wavelength; a dark absorption line runs down the frame following
  a known cubic curve ``x = c0 + c1*y + c2*y^2 + c3*y^3`` (what the line-fit
  stage must recover; reference consumer: solex_util.py:191-274),
- the Sun drifts across the slit over F frames, so the per-frame brightness
  envelope is a column of a known (possibly sheared/stretched) solar disk
  (what the recon + ellipse-fit stages must recover;
  reference: solex_util.py:93-144, ellipse_to_circle.py:294-342),
- optional per-row gain stripes (transversalium;
  reference: solex_util.py:383-516) and vignette (solex_util.py:590-654).

The SER container layout is the reference's (video_reader.py:31-66).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from .ser import write_ser


@dataclass
class SyntheticScan:
    """Ground truth + parameters of a generated scan."""

    ih: int = 256            # spatial rows (slit length)
    iw: int = 96             # spectral columns
    frames: int = 200        # scan length
    depth: int = 16          # SER pixel depth (8 or 16)
    # spectral line: cubic x(y) = c0+c1 y+c2 y^2+c3 y^3 (pixels)
    line_poly: Tuple[float, float, float, float] = (48.0, 0.0, 0.0, 0.0)
    line_width: float = 3.0      # Gaussian sigma of the absorption dip
    line_depth: float = 0.75     # fractional dip depth at line centre
    # solar disk in the reconstructed (y=row, f=frame) plane
    disk_center: Optional[Tuple[float, float]] = None  # (f, y); default centred
    disk_radius: Optional[float] = None
    squash_y: float = 1.0        # Y/X ratio of the rendered ellipse (<1 squashes y)
    shear: float = 0.0           # x' = x + shear*(y - cy): tilt in the disk plane
    limb_darkening: float = 0.5  # u in I = 1 - u*(1-mu)
    continuum: float = 0.82      # peak continuum level (fraction of full scale)
    sky: float = 0.004           # background level off-disk
    trans_stripes: float = 0.0   # amplitude of per-row gain stripes (e.g. 0.15)
    trans_period: float = 13.0   # stripe pattern period in rows
    vignette: float = 0.0        # parabolic row-gain droop amplitude
    noise: float = 0.0           # Gaussian noise sigma (fraction of full scale)
    seed: int = 0
    # optional full spectral transmission: called with the per-pixel offset
    # from the line centre (ih, iw array, pixels) and must return the
    # transmission in [0, 1].  Overrides the single-Gaussian line profile —
    # used to render scans whose spectrum comes from a solar atlas window
    # (analyser dispersion validation).
    spectrum_fn: Optional[object] = field(default=None, repr=False)
    # filled in by generate()
    row_gain: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        if self.disk_center is None:
            self.disk_center = (self.frames / 2.0, self.ih / 2.0)
        if self.disk_radius is None:
            self.disk_radius = 0.38 * min(self.frames, self.ih)

    # ------------------------------------------------------------------
    def line_center(self, y: np.ndarray) -> np.ndarray:
        c0, c1, c2, c3 = self.line_poly
        return c0 + c1 * y + c2 * y * y + c3 * y * y * y

    def disk_brightness(self) -> np.ndarray:
        """(ih, frames) float in [0,1]: the ideal reconstructed disk."""
        y = np.arange(self.ih, dtype=np.float64)[:, None]
        f = np.arange(self.frames, dtype=np.float64)[None, :]
        cf, cy = self.disk_center
        dy = (y - cy) / self.squash_y
        dx = (f - cf) - self.shear * (y - cy)
        rho2 = (dx * dx + dy * dy) / self.disk_radius**2
        inside = rho2 < 1.0
        mu = np.sqrt(np.clip(1.0 - rho2, 0.0, 1.0))
        limb = 1.0 - self.limb_darkening * (1.0 - mu)
        return np.where(inside, limb, 0.0)

    # ------------------------------------------------------------------
    def generate(self, block: int = 256) -> np.ndarray:
        """Render frames (F, ih, iw) in the *normalised* orientation
        (spatial = rows, spectral = cols, ih >= iw).

        Rendered in float32 frame blocks so multi-GB scans stay fast and
        memory-bounded on a small host.
        """
        rng = np.random.default_rng(self.seed)
        y = np.arange(self.ih, dtype=np.float64)
        x = np.arange(self.iw, dtype=np.float64)
        center = self.line_center(y)[:, None]                  # (ih, 1)
        if self.spectrum_fn is not None:
            prof = np.asarray(
                self.spectrum_fn(x[None, :] - center), dtype=np.float32
            )                                                  # (ih, iw)
        else:
            prof = (
                1.0
                - self.line_depth
                * np.exp(-0.5 * ((x[None, :] - center) / self.line_width) ** 2)
            ).astype(np.float32)                               # (ih, iw)

        disk = self.disk_brightness()                          # (ih, F)
        gain = np.ones(self.ih)
        if self.trans_stripes:
            gain *= 1.0 + self.trans_stripes * np.sin(
                2 * np.pi * y / self.trans_period
            ) * np.sin(0.5 + 2 * np.pi * y / (self.trans_period * 2.7))
        if self.vignette:
            gain *= 1.0 - self.vignette * ((y - self.ih / 2) / (self.ih / 2)) ** 2
        self.row_gain = gain

        env = ((self.sky + (self.continuum - self.sky) * disk) * gain[:, None]).astype(
            np.float32
        )
        full = np.float32(255.0 if self.depth == 8 else 65535.0)
        dtype = np.uint8 if self.depth == 8 else np.uint16
        out = np.empty((self.frames, self.ih, self.iw), dtype=dtype)
        for f0 in range(0, self.frames, block):
            f1 = min(f0 + block, self.frames)
            img = env.T[f0:f1, :, None] * prof[None, :, :]
            if self.noise:
                img += np.float32(self.noise) * rng.standard_normal(
                    img.shape, dtype=np.float32
                )
            np.multiply(img, full, out=img)
            np.clip(img, 0, full, out=img)
            out[f0:f1] = img.astype(dtype)
        return out

    def write(self, path: str, transpose_to_wide: bool = False) -> np.ndarray:
        """Generate and write a SER file; returns the normalised frames
        exactly as a reader will see them (uint16; 8-bit upscaled x256).

        With ``transpose_to_wide`` the on-disk frames are stored with
        Width > Height to exercise the auto-rotate path
        (video_reader.py:84-91): disk layout is rot90^-1 of normalised.
        """
        frames = self.generate()
        if transpose_to_wide:
            on_disk = np.rot90(frames, k=-1, axes=(1, 2))
        else:
            on_disk = frames
        write_ser(path, on_disk, pixel_depth=self.depth)
        if self.depth == 8:
            return frames.astype(np.uint16) << 8
        return frames
