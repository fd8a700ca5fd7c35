"""The benchmark's synthetic Sol'Ex scan: rendered on the device from the
seed and written as a SER file.

The model is a frozen copy of ``SyntheticScan`` (the port's
``io/synthetic.py``): each frame is a slit spectrum with a dark absorption
line on a known cubic, the Sun drifts across the slit so each frame's
brightness envelope is one column of a limb-darkened, squashed and sheared
disk, and per-row gain stripes imitate transversalium.  The two small
factors of every pixel, the envelope (rows x frames) and the line profile
(rows x columns), are computed in numpy float64 and cast to float32 as
``SyntheticScan.generate`` does; their float32 product, the noise, the
scaling and the integer cast run with torch on the device in frame blocks.
Without noise the frames equal ``SyntheticScan``'s bit for bit; the noise
comes from a ``torch.Generator`` seeded with ``--seed`` instead of numpy's
generator, with the same sigma.

The frames are stored wide (Width > Height, the auto-rotate path).  The
program is handed the file's path.
"""

from __future__ import annotations

import os
import struct
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

SER_HEADER = struct.Struct("<14s7I40s40s40sqq")   # 178 bytes


@dataclass
class ScanModel:
    """Geometry and the assumed synthetic parameters of one configuration."""

    frames: int
    ih: int                  # spatial rows (slit length, normalised)
    iw: int                  # spectral columns (normalised)
    depth: int               # SER pixel depth, 8 or 16
    line_poly: Tuple[float, float, float, float]
    squash_y: float
    shear: float
    disk_radius: float
    trans_stripes: float
    noise: float
    line_width: float = 3.0
    line_depth: float = 0.75
    limb_darkening: float = 0.5
    continuum: float = 0.82
    sky: float = 0.004
    trans_period: float = 13.0
    stored_wide: bool = True
    disk_center: Optional[Tuple[float, float]] = field(default=None)

    def __post_init__(self):
        if self.disk_center is None:
            self.disk_center = (self.frames / 2.0, self.ih / 2.0)

    @classmethod
    def from_config(cls, cfg: dict) -> "ScanModel":
        a = cfg["assumed"]
        return cls(
            frames=int(cfg["frames"]), ih=int(cfg["slit_px"]),
            iw=int(cfg["spectral_px"]), depth=int(cfg["bit_depth"]),
            line_poly=tuple(float(c) for c in a["line_poly"]),
            squash_y=float(a["squash_y"]), shear=float(a["shear"]),
            disk_radius=float(int(a["disk_radius_frames"] * cfg["frames"])),
            trans_stripes=float(a["trans_stripes"]), noise=float(a["noise"]),
            stored_wide=bool(cfg["stored_wide"]))

    # -- the small factors (numpy float64, as SyntheticScan) ---------------
    def line_center(self, y: np.ndarray) -> np.ndarray:
        c0, c1, c2, c3 = self.line_poly
        return c0 + c1 * y + c2 * y * y + c3 * y * y * y

    def disk_brightness(self) -> np.ndarray:
        """(ih, frames) float64 in [0, 1]: the ideal reconstructed disk."""
        y = np.arange(self.ih, dtype=np.float64)[:, None]
        f = np.arange(self.frames, dtype=np.float64)[None, :]
        cf, cy = self.disk_center
        dy = (y - cy) / self.squash_y
        dx = (f - cf) - self.shear * (y - cy)
        rho2 = (dx * dx + dy * dy) / self.disk_radius ** 2
        mu = np.sqrt(np.clip(1.0 - rho2, 0.0, 1.0))
        limb = 1.0 - self.limb_darkening * (1.0 - mu)
        return np.where(rho2 < 1.0, limb, 0.0)

    def factors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(envelope (ih, frames), profile (ih, iw)), both float32."""
        y = np.arange(self.ih, dtype=np.float64)
        x = np.arange(self.iw, dtype=np.float64)
        center = self.line_center(y)[:, None]
        prof = (1.0 - self.line_depth * np.exp(
            -0.5 * ((x[None, :] - center) / self.line_width) ** 2)
        ).astype(np.float32)
        gain = np.ones(self.ih)
        if self.trans_stripes:
            gain *= 1.0 + self.trans_stripes * np.sin(
                2 * np.pi * y / self.trans_period) * np.sin(
                0.5 + 2 * np.pi * y / (self.trans_period * 2.7))
        env = ((self.sky + (self.continuum - self.sky)
                * self.disk_brightness()) * gain[:, None]).astype(np.float32)
        return env, prof

    @property
    def stored_shape(self) -> Tuple[int, int]:
        """(Height, Width) of a frame as stored in the SER file."""
        return (self.iw, self.ih) if self.stored_wide else (self.ih, self.iw)

    @property
    def sample_bytes(self) -> int:
        return 1 if self.depth == 8 else 2

    @property
    def payload_bytes(self) -> int:
        return self.frames * self.ih * self.iw * self.sample_bytes

    def header(self) -> bytes:
        h, w = self.stored_shape
        return SER_HEADER.pack(b"LUCAM-RECORDER", 0, 0, 1, w, h, self.depth,
                               self.frames, b"\0" * 40, b"\0" * 40,
                               b"\0" * 40, 0, 0)


def render_blocks(model: ScanModel, seed: int, device, block: int = 64):
    """Yield (first frame, stored frames (n, Height, Width)) on ``device``,
    as int16 (16-bit, the bits of the uint16 samples) or uint8 tensors."""
    import torch

    env, prof = model.factors()
    env_t = torch.from_numpy(np.ascontiguousarray(env.T)).to(device)
    prof_t = torch.from_numpy(prof).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    full = 255.0 if model.depth == 8 else 65535.0
    noise = torch.tensor(model.noise, dtype=torch.float32, device=device)
    for f0 in range(0, model.frames, block):
        f1 = min(f0 + block, model.frames)
        img = env_t[f0:f1, :, None] * prof_t[None, :, :]
        if model.noise:
            z = torch.randn(img.shape, generator=gen, dtype=torch.float32,
                            device=device)
            img += z * noise
        img *= full
        img.clamp_(0.0, full)
        q = img.to(torch.int32)
        q = q.to(torch.uint8) if model.depth == 8 else q.to(torch.int16)
        if model.stored_wide:
            q = torch.rot90(q, k=-1, dims=(1, 2))
        yield f0, q.contiguous()


class ScanFile:
    """The scan as a SER file at ``path``, written from the device block by
    block and flushed to storage, so that its pages sit clean in the page
    cache, as a scan read moments ago does, and no write-back runs later."""

    def __init__(self, model: ScanModel, seed: int, device, path: str):
        self.model = model
        self.path = path
        self.size = SER_HEADER.size + model.payload_bytes
        self.seconds = {}
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            f.write(model.header())
            for _, blk in render_blocks(model, seed, device):
                f.write(memoryview(blk.cpu().numpy()).cast("B"))
            t1 = time.perf_counter()
            f.flush()
            os.fsync(f.fileno())
        self.seconds = {"render_write": t1 - t0,
                        "fsync": time.perf_counter() - t1}

    def close(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
