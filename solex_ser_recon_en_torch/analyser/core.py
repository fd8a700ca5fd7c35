"""Headless spectral-analyser core.

Counterpart of solex_ser_recon_en_tpu/analyser/core.py.  reference:
spectralAnalyserUI.py:60-391 — load a scan fully, locate the anchor line,
find the dispersion by correlating the log spectrum against a solar atlas
over a grid of Å/px guesses, convert GOTO wavelengths into pixel shifts,
and preview or save the reconstruction at any shift.

On the card a session uploads the normalised slab once (``transfer_count``)
and keeps it resident: pass A's kernel (ops/fused_cuda.py:mean_max) runs
once over it, every recon is kernel B3 on it with ``rotate=False``
(ops/recon.py:reconstruct), and each preview or save warps with B4 and
builds its products with B5.  The dispersion search is one batched torch program over
the K = 3W scale guesses (``_corr_scan``; the JAX package vmaps it, and no
Pallas kernel is involved).  A session on a slow link (``_pick_recon_mode``)
uploads nothing: its recon is the host's float64 loop and its post-
processing the host pipeline (utils/placement.py).

Not ported: the JAX ``d2h_responsive`` relay probe of ``_pick_recon_mode``
(a CPU fallback for a remote link's dead downlink) and the nearest-index
fallback of ``_downscale`` where cv2 is absent (the preview uses
ops/resize.py everywhere).
"""

from __future__ import annotations

import math
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Options
from ..geometry.correct import NO_CIRCLE, correct_image, ellipse_to_circle
from ..geometry.linefit import fit_spectral_line
from ..io.feeder import cached_probe_rate, probe_transfer_rate
from ..io.fits import make_header
from ..io.hostreduce import host_mean_max_frames
from ..io.png import write_png_streaming
from ..io.video import open_video
from ..ops.dtypes import as_int16, widen
from ..ops.fused_cuda import mean_max
from ..ops.recon import build_shift_indices, reconstruct
from ..ops.resize import resize_linear
from ..pipeline.run import single_image_process
from ..utils import placement
from ..utils.device import resolve_device, synchronize
from ..utils.timer import StageTimer
from .atlas import SolarAtlas, anchor_table, load_atlas, target_table

#: a slab of at most this many bytes is uploaded without rating the link
SMALL_SLAB_BYTES = 64 * 1024 * 1024
#: the longest upload a session accepts, seconds at the probed rate
MAX_UPLOAD_S = 2.0


def _corr_scan(spectrum_log: torch.Tensor, atlas_first: torch.Tensor,
               atlas_step: torch.Tensor, intensity: torch.Tensor,
               scales: torch.Tensor, anchor_x: torch.Tensor,
               anchor_wl: torch.Tensor, exc_width: int = 5) -> torch.Tensor:
    """Correlation (K,) of the log spectrum (W,) with the atlas resampled
    at each of the K scales, float32 on the tensors' device; the scalars
    are 0-d float32 tensors there (a division by a host scalar would be a
    multiply by its reciprocal on the card)."""
    W = spectrum_log.shape[0]
    xs = torch.arange(W, dtype=torch.float32, device=spectrum_log.device)
    dx = xs - anchor_x
    mask = torch.abs(dx) >= exc_width
    # the excluded anchor region is filled with the global mean (reference
    # spectralAnalyserUI.py:290-292)
    lspec = torch.where(mask, spectrum_log, spectrum_log.mean())
    lam = anchor_wl + dx[None, :] * scales[:, None]                 # (K, W)
    n = intensity.shape[0]
    idx = torch.clamp((lam - atlas_first) / atlas_step, 0.0, n - 1.001)
    i0 = torch.floor(idx)
    frac = idx - i0
    i0 = i0.long()
    # out-of-range taps clamp, as the JAX gather does
    a = (intensity[i0.clamp(max=n - 1)] * (1 - frac)
         + intensity[(i0 + 1).clamp(max=n - 1)] * frac)
    a = torch.where(mask, a, a.mean(dim=1, keepdim=True))
    ac = a - a.mean(dim=1, keepdim=True)
    sc = lspec - lspec.mean()
    denom = torch.sqrt((ac * ac).sum(dim=1) * (sc * sc).sum())
    return (ac * sc).sum(dim=1) / torch.clamp(denom, min=1e-30)


def auto_dispersion(
    spectrum: np.ndarray,
    anchor_x: float,
    anchor_wavelength: float,
    atlas: SolarAtlas,
    scale_range: Tuple[float, float] = (0.02, 0.12),
    n_guesses: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> Tuple[float, float]:
    """Best-correlating dispersion (Å/px) and its correlation value.

    reference: spectralAnalyserUI.py:272-300 — the scale grid (3x the
    spectrum length across 0.02-0.12 Å/px), the log spectrum and the ±5 px
    anchor exclusion; every guess at once on ``device``.
    """
    dev = resolve_device(device)
    W = int(spectrum.shape[0])
    if n_guesses is None:
        n_guesses = W * 3
    scales = np.linspace(scale_range[0], scale_range[1], n_guesses)

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    corr = _corr_scan(
        f32(np.log(np.maximum(spectrum, 1e-12))), f32(atlas.first),
        f32(atlas.step), f32(atlas.intensity), f32(scales), f32(anchor_x),
        f32(anchor_wavelength),
    ).cpu().numpy()
    k = int(np.argmax(corr))
    return float(scales[k]), float(corr[k])


def goto_shift(
    target_wavelength: float,
    anchor_wavelength: float,
    dispersion: float,
    fit_curve: np.ndarray,
    width: int,
) -> Tuple[int, str]:
    """Pixel shift to land on a wavelength + placement status.

    reference: spectralAnalyserUI.py:188-204 — status is "ok" (fully in
    frame), "partial", or "out".
    """
    shift = int((target_wavelength - anchor_wavelength) / dispersion)
    positions = shift + fit_curve
    within = (positions >= 0) & (positions <= width)
    if not within.any():
        return shift, "out"
    if not within.all():
        return shift, "partial"
    return shift, "ok"


def _tuple_downscale(t, f: float):
    return tuple(int(v * f) for v in t)


@dataclass
class AnalysisState:
    spectrum: np.ndarray       # brightest-frames slit spectrum (W,)
    spectrum2: np.ndarray      # mean-image middle row (W,)
    anchor_x: float            # line position at the middle row
    fit_curve: np.ndarray      # (ih,) line curve
    backup_bounds: Tuple[int, int]
    circle: tuple
    borders: list
    downscale_f: float


class SpectralAnalyser:
    """The numeric engine behind the interactive analyser, on ``device``.

    reference: spectralAnalyserUI.py:142-390 (the Start-analysis /
    Auto-dispersion / GOTO / refresh logic without the GUI).  ``preview``
    and ``save`` return (clahe, protus) uint16 tensors on the device (on
    the CPU in host mode); ``timer`` holds the load's stages.
    """

    def __init__(self, file: str, options: Optional[Options] = None,
                 atlas: Optional[SolarAtlas] = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.file = file
        self.options = (options or Options()).copy()
        self.options.clahe_only = True
        self.options.save_fit = False
        self.options.flag_display = False
        self.options._nolog = True
        self.options.shift = [0]
        self.options.basefich0 = ""
        self.atlas = atlas if atlas is not None else load_atlas()
        self.anchors = anchor_table()
        self.targets = target_table()
        self.dispersion: Optional[float] = None
        self.timer = StageTimer()
        self._load()

    # -- placement -------------------------------------------------------
    @contextmanager
    def _placed(self):
        """The session's placement flags on this thread for one call, the
        caller's put back after it.  The flags are thread-local and every
        read_scan sets its own, so the JAX package's process-wide setting
        in ``_load`` becomes this: host mode puts the small ops and the
        post-processing on the host, device mode on the device."""
        before = (placement.small_ops_on_host(), placement.host_pipeline())
        host = self._recon_mode == "host"
        placement.set_small_ops_on_host(host)
        placement.set_host_pipeline(host)
        try:
            yield
        finally:
            placement.set_small_ops_on_host(before[0])
            placement.set_host_pipeline(before[1])

    # -- loading (reference :149-176) ----------------------------------
    def _load(self) -> None:
        t = self.timer
        with t.stage("read"):
            vid = open_video(self.file)
            self.frames = vid.read_all()
        self.ih, self.iw = vid.ih, vid.iw
        self.header = make_header(self.iw, self.ih)
        # One feed decision per session: on a fast link the slab is
        # uploaded ONCE and every preview/GOTO/save reuses the device copy;
        # on a slow link nothing is uploaded and the recon runs as host
        # f64 gathers (the reference re-reads the whole video per refresh,
        # spectralAnalyserUI.py:340-362)
        self._frames_dev = None
        self.transfer_count = 0  # session slab uploads (tests assert <= 1)
        self._recon_mode = self._pick_recon_mode()
        t.note("recon", self._recon_mode)
        with self._placed():
            if self._recon_mode == "device":
                with t.stage("upload"):
                    frames = self._device_frames()
                    synchronize(self.device)
                with t.stage("mean/max"):
                    mean_img, max_img = (a.cpu().numpy()
                                         for a in mean_max(frames))
            else:
                # bit-exact host mean/max (uint64 sum, reference truncation)
                with t.stage("mean/max"):
                    mean_img, max_img = host_mean_max_frames(self.frames)
            self.mean_img, self.max_img = mean_img, max_img
            with t.stage("line fit"):
                lf = fit_spectral_line(mean_img, max_img)
            self.linefit = lf
            with t.stage("spectrum"):
                brightest = self._brightest_frame()
                lo = max(0, brightest - 5)
                hi = min(self.frames.shape[0] - 1, brightest + 5)
                spectrum = self.frames[lo:hi, self.ih // 2, :].mean(axis=0)
            spectrum2 = mean_img[mean_img.shape[0] // 2, :]

            target_height = max(1000, self.ih / 3)
            downscale_f = target_height / self.ih

            circle, borders = NO_CIRCLE, [0, 0, 0, 0]
            if (self.options.ratio_fixe is None
                    and self.options.slant_fix is None):
                with t.stage("recon"):
                    disk = self._recon_at(self.options.ellipse_fit_shift)
                # the fit's own warp would be thrown away: need_image=False
                with t.stage("ellipse fit"):
                    geo = ellipse_to_circle(disk, need_image=False)
                circle, borders = geo.circle, geo.borders
                self.options.ratio_fixe = geo.ratio
                self.options.slant_fix = math.degrees(geo.phi)

        self.state = AnalysisState(
            spectrum=spectrum,
            spectrum2=spectrum2,
            anchor_x=float(lf.curve[len(lf.curve) // 2]),
            fit_curve=lf.curve,
            backup_bounds=(lf.y1, lf.y2),
            circle=circle,
            borders=borders,
            downscale_f=downscale_f,
        )

    def _brightest_frame(self) -> int:
        """Index of the frame of greatest mean (the first of equals).  On
        the device from exact int64 frame sums, which order the frames as
        the JAX package's float64 means do."""
        if self._recon_mode == "host":
            f = self.frames
            return int(np.argmax(f.reshape(f.shape[0], -1).mean(axis=1)))
        frames = self._device_frames()
        sums = torch.cat([widen(frames[a:a + 128]).sum(dim=(1, 2),
                                                       dtype=torch.int64)
                          for a in range(0, frames.shape[0], 128)])
        return int(torch.argmax(sums).item())

    # -- dispersion / GOTO ---------------------------------------------
    def find_dispersion(self, anchor_wavelength: float) -> float:
        with self._placed():
            d, _ = auto_dispersion(
                self.state.spectrum2, self.state.anchor_x, anchor_wavelength,
                self.atlas,
                device=placement.small_ops_device(self.device))
        self.dispersion = round(d, 6)
        self.options.dispersion = self.dispersion
        return self.dispersion

    def shift_for(self, target_wavelength: float, anchor_wavelength: float):
        if self.dispersion is None:
            raise ValueError("find_dispersion first")
        return goto_shift(
            target_wavelength,
            anchor_wavelength,
            self.dispersion,
            self.state.fit_curve,
            self.state.spectrum2.shape[0],
        )

    def wavelength_of_shift(self, shift: int, anchor_wavelength: float) -> float:
        if self.dispersion is None:
            raise ValueError("find_dispersion first")
        return anchor_wavelength + shift * self.dispersion

    # -- recon source (one slab transfer per session) -------------------
    def _pick_recon_mode(self) -> str:
        """'device' (one upload, kept resident) or 'host' (f64 gathers, no
        upload), decided once per session: a slab the probed link rate
        uploads in ``MAX_UPLOAD_S`` or less goes to the device."""
        fm = getattr(self.options, "feed_mode", "auto")
        if fm == "host":
            return "host"
        if fm in ("device", "band"):
            return "device"
        nbytes = self.frames.nbytes
        if nbytes <= SMALL_SLAB_BYTES:
            return "device"  # small slab: upload cost is trivial either way
        rate = cached_probe_rate()
        if rate is None:
            rate = probe_transfer_rate(self.device)
        return "device" if nbytes / max(rate, 1.0) <= MAX_UPLOAD_S else "host"

    def _device_frames(self) -> torch.Tensor:
        if self._frames_dev is None:
            with warnings.catch_warnings():
                # a read-only memmap of the scan: nothing writes to it
                warnings.simplefilter("ignore", UserWarning)
                frames = torch.from_numpy(self.frames)
            self._frames_dev = frames.to(self.device)
            self.transfer_count += 1
        return self._frames_dev

    def _host_recon(self, shifts) -> np.ndarray:
        """Host f64 multi-shift recon over the in-RAM slab — the
        io/hostreduce.py math (reference solex_util.py:113-134 exact) on
        already-normalised frames."""
        ind_l, _ = build_shift_indices(
            self.linefit.floor, self.linefit.frac, list(shifts), self.iw
        )
        w_l = 1.0 - np.asarray(self.linefit.frac, dtype=np.float64)
        w_r = np.asarray(self.linefit.frac, dtype=np.float64)
        rows = np.arange(self.ih)
        F = self.frames.shape[0]
        out = np.empty((len(shifts), self.ih, F), np.uint16)
        for si in range(len(shifts)):
            left = self.frames[:, rows, ind_l[si]]         # (F, ih)
            right = self.frames[:, rows, ind_l[si] + 1]
            vals = left * w_l + right * w_r                # float64
            out[si] = vals.T                               # truncating u16
        return out

    # -- preview / save (reference :340-362, :374-388) ------------------
    def _recon_at(self, shift: int) -> torch.Tensor:
        """The (ih, F) uint16 disk at ``shift``: kernel B3 on the resident
        slab, or the host loop in host mode."""
        with self._placed():
            if self._recon_mode == "host":
                disk = torch.from_numpy(self._host_recon([shift])[0])
            else:
                disk = reconstruct(self._device_frames(), self.linefit.floor,
                                   self.linefit.frac, [shift])[0]
        if self.options.flip_x:
            disk = torch.flip(as_int16(disk), dims=(1,)).view(torch.uint16)
        return disk

    def _angles(self):
        opts = self.options
        ratio = opts.ratio_fixe if opts.ratio_fixe is not None else 1.0
        phi = math.radians(opts.slant_fix) if opts.slant_fix is not None else 0.0
        return ratio, phi

    def preview(self, shift: int):
        """Quick-look products at ``shift`` on a downscaled disk."""
        with self._placed():
            disk = self._recon_at(shift)
            f = self.state.downscale_f
            ratio, phi = self._angles()
            small = resize_linear(disk, f)
            circ, _, _ = correct_image(
                small, phi, ratio, np.array([-1.0, -1.0]), -1.0
            )
            circle = (
                _tuple_downscale(self.state.circle, f)
                if self.state.circle != NO_CIRCLE
                else NO_CIRCLE
            )
            return single_image_process(
                circ,
                self.header,
                self.options,
                circle,
                _tuple_downscale(self.state.borders, f),
                "",
                _tuple_downscale(self.state.backup_bounds, f),
                save=False,
            )

    def save(self, shift: int, out_base: Optional[str] = None):
        """Full-resolution products at ``shift``; writes
        ``<out_base>_clahe.png`` and ``_protus.png`` when ``out_base`` is
        given (reference Save-image, :374-388)."""
        with self._placed():
            disk = self._recon_at(shift)
            ratio, phi = self._angles()
            circ, _, _ = correct_image(
                disk, phi, ratio, np.array([-1.0, -1.0]), -1.0
            )
            clahe_img, protus = single_image_process(
                circ,
                self.header,
                self.options,
                self.state.circle,
                self.state.borders,
                "",
                self.state.backup_bounds,
                save=False,
            )
        if out_base is not None:
            write_png_streaming(out_base + "_clahe.png",
                                clahe_img.cpu().numpy())
            write_png_streaming(out_base + "_protus.png",
                                protus.cpu().numpy())
        return clahe_img, protus
