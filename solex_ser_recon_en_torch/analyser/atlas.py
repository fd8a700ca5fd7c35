"""Solar reference atlas + spectral line tables.

reference: spectralAnalyserUI.py:61-65 loads ``language_data/alps.npz``
(700,000 uint8 samples of a solar atlas covering 3000-10000 Å at 0.01 Å/px:
keys y/first/last/step) plus two line tables (line_data/*.txt, format
"<wavelength> <name>").

We keep the same .npz schema so a user's atlas file drops in unchanged.
Without one, a synthetic atlas is built from the known line tables
(Gaussian absorption profiles on a flat continuum) — enough for the
correlation machinery and tests; for observatory-grade dispersion accuracy
point ``atlas_path`` at a real atlas export (e.g. BASS2000).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


def load_lines(path: str) -> Tuple[List[float], List[str], List[str]]:
    """Parse a line table; returns (wavelengths, names, labelled names).

    reference: spectralAnalyserUI.py:50-58.
    """
    waves, names = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split(" ")
            if len(parts) < 2:
                continue
            waves.append(float(parts[0]))
            names.append(parts[1].strip())
    labelled = [f"{names[i]}({waves[i]})" for i in range(len(names))]
    return waves, names, labelled


def anchor_table() -> Tuple[List[float], List[str], List[str]]:
    return load_lines(os.path.join(_DATA_DIR, "anchor_candidates.txt"))


def target_table() -> Tuple[List[float], List[str], List[str]]:
    return load_lines(os.path.join(_DATA_DIR, "line_targets.txt"))


# Auto-dispersion correlates a ±(W/2·disp) window around the chosen anchor
# against the atlas with the anchor line itself EXCLUDED (reference
# spectralAnalyserUI.py:272-300) — so the scale lock comes entirely from
# the WEAKER lines surrounding each anchor.  Those neighbourhoods must
# therefore carry real solar structure, not an invented line forest.
# 300 px at the 0.12 Å/px search ceiling spans ±18 Å; ±25 Å covers it.
ANCHOR_WINDOW = 25.0


def line_table_from_atlas(
    atlas: "SolarAtlas",
    centers: Optional[List[float]] = None,
    window: float = ANCHOR_WINDOW,
    min_depth: float = 0.12,
) -> List[Tuple[float, float, float]]:
    """Distil a measured solar atlas into a (wavelength, depth, sigma) line
    table around the analyser's anchor windows.

    This is the reproducible provenance of ``data/anchor_lines.txt``: point
    it at any public disk-integrated atlas export in the alps.npz schema
    (e.g. the BASS2000/Meudon spectrum) and it extracts the prominent
    absorption minima — positions, depths relative to the local continuum,
    and half-depth widths.  These are physical measurements of the Sun
    (plus telluric O2/H2O), not creative content; shipping them as a table
    keeps the generated atlas's anchor neighbourhoods faithful to real
    solar structure, which is what correlation-based dispersion search
    locks onto.
    """
    if centers is None:
        centers = sorted(set(anchor_table()[0]))
    w, y = atlas.wavelengths, atlas.intensity
    out: List[Tuple[float, float, float]] = []
    for c in centers:
        m = (w >= c - window) & (w <= c + window)
        seg, ww = y[m], w[m]
        n = len(seg)
        for i in range(5, n - 5):
            if not (seg[i] == seg[i - 5 : i + 6].min()
                    and seg[i] < seg[i - 5 : i + 6].max()):
                continue
            lo, hi = max(0, i - 200), min(n, i + 200)
            cont = float(np.percentile(seg[lo:hi], 95))
            depth = 1.0 - seg[i] / max(cont, 1e-9)
            if depth < min_depth:
                continue
            half = seg[i] + 0.5 * (cont - seg[i])
            l = i
            while l > 0 and seg[l] < half:
                l -= 1
            r = i
            while r < n - 1 and seg[r] < half:
                r += 1
            sigma = min(1.2, max(0.03, (r - l) * atlas.step / 2.355))
            out.append((float(ww[i]), min(0.95, float(depth)), sigma))
    # overlapping anchor windows (Ca H/K, Na D) see the same minima twice;
    # keep the deepest of near-coincident entries
    out.sort()
    ded: List[Tuple[float, float, float]] = []
    for lam, d, s in out:
        if ded and abs(ded[-1][0] - lam) < 0.1:
            if d > ded[-1][1]:
                ded[-1] = (lam, d, s)
        else:
            ded.append((lam, d, s))
    return ded


def load_anchor_lines() -> List[Tuple[float, float, float]]:
    """Curated (wavelength, depth, sigma) table for the anchor windows
    (``data/anchor_lines.txt``, written by ``line_table_from_atlas``).
    Empty when the file is absent."""
    path = os.path.join(_DATA_DIR, "anchor_lines.txt")
    out: List[Tuple[float, float, float]] = []
    if not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 3:
                out.append((float(parts[0]), float(parts[1]), float(parts[2])))
    return out


@dataclass
class SolarAtlas:
    """wavelengths[i] = first + i*step (Å); intensity in [0, 1]."""

    intensity: np.ndarray
    first: float
    last: float
    step: float

    @property
    def wavelengths(self) -> np.ndarray:
        return np.arange(self.first, self.last, self.step)[: len(self.intensity)]

    def table(self) -> np.ndarray:
        """(N, 2) [wavelength, intensity] like the reference's line_data
        (spectralAnalyserUI.py:62)."""
        return np.stack([self.wavelengths, self.intensity], axis=1)

    @classmethod
    def from_npz(cls, path: str) -> "SolarAtlas":
        z = np.load(path)
        return cls(
            intensity=z["y"].astype(np.float64) / 255.0,
            first=float(z["first"]),
            last=float(z["last"]),
            step=float(z["step"]),
        )

    @classmethod
    def synthetic(
        cls,
        first: float = 3000.0,
        last: float = 10000.0,
        step: float = 0.01,
        extra_lines: Optional[List[Tuple[float, float, float]]] = None,
    ) -> "SolarAtlas":
        """Flat continuum with Gaussian absorption at the known solar lines
        (+ a dense comb of weak Fraunhofer-like lines so correlations have
        structure away from the anchors)."""
        wl = np.arange(first, last, step)
        inten = np.ones_like(wl)
        lines: List[Tuple[float, float, float]] = []
        for w in anchor_table()[0] + target_table()[0]:
            lines.append((w, 0.7, 0.35))
        # dense Fraunhofer-like comb: ~2 lines/Å so any few-Å window has
        # enough structure for the correlation to discriminate scale
        rng = np.random.default_rng(12345)
        n_comb = int((last - first) * 2)
        for w in rng.uniform(first, last, n_comb):
            lines.append((float(w), rng.uniform(0.08, 0.5), rng.uniform(0.03, 0.12)))
        if extra_lines:
            lines += list(extra_lines)
        for center, depth, sigma in lines:
            lo = np.searchsorted(wl, center - 6 * sigma)
            hi = np.searchsorted(wl, center + 6 * sigma)
            if lo >= hi:
                continue
            seg = wl[lo:hi]
            inten[lo:hi] *= 1 - depth * np.exp(-0.5 * ((seg - center) / sigma) ** 2)
        return cls(intensity=inten, first=first, last=last, step=step)


    @classmethod
    def realistic(
        cls,
        first: float = 3000.0,
        last: float = 10000.0,
        step: float = 0.01,
        seed: int = 20260816,
    ) -> "SolarAtlas":
        """Physically-motivated disk-integrated solar spectrum.

        The reference ships a measured atlas (language_data/alps.npz,
        700,000 u8 samples, spectralAnalyserUI.py:61-65); we generate an
        equivalent-fidelity synthetic one so auto-dispersion sees the same
        *structure* a real spectrum has (the stick atlas of ``synthetic()``
        does not):

        - Planck continuum at T_eff = 5772 K times a slow instrument slope,
        - the strong Fraunhofer lines with pseudo-Voigt profiles (Gaussian
          cores + Lorentzian damping wings for Ca II H/K, Na D, Mg b, Hα..),
        - a metal-line forest whose density rises toward the blue (the real
          solar property that anchors correlation-based scale search),
        - telluric O2 A/B bands (sharp, regularly spaced) and H2O bands.

        Deterministic (seeded) — the shipped data/atlas.npz is this
        function's output quantised to uint8 in the reference schema.
        """
        wl = np.arange(first, last, step)
        # Planck continuum (per-wavelength, arbitrary units), normalised
        hc_over_k_angstrom = 143877687.8  # h*c/k_B in Å*K
        x = hc_over_k_angstrom / (wl * 5772.0)
        planck = 1.0 / (wl**5 * np.expm1(np.clip(x, 1e-6, 700)))
        cont = planck / planck.max()
        # slow instrument/response slope so the continuum is not pure Planck
        t = (wl - first) / (last - first)
        cont = cont * (0.85 + 0.3 * t - 0.15 * t * t)
        cont /= cont.max()

        trans = np.ones_like(wl)

        def absorb(center, depth, sigma, gamma=0.0, eta=0.0):
            """Pseudo-Voigt absorption: (1-eta)*Gauss + eta*Lorentz."""
            span = 6 * sigma + (30 * gamma if gamma else 0.0)
            lo = np.searchsorted(wl, center - span)
            hi = np.searchsorted(wl, center + span)
            if lo >= hi:
                return
            d = wl[lo:hi] - center
            prof = (1 - eta) * np.exp(-0.5 * (d / sigma) ** 2)
            if eta:
                prof += eta * gamma * gamma / (d * d + gamma * gamma)
            trans[lo:hi] *= 1.0 - depth * prof

        # --- strong Fraunhofer lines: (λ Å, depth, σ core, γ wing, η) ---
        strong = [
            (6562.808, 0.88, 0.35, 1.6, 0.35),   # Hα
            (4861.35, 0.82, 0.40, 1.8, 0.35),    # Hβ
            (4340.47, 0.78, 0.40, 1.6, 0.35),    # Hγ
            (4101.73, 0.75, 0.40, 1.5, 0.35),    # Hδ
            (3970.07, 0.80, 0.45, 2.0, 0.40),    # Hε (blend with Ca II H)
            (3933.66, 0.95, 0.80, 6.0, 0.55),    # Ca II K
            (3968.47, 0.94, 0.80, 5.5, 0.55),    # Ca II H
            (5889.95, 0.90, 0.25, 0.9, 0.30),    # Na I D2
            (5895.92, 0.87, 0.25, 0.8, 0.30),    # Na I D1
            (5167.32, 0.72, 0.22, 0.5, 0.25),    # Mg I b3
            (5172.68, 0.76, 0.22, 0.6, 0.25),    # Mg I b2
            (5183.60, 0.78, 0.22, 0.6, 0.25),    # Mg I b1
            (4226.73, 0.80, 0.25, 0.7, 0.25),    # Ca I
            (4383.55, 0.72, 0.18, 0.3, 0.2),     # Fe I
            (4404.75, 0.68, 0.16, 0.25, 0.2),    # Fe I
            (4325.76, 0.66, 0.16, 0.25, 0.2),    # Fe I / CH G-band region
            (4307.90, 0.70, 0.30, 0.4, 0.2),     # G band (CH blend)
            (4045.81, 0.70, 0.18, 0.3, 0.2),     # Fe I
            (5269.54, 0.62, 0.15, 0.2, 0.15),    # Fe I
            (5328.04, 0.58, 0.14, 0.2, 0.15),    # Fe I
            (6173.33, 0.45, 0.12, 0.0, 0.0),     # Fe I (magnetograph line)
            (6301.50, 0.42, 0.12, 0.0, 0.0),     # Fe I
            (6302.49, 0.38, 0.12, 0.0, 0.0),     # Fe I
            (7664.90, 0.70, 0.20, 0.4, 0.2),     # K I
            (7698.96, 0.65, 0.20, 0.4, 0.2),     # K I
            (8498.02, 0.62, 0.45, 1.2, 0.3),     # Ca II IR triplet
            (8542.09, 0.78, 0.55, 1.6, 0.3),     # Ca II IR triplet
            (8662.14, 0.72, 0.50, 1.4, 0.3),     # Ca II IR triplet
            (8750.47, 0.45, 0.50, 1.0, 0.3),     # Paschen 12
            (8862.78, 0.42, 0.50, 1.0, 0.3),     # Paschen 11
            (9014.91, 0.40, 0.55, 1.0, 0.3),     # Paschen 10
            (9229.01, 0.45, 0.60, 1.2, 0.3),     # Paschen 9
            (9545.97, 0.48, 0.65, 1.3, 0.3),     # Paschen 8
            (5875.62, 0.12, 0.25, 0.0, 0.0),     # He I D3 (weak)
            (6867.19, 0.30, 0.15, 0.0, 0.0),     # O2 B head
            (7593.70, 0.55, 0.15, 0.0, 0.0),     # O2 A head
        ]
        for c, d, s, g, e in strong:
            absorb(c, d, s, g, e)

        # --- curated anchor-window lines (measured solar structure) ---
        # Auto-dispersion excludes the anchor line itself from the
        # correlation, so the scale lock lives in the weaker lines around
        # each anchor — those must sit at REAL positions/depths or scans
        # rendered from this atlas cannot cross-correlate against a
        # measured atlas (tests/test_atlas_dispersion.py).  The curated
        # table (data/anchor_lines.txt, via line_table_from_atlas) carries
        # that structure; within its windows the random forest and the
        # hand-placed telluric combs are suppressed in favour of it.
        curated = load_anchor_lines()
        curated_centers = sorted(set(anchor_table()[0]))

        def in_curated_window(lam: float) -> bool:
            return any(abs(lam - c) <= ANCHOR_WINDOW for c in curated_centers)

        strong_pos = np.array([c for c, *_ in strong])
        for c, d, s in curated:
            if first <= c <= last and not np.any(np.abs(strong_pos - c) < 0.8):
                absorb(c, d, s)

        rng = np.random.default_rng(seed)
        # --- metal-line forest: density falls toward the red like the Sun's
        n_forest = 24000
        u = rng.random(n_forest)
        lam = first + (last - first) * (1 - np.sqrt(u))  # denser at the blue
        depths = np.minimum(0.85, rng.exponential(0.12, n_forest) + 0.02)
        sigmas = rng.uniform(0.035, 0.14, n_forest)
        for c, d, s in zip(lam, depths, sigmas):
            if curated and in_curated_window(float(c)):
                continue
            absorb(float(c), float(d), float(s))
        # --- telluric bands: sharp, quasi-regular combs ---
        for head, tail, spacing, dmax in (
            (7593.7, 7684.0, 1.45, 0.85),   # O2 A
            (6867.2, 6944.0, 1.55, 0.45),   # O2 B
            (7165.0, 7320.0, 0.9, 0.30),    # H2O
            (8105.0, 8350.0, 1.0, 0.35),    # H2O
            (9300.0, 9650.0, 0.8, 0.45),    # H2O
        ):
            c = head
            k = 0
            while c < tail:
                jitter = rng.uniform(-0.08, 0.08)
                d = dmax * (0.35 + 0.65 * rng.random())
                if not (curated and in_curated_window(c)):
                    absorb(c + jitter, d, 0.035)
                k += 1
                c = head + spacing * k * (1 + 0.004 * k)  # band-head spread
        inten = cont * trans
        return cls(intensity=inten / inten.max(), first=first, last=last,
                   step=step)

    def to_npz(self, path: str) -> None:
        """Write in the reference alps.npz schema (u8 y/first/last/step)."""
        np.savez_compressed(
            path,
            y=np.clip(np.round(self.intensity * 255.0), 0, 255).astype(np.uint8),
            first=self.first,
            last=self.last,
            step=self.step,
        )


def load_atlas(path: Optional[str] = None) -> SolarAtlas:
    """Load the atlas from ``path``, common locations, or synthesise one."""
    candidates = [path] if path else []
    candidates += [
        os.environ.get("SOLEX_ATLAS"),
        os.path.join(_DATA_DIR, "atlas.npz"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return SolarAtlas.from_npz(c)
    return SolarAtlas.synthetic()
