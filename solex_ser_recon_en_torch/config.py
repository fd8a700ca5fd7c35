"""Typed configuration for the reconstruction pipeline.

The port's own copy of solex_ser_recon_en_tpu/config.py (same fields,
defaults and JSON round trip), so that the port imports nothing of the JAX
package.  Fields of options the port does not run yet are kept: a
``SHG_config.txt`` written by either package loads in the other.

The reference drives everything off a single mutable ``options`` dict with
defaults at ``SHG_MAIN.py:41-68`` and JSON persistence in ``SHG_config.txt``
(``SHG_MAIN.py:75-96``).  We keep the *exact* key names (including the
awkward ``de-vignette``) so a reference user's ``SHG_config.txt`` round-trips
unchanged, but expose them through a dataclass with validation.

reference: SHG_MAIN.py:41-68 (defaults), SHG_MAIN.py:75-96 (JSON round trip)
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


# dataclass field name -> reference options-dict key (only where they differ)
_KEY_ALIASES = {
    "de_vignette": "de-vignette",
}
_ALIAS_TO_FIELD = {v: k for k, v in _KEY_ALIASES.items()}


@dataclass
class Options:
    """Pipeline options. Field names mirror the reference options dict."""

    language: str = "English"
    shift: List[int] = field(default_factory=lambda: [0])       # CLI -w
    flag_display: bool = False                                  # CLI -d
    ratio_fixe: Optional[float] = None                          # CLI -x
    slant_fix: Optional[float] = None                           # degrees
    save_fit: bool = False                                      # CLI -f
    clahe_only: bool = False                                    # CLI -c
    protus_only: bool = False
    disk_display: bool = True                                   # CLI -p
    delta_radius: int = 0
    crop_width_square: bool = False                             # CLI -s
    transversalium: bool = True                                 # CLI -t
    stubborn_transversalium: bool = False
    trans_strength: int = 301
    img_rotate: int = 0
    flip_x: bool = False                                        # CLI -m
    workDir: str = ""
    fixed_width: Optional[int] = None                           # CLI -r
    output_dir: str = ""
    input_dir: str = ""
    specDir: str = ""
    selected_mode: str = "File input mode"
    continuous_detect_mode: bool = False
    dispersion: float = 0.05
    ellipse_fit_shift: int = 10    # hidden contrast shift for the ellipse fit
    de_vignette: bool = False                                   # key "de-vignette"

    # --- derived / runtime keys (reference sets these on the fly) ---
    shift_requested: Optional[List[int]] = None
    basefich0: str = ""
    tempo: int = 5000
    _nolog: bool = False

    # --- TPU-framework extensions (absent in the reference) ---
    # device mesh spec, e.g. {"frame": 4, "batch": 2}; None = single device
    mesh: Optional[Dict[str, int]] = None
    # recon kernel selection: "auto" | "gather" | "onehot" | "pallas"
    recon_kernel: str = "auto"
    # frames per host->device transfer chunk (streaming decode)
    frame_chunk: int = 512
    # feed policy: "auto" | "device" (whole slab to HBM) | "band"
    # (host pass A + only the recon's spectral band transferred)
    feed_mode: str = "auto"
    # multi-host (DCN) folder-batch split: this process handles the
    # deterministic 1/num_processes share of the folder that
    # parallel/distributed.assign_files hashes to process_id — the
    # host-scale analogue of the reference's Pool(4) (Solex_recon.py:30).
    # CLI --num-processes/--process-id or SOLEX_NUM_PROCESSES/
    # SOLEX_PROCESS_ID; runtime-only (never persisted to SHG_config.txt).
    num_processes: int = 1
    process_id: int = 0

    # ------------------------------------------------------------------
    def validate(self) -> None:
        if self.img_rotate % 90 != 0:
            raise ValueError("img_rotate must be a multiple of 90")
        if self.trans_strength < 5:
            raise ValueError("trans_strength too small")
        if not self.shift:
            raise ValueError("shift list must be non-empty")
        if self.fixed_width is not None and self.fixed_width <= 0:
            raise ValueError("fixed_width must be positive")
        if self.num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError("process_id out of range")

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Dict with reference-compatible key names (JSON-serialisable)."""
        d = {}
        for f in dataclasses.fields(self):
            key = _KEY_ALIASES.get(f.name, f.name)
            d[key] = getattr(self, f.name)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Options":
        """Build from a reference-style dict; unknown keys are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in d.items():
            name = _ALIAS_TO_FIELD.get(key, key)
            if name in known:
                kwargs[name] = value
        return cls(**kwargs)

    def copy(self) -> "Options":
        return dataclasses.replace(
            self,
            shift=list(self.shift),
            shift_requested=None
            if self.shift_requested is None
            else list(self.shift_requested),
        )

    # --- JSON config persistence (SHG_config.txt equivalent) ----------
    @classmethod
    def load(cls, path: str) -> "Options":
        with open(path, "r", encoding="utf-8") as fp:
            base = cls()
            loaded = cls.from_dict({**base.to_dict(), **json.load(fp)})
            return loaded

    def save(self, path: str) -> None:
        d = self.to_dict()
        # runtime-only keys never belong in the config file
        for k in ("shift_requested", "basefich0", "tempo", "_nolog",
                  "num_processes", "process_id"):
            d.pop(k, None)
        with open(path, "w", encoding="utf-8") as fp:
            json.dump(d, fp, sort_keys=True, indent=4)


def output_path(path: str, options: Options) -> str:
    """If output_dir is set, redirect ``path``'s basename into it.

    reference: solex_util.py:60-63
    """
    if options.output_dir.strip() == "":
        return path
    return os.path.join(options.output_dir, os.path.basename(path))
