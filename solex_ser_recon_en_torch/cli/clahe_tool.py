"""Standalone CLAHE over saved images (``shg-torch-clahe``).

Counterpart of solex_ser_recon_en_tpu/cli/clahe_tool.py.  reference:
clahe_apply.py — applies cv2-semantics CLAHE (clipLimit=0.8, tile grid
1-4) to PNG/TIF images with an optional low/high percentile stretch
(saturation alpha), persisting its own JSON config (clahe_config.txt in
the working directory, keys workDir/language/lo/hi/do_stretch/sat/
tile_size; a missing or unreadable file gives the defaults).

    python -m solex_ser_recon_en_torch.cli.clahe_tool img1.png img2.tif \
        [--tile 2] [--stretch --lo 0 --hi 100 --sat 80] [--device cpu]

CLAHE runs on ``--device`` (default ``cuda``; without CUDA it exits with
an error, never a silent CPU run) through ops/clahe.py, so kernel B5
counts the tiles' histograms on the card: 65536 bins for a 16-bit image,
256 for an 8-bit one, the grid reflect-padded where it does not divide
the image.  The stretch levels are numpy percentiles of the input on the
host, as in the JAX tool.  Not ported: the JAX tool's relay-link probes
(``ensure_responsive_backend``, and ``d2h_responsive`` with
``set_small_ops_on_host``), which fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import List, Optional

import numpy as np
import torch

from ..io.png import read_image, write_png_streaming
from ..ops.clahe import clahe
from ..ops.stretch import rescale_brightness
from ..utils.device import resolve_device

CONFIG_NAME = "clahe_config.txt"
DEFAULTS = {
    "workDir": "",
    "language": "English",
    "lo": 0,
    "hi": 100,
    "do_stretch": False,
    "sat": 80,
    "tile_size": 2,
}


def read_ini(path: str = CONFIG_NAME) -> dict:
    options = dict(DEFAULTS)
    try:
        with open(path, encoding="utf-8") as fp:
            options.update(json.load(fp))
    except Exception:
        pass
    return options


def write_ini(options: dict, path: str = CONFIG_NAME) -> None:
    try:
        with open(path, "w", encoding="utf-8") as fp:
            json.dump(options, fp, sort_keys=True, indent=4)
    except Exception:
        traceback.print_exc()


def apply_clahe(file: str, options: dict, write_file: bool = True,
                device: torch.device | str = "cuda") -> np.ndarray:
    """CLAHE (and the optional stretch) of one image on ``device``; writes
    ``<file>_clahe.png`` and returns the image (host array).
    reference: clahe_apply.py:243-256."""
    dev = resolve_device(device)
    frame = read_image(file)
    if frame.dtype not in (np.uint8, np.uint16):
        frame = np.clip(frame, 0, 65535).astype(np.uint16)
    t = int(options["tile_size"])
    cl1 = clahe(torch.from_numpy(np.ascontiguousarray(frame)).to(dev),
                clip_limit=0.8, tiles=(t, t))
    if options["do_stretch"]:
        dark = np.percentile(frame, options["lo"])
        bright = np.percentile(frame, options["hi"])
        cl1 = rescale_brightness(cl1, dark, bright,
                                 alpha=options["sat"] / 100)
    cl1 = cl1.cpu().numpy()
    if write_file:
        out = os.path.splitext(file)[0] + "_clahe.png"
        write_png_streaming(out, cl1)
        print("save:", out)
    return cl1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Apply CLAHE to images")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--tile", type=int, default=None, choices=range(1, 5))
    ap.add_argument("--stretch", action="store_true")
    ap.add_argument("--lo", type=int, default=None)
    ap.add_argument("--hi", type=int, default=None)
    ap.add_argument("--sat", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"ERROR: {e}")
        return 2

    options = read_ini()
    if args.tile is not None:
        options["tile_size"] = args.tile
    if args.stretch:
        options["do_stretch"] = True
    for k in ("lo", "hi", "sat"):
        v = getattr(args, k)
        if v is not None:
            options[k] = v
    if options["do_stretch"] and options["hi"] <= options["lo"]:
        print("Error: the low percentile must be less than the high percentile!")
        return 1
    for f in args.files:
        apply_clahe(f, options, device=device)
    options["workDir"] = os.path.dirname(args.files[0])
    write_ini(options)
    return 0


if __name__ == "__main__":
    sys.exit(main())
