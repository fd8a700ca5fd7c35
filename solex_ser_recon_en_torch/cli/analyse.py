"""Headless spectral-analyser CLI (``shg-torch-analyse``).

Counterpart of solex_ser_recon_en_tpu/cli/analyse.py.  The reference
exposes the analyser only through its GUI ("Pixel offset live",
UI_handler.py:273-279); this front end drives the same engine from the
command line, on ``--device`` (default ``cuda``; without CUDA it exits
with an error, never a silent CPU run):

    python -m solex_ser_recon_en_torch.cli.analyse scan.ser \
        --anchor 6562.808 [--goto 6562.0 | --target "He(D3)"] \
        [--dispersion 0.05] [--shift N] [--save out_base] [--atlas alps.npz] \
        [--device cpu]

An ``--atlas`` path that does not exist exits 2 (the JAX CLI would go on
against the atlas found elsewhere, or a synthetic one).  Not ported: the
relay-link probe of the JAX CLI, which falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..analyser import SpectralAnalyser
from ..analyser.atlas import load_atlas, target_table
from ..utils.device import resolve_device


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="SHG spectral analyser (headless)")
    ap.add_argument("file", help="SER/AVI scan")
    ap.add_argument("--anchor", type=float, default=6562.808,
                    help="anchor line wavelength in Å (default H-alpha)")
    ap.add_argument("--dispersion", type=float, default=None,
                    help="Å/px; omit to auto-detect via atlas correlation")
    ap.add_argument("--goto", type=float, default=None, help="GOTO wavelength (Å)")
    ap.add_argument("--target", type=str, default=None,
                    help='GOTO named line, e.g. "He(D3)"')
    ap.add_argument("--shift", type=int, default=None, help="explicit pixel shift")
    ap.add_argument("--save", type=str, default=None,
                    help="write <save>_clahe.png/_protus.png at the chosen shift")
    ap.add_argument("--atlas", type=str, default=None, help="atlas .npz path")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.atlas is not None and not os.path.exists(args.atlas):
        print(f"ERROR: atlas {args.atlas!r} not found")
        return 2
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"ERROR: {e}")
        return 2
    an = SpectralAnalyser(args.file, atlas=load_atlas(args.atlas),
                          device=device)
    print(f"frames loaded; anchor line at x = {an.state.anchor_x:.2f} px")

    if args.dispersion is not None:
        an.dispersion = args.dispersion
    else:
        d = an.find_dispersion(args.anchor)
        print(f"auto dispersion: {d:.6f} Å/px")

    shift = args.shift or 0
    if args.target is not None:
        waves, names, labelled = target_table()
        matches = [i for i, lab in enumerate(labelled)
                   if args.target in (lab, names[i])]
        if not matches:
            print(f"unknown target {args.target!r}; known: {labelled}")
            return 1
        shift, status = an.shift_for(waves[matches[0]], args.anchor)
        print(f"GOTO {labelled[matches[0]]}: shift = {shift} ({status})")
        if status == "out":
            print("That line does not appear to be in image!")
            return 1
    elif args.goto is not None:
        shift, status = an.shift_for(args.goto, args.anchor)
        print(f"GOTO {args.goto} Å: shift = {shift} ({status})")
        if status == "out":
            print("That line does not appear to be in image!")
            return 1
    if args.target is not None or args.goto is not None:
        if status == "partial":
            print("Warning: Line is only partially within frame")

    if an.dispersion:
        print(
            f"shift {shift} = {an.wavelength_of_shift(shift, args.anchor):.3f} Å "
            f"({shift * an.dispersion:+.3f} Å from anchor)"
        )
    if args.save:
        an.save(shift, args.save)
        print(f"saved {args.save}_clahe.png / _protus.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
