"""Shared fixtures of the benchmark's own tests (CPU, small scans)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from shgbench.harness import bench_with_pending  # noqa: E402,F401

#: a scan the CPU runs in about a second: the configurations' synthetic
#: model at 300 frames x 512 rows x 96 spectral columns, the line centred
SMALL = {"frames": 300, "slit_px": 512, "spectral_px": 96}


def small_override(config: dict) -> dict:
    """``SMALL`` with the configuration's line moved into 96 columns."""
    assumed = dict(config["assumed"])
    assumed["line_poly"] = [SMALL["spectral_px"] / 2] + list(
        assumed["line_poly"][1:])
    return dict(SMALL, assumed=assumed)


def small_cell(name: str):
    """The cell ``name`` (pending cells included) at the ``SMALL`` size."""
    from shgbench.harness import load_cell

    bench = bench_with_pending()
    cell = load_cell(name, bench)
    return load_cell(name, bench, override=small_override(cell.config))
