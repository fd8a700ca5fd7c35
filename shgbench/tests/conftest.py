"""Shared fixtures of the benchmark's own tests (CPU, small scans)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a scan the CPU runs in about a second: the configurations' synthetic
#: model at 300 frames x 512 rows x 96 spectral columns, the line centred
SMALL = {"frames": 300, "slit_px": 512, "spectral_px": 96}


def small_override(config: dict) -> dict:
    """``SMALL`` with the configuration's line moved into 96 columns."""
    assumed = dict(config["assumed"])
    assumed["line_poly"] = [SMALL["spectral_px"] / 2] + list(
        assumed["line_poly"][1:])
    return dict(SMALL, assumed=assumed)


def bench_with_pending() -> dict:
    """BENCHMARK.json with the configurations, cells and metrics defined
    under ``shgbench/pending/`` added, as a later change would add them:
    the entries appended, and each pending cell's name added to the
    ``workloads`` of the metrics it ``reports``."""
    import json

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    pendings = []
    for path in sorted((ROOT / "shgbench" / "pending").glob("*.json")):
        with open(path) as f:
            pendings.append(json.load(f))
    for pending in pendings:
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + pending.get(key, [])
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for pending in pendings:
        for cell in pending.get("workloads", []):
            for name in pending.get("reports", []):
                if "workloads" in metrics[name]:
                    metrics[name]["workloads"].append(cell["name"])
    return bench


def small_cell(name: str):
    """The cell ``name`` (pending cells included) at the ``SMALL`` size."""
    from shgbench.harness import load_cell

    bench = bench_with_pending()
    cell = load_cell(name, bench)
    return load_cell(name, bench, override=small_override(cell.config))
