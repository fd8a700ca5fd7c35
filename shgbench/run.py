"""Run one cell of the benchmark once, on the card:

    python3 shgbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m shgbench.run ...``) from the root of a checkout;
``--pending`` also finds the cells defined under ``shgbench/pending/``.  The
last line of standard output is the run's JSON result; the numbers
compared against the reference are the last lines of standard error.
Without CUDA, or with fewer cards than the cell asks for, it prints no
result and exits with 3.  Build and kernel caches stay inside the
checkout (``build/``).
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = ROOT / "build"
    os.environ["SOLEX_TORCH_BUILD_DIR"] = str(build / "solex_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "shgbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "shgbench" /
                                             "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--pending", action="store_true",
                    help="the cells under shgbench/pending/ as well")
    args = ap.parse_args(argv)
    _environment()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from shgbench.harness import bench_with_pending, load_cell, run_cell

    cell = load_cell(args.workload,
                     bench_with_pending() if args.pending else None)
    if not torch.cuda.is_available():
        print("shgbench: CUDA is not available; no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"shgbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        return 3
    return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), START)


if __name__ == "__main__":
    sys.exit(main())
