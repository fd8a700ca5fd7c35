"""Readings that the limits of ``correct`` are set from, in one process:

    python3 shgbench/calibrate.py --cells A,B --seeds 12 --control-seeds 3 \\
        --seconds 2 [--out FILE] [--pending]

For each cell, runs of the timed path on ``--seeds`` seeds, each with a
short window, give the program's readings of every compared number (the
lower readings: the largest over the seeds).  For each configuration and
set of requested shifts, the control, the reference on samples cut to the
configuration's ``control_bits`` most significant bits, is compared with
the reference on the whole samples, each shift's product with that
shift's, at the cell's own size, on ``--control-seeds`` seeds (the upper
readings: the smallest).  Each reading is one JSON line; the summary is
printed last.  ``--pending`` also finds the cells defined under
``shgbench/pending/``.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from shgbench.run import _environment  # noqa: E402


def seeds(n: int, salt: int):
    """Large seeds, distinct from one call to another by ``salt``."""
    return [(2 ** 31 + 7919 * (i + 1) + 104729 * salt) for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--salt", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pending", action="store_true",
                    help="the cells under shgbench/pending/ as well")
    ap.add_argument("--override", default="",
                    help="JSON of configuration keys to replace (a small "
                         "rehearsal on the CPU)")
    args = ap.parse_args(argv)
    _environment()
    import torch

    from shgbench import compare
    from shgbench.generator import ScanFile, ScanModel
    from shgbench.harness import (bench_with_pending, load_cell,
                                  load_reference, run_cell)

    device = torch.device(args.device)
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    override = json.loads(args.override) if args.override else None
    bench = bench_with_pending() if args.pending else None
    cells = [load_cell(name, bench, override)
             for name in args.cells.split(",")]

    def control_key(cell):
        return cell.config_name, tuple(cell.mix["options"]["shift"])

    prog, ctl = {}, {}
    for cell in cells:
        name = cell.name
        for s in seeds(args.seeds, args.salt):
            rec = {}
            t0 = time.perf_counter()
            rc = run_cell(cell, s, args.seconds, False, device, START,
                          out=io.StringIO(), err=io.StringIO(), record=rec)
            emit({"cell": name, "kind": "program", "seed": s, "rc": rc,
                  "correct": rec.get("result", {}).get("correct"),
                  "numbers": rec.get("numbers"),
                  "seconds": time.perf_counter() - t0})
            for k, v in (rec.get("numbers") or {}).items():
                prog.setdefault(name, {}).setdefault(k, []).append(v)
        key = control_key(cell)
        if key in ctl:
            continue
        ctl[key] = {}
        ref_mod = load_reference(cell.config)
        model = ScanModel.from_config(cell.config)
        shifts = list(cell.mix["options"]["shift"])
        fit = int(cell.config["fit_shift"])
        for s in seeds(args.control_seeds, args.salt + 1000):
            t0 = time.perf_counter()
            tmp = tempfile.mkdtemp(prefix="shgbench_control_")
            scan = ScanFile(model, s, device, os.path.join(tmp, "scan.ser"))
            try:
                ref = ref_mod.run(scan.path, shifts=shifts, fit_shift=fit)
                low = ref_mod.run(scan.path, shifts=shifts, fit_shift=fit,
                                  bits=int(cell.config["control_bits"]))
            finally:
                scan.close()
                os.rmdir(tmp)
            nums = compare.control_numbers(low, ref)
            emit({"config": cell.config_name, "shifts": shifts,
                  "kind": "control", "seed": s, "numbers": nums,
                  "seconds": time.perf_counter() - t0})
            for k, v in nums.items():
                ctl[key].setdefault(k, []).append(v)
    for cell in cells:
        for k, vals in sorted(prog.get(cell.name, {}).items()):
            up = ctl[control_key(cell)].get(k)
            emit({"summary": cell.name, "number": k, "lower": max(vals),
                  "program": vals, "upper": min(up) if up else None})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
