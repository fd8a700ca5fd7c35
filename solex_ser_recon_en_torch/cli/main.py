"""Command line entry point: ``python -m solex_ser_recon_en_torch.cli file.ser``.

Counterpart of solex_ser_recon_en_tpu/cli/main.py: files are processed one
after the other on ``--device`` (default ``cuda``; asking for CUDA where it
is absent is an error, never a silent CPU run), with every product mode of
one scan (the letters ``w x f c p s t m r``); the diagnostic figures of the
default mode render after the last file.  ``-d`` is refused, and so is a
mode that writes figures where matplotlib is absent (exit code 2, nothing
written).
"""

from __future__ import annotations

import sys
import traceback
from typing import List, Optional

from ..config import Options
from ..io.writers import figure_barrier
from ..pipeline.run import check_supported, process_scan, read_scan
from ..utils.device import resolve_device
from ..utils.timer import StageTimer
from .flags import UnsupportedOption, parse_cli, usage


def handle_files(files: List[str], options: Options, device) -> int:
    """Process each file with its own options copy (SHG_MAIN.py:129
    semantics); returns the number of files fully processed."""
    done = 0
    for file in files:
        print(f"file {file} is processing")
        opts = options.copy()
        timer = StageTimer()
        try:
            scan = read_scan(file, opts, device, timer)
            process_scan(scan, opts, timer)
        except Exception:
            print("ERROR ENCOUNTERED")
            traceback.print_exc()
            continue
        done += 1
        print(f"{file} done:\n{timer.summary()}")
    return done


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    options = Options()
    try:
        files, device_name = parse_cli(options, argv)
    except UnsupportedOption as e:
        print(f"ERROR: {e}")
        return 2
    if not files:
        print(usage())
        return 1
    try:
        device = resolve_device(device_name)
        options.validate()
        check_supported(options)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        print(f"ERROR: {e}")
        return 2
    n = handle_files(files, options, device)
    # the deferred diagnostic figures: every file exists when main returns
    figure_barrier()
    return 0 if n == len(files) else 1


if __name__ == "__main__":
    sys.exit(main())
