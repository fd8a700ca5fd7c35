"""Reference-compatible single-letter flag parser.

A copy of solex_ser_recon_en_tpu/cli/flags.py (that package imports jax on
import) with the port's long options: ``--device``, ``--output-dir``,
``--input-dir``, ``--num-processes`` and ``--process-id`` (with the
``SOLEX_NUM_PROCESSES`` / ``SOLEX_PROCESS_ID`` fallback), ``--feed`` and
``--mesh`` (parallel/mesh.py:parse_mesh_spec); ``--profile`` is taken by
cli/main.py, as there.  A bad ``--feed`` mode, a bad ``--mesh`` spec and
any unknown ``--name`` are refused (``UnsupportedOption``).

reference: CLI_handler.py:10-114 — flags may be packed (``-tw 0,5``); ``w``
consumes a shift spec (``a,b,c`` / ``x:y`` / ``x:y:w``); ``r`` consumes an
integer width; files must end .SER/.AVI.
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

from ..config import Options


def usage() -> str:
    return (
        "shg-torch [-hwdxfcpstmr] [file(s) to treat, * allowed]\n"
        "'h' : 'Help', display help menu.\n"
        "'w' : 'a,b,c, ...'  produce images at a, b, c ... pixels.\n"
        "'w' : 'x:y:w'  produce images starting at x, finishing at y, every w pixels.\n"
        "'d' : 'flag_display', display all graphics (False by default)\n"
        "'x' : 'ratio_fixe', disable ellipse fitting\n"
        "'f' : 'save_fit', save all fits files (False by default)\n"
        "'c' : 'clahe_only',  only final clahe image is saved (False by default)\n"
        "'p' : 'disk_display' turn off black disk with protuberance images (False by default)\n"
        "'s' : 'crop_square_width', crop the width to equal the height (False by default)\n"
        "'t' : 'disable transversalium', disable transversalium correction (False by default)\n"
        "'m' : 'mirror flip', mirror flip in x-direction (False by default)\n"
        "'r' : 'w'  crop width to a constant no. of pixels.\n"
        "'--device DEV' : 'cuda' (default) or 'cpu'; CUDA must be present\n"
        "    when asked for.\n"
        "'--output-dir DIR' : write products to DIR (default: next to\n"
        "    each input file).\n"
        "'--input-dir DIR' : folder batch over DIR's *.ser and *.avi\n"
        "    (used when no file is named).\n"
        "'--num-processes N --process-id I' : process this host's\n"
        "    deterministic 1/N share of the folder batch (every process\n"
        "    computes the same split locally).\n"
        "'--profile[=dir]' : write a torch.profiler trace of the run.\n"
        "'--feed MODE' : auto (default) | device | band | host: how much\n"
        "    of the scan crosses to the card (band: only the recon's\n"
        "    spectral band; host: nothing, everything on the host).\n"
        "'--mesh SPEC' : device mesh: frame=N (a scan's frames over N\n"
        "    cards), batch=B,frame=F, or a bare N (= frame=N); more\n"
        "    devices than the machine has is an error (exit code 2).\n"
        "'d' is refused.  Without 'c' the diagnostic figures are\n"
        "written as well, which needs matplotlib."
    )


MAX_SHIFTS = 10_000  # every shift materialises an (ih, F) disk


def _bounded(shifts: "range | List[int]") -> List[int]:
    # the reference materialises any range unchecked (CLI_handler.py:69-71);
    # a typo'd bound like 0:99999999 would OOM building 1e8 disks, so fail
    # fast with a clear message instead
    if len(shifts) > MAX_SHIFTS:
        raise ValueError(
            f"shift spec yields {len(shifts)} shifts (max {MAX_SHIFTS})"
        )
    return list(shifts)


def parse_shift_spec(spec: str) -> List[int]:
    """``a,b,c`` | ``x:y`` | ``x:y:w`` -> list of pixel shifts.

    reference: CLI_handler.py:64-73 (and UI_handler.py:22-33).
    """
    parts = spec.split(":")
    if len(parts) == 1:
        return _bounded([int(x.strip()) for x in spec.split(",")])
    if len(parts) == 2:
        return _bounded(
            range(int(parts[0].strip()), int(parts[1].strip()) + 1)
        )
    if len(parts) == 3:
        return _bounded(
            range(
                int(parts[0].strip()),
                int(parts[1].strip()) + 1,
                int(parts[2].strip()),
            )
        )
    raise ValueError("invalid shift input")


def _apply_flag_group(options: Options, argument: str) -> None:
    """One ``-...`` group; mirrors CLI_handler.treat_flag_at_cli."""
    options.disk_display = True  # on by default under CLI (reference :42)
    chars = argument[1:]
    i = 0
    while i < len(chars):
        ch = chars[i]
        if ch == "h":
            print(usage())
            sys.exit(0)
        elif ch == "w":
            spec = ""
            i += 1
            while i < len(chars) and (chars[i].isdigit() or chars[i] in ":,-"):
                spec += chars[i]
                i += 1
            if not spec:
                print("invalid shift input (use e.g. -w0 or -w-5:5:1 — the "
                      "spec is part of the flag token)")
                sys.exit(1)
            try:
                options.shift = parse_shift_spec(spec)
            except ValueError:
                print("invalid shift input")
                sys.exit(1)
        elif ch == "t":
            options.transversalium = False
            i += 1
        elif ch == "p":
            options.disk_display = False
            i += 1
        elif ch == "x":
            options.ratio_fixe = 1  # disables the ellipse fit correction
            i += 1
        elif ch == "r":
            fw = ""
            i += 1
            while i < len(chars) and chars[i].isdigit():
                fw += chars[i]
                i += 1
            if not fw:
                print("invalid fixed width (use e.g. -r1100 — the width is "
                      "part of the flag token)")
                sys.exit(1)
            options.fixed_width = int(fw)
        elif ch == "d":
            options.flag_display = True
            i += 1
        elif ch == "f":
            options.save_fit = True
            i += 1
        elif ch == "c":
            options.clahe_only = True
            i += 1
        elif ch == "s":
            options.crop_width_square = True
            i += 1
        elif ch == "m":
            options.flip_x = True
            i += 1
        else:
            print("ERROR !!! At least one argument is not accepted")
            print(usage())
            i += 1


#: long options of the JAX package's CLI (solex_ser_recon_en_tpu/cli/
#: flags.py:193-202) that this port does not run yet; each is refused,
#: never read as packed letters (none is left)
UNPORTED_LONG_OPTS = ()


class UnsupportedOption(ValueError):
    """A ``--name`` option this port refuses (cli/main.py exits 2)."""


def parse_cli(options: Options, argv: List[str]) -> Tuple[List[str], str]:
    """Parse argv into options; returns (input files, device name).

    reference: CLI_handler.py:103-114.  Raises UnsupportedOption for an
    unported or unknown ``--name`` before anything is created.
    """
    state = {"device": "cuda", "output_dir": None}

    def set_device(name: str) -> None:
        state["device"] = name

    def set_output_dir(path: str) -> None:
        state["output_dir"] = path

    def set_int(name: str, field: str):
        def setter(value: str) -> None:
            try:
                setattr(options, field, int(value))
            except ValueError:
                print(f"{name} needs an integer, got {value!r}")
                sys.exit(1)
        return setter

    def set_input_dir(path: str) -> None:
        options.input_dir = path

    def set_feed(mode: str) -> None:
        if mode not in ("auto", "device", "band", "host"):
            print(f"invalid feed mode {mode!r} (auto|device|band|host)")
            raise UnsupportedOption(f"--feed {mode!r}: not a feed mode")
        options.feed_mode = mode

    def set_mesh(spec: str) -> None:
        from ..parallel.mesh import parse_mesh_spec

        try:
            options.mesh = parse_mesh_spec(spec)
        except ValueError as e:
            raise UnsupportedOption(f"--mesh: {e}") from e

    # --num-processes/--process-id select this host's deterministic share
    # of a folder batch (parallel/distributed.assign_files) — the
    # host-scale analogue of the reference's Pool(4), Solex_recon.py:30.
    long_opts = {
        "--device": (set_device, "a device (cuda|cpu)"),
        "--output-dir": (set_output_dir, "a folder path"),
        "--num-processes": (set_int("--num-processes", "num_processes"),
                            "an integer"),
        "--process-id": (set_int("--process-id", "process_id"),
                         "an integer"),
        "--input-dir": (set_input_dir, "a folder path"),
        "--feed": (set_feed, "a mode (auto|device|band|host)"),
        "--mesh": (set_mesh, "a spec (e.g. --mesh frame=8)"),
    }

    files: List[str] = []
    pending = None  # long-option name awaiting its value argument
    for argument in argv:
        if pending is not None:
            long_opts[pending][0](argument)
            pending = None
            continue
        name = argument.split("=", 1)[0]
        if name in long_opts:
            if "=" in argument:
                long_opts[name][0](argument.split("=", 1)[1])
            else:
                pending = name
        elif name in UNPORTED_LONG_OPTS:
            raise UnsupportedOption(
                f"option {name} is not ported to solex_ser_recon_en_torch yet")
        elif argument.startswith("--"):
            raise UnsupportedOption(f"unknown option {name}")
        elif argument.startswith("-"):
            _apply_flag_group(options, argument)
        else:
            ext = argument.split(".")[-1].upper()
            if ext in ("SER", "AVI"):
                files.append(argument)
            else:
                print(
                    f"WARNING: {argument} was not a valid SER or AVI file name and "
                    'was ignored. Remember to use "-" if you want to input a flag'
                )
    if pending is not None:
        print(f"{pending} requires {long_opts[pending][1]}")
        sys.exit(1)
    path = state["output_dir"]
    if path is not None:
        try:
            os.makedirs(path, exist_ok=True)
        except OSError as e:
            print(f"--output-dir: cannot create {path!r}: {e}")
            sys.exit(1)
        options.output_dir = path
    # env fallbacks for orchestrators that set one env per process instead
    # of editing argv (multi-host launchers)
    if options.num_processes == 1 and "SOLEX_NUM_PROCESSES" in os.environ:
        try:
            # parse BOTH before assigning either: a malformed process id
            # must not leave num_processes applied with process_id=0 (this
            # host would silently take shard 0's files and nobody else's)
            n = int(os.environ["SOLEX_NUM_PROCESSES"])
            pid = int(os.environ.get("SOLEX_PROCESS_ID", "0"))
        except ValueError:
            print("malformed SOLEX_NUM_PROCESSES/SOLEX_PROCESS_ID ignored")
        else:
            options.num_processes = n
            options.process_id = pid
    return files, state["device"]
