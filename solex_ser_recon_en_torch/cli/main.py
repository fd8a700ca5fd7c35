"""App driver: file batches, config persistence, folder/continuous modes.

Counterpart of solex_ser_recon_en_tpu/cli/main.py.  reference:
SHG_MAIN.py:75-248 — JSON config round-trip (SHG_config.txt), per-file
option copies, openability prechecks, folder glob and continuous-detect
watcher (1-file batches, skip-processed).

Files run on ``--device`` (default ``cuda``; asking for CUDA where it is
absent is an error, never a silent CPU run).  ``handle_files`` overlaps
the files: a one-worker pool runs ``process_scan`` of file N while this
thread runs ``read_scan`` of file N+1, so the next scan's feed, pass A and
pass B hide the post-processing of the last (the reference's Pool(4),
Solex_recon.py:26-44).  At most one scan waits in the pool, so two scans'
device state are live at once.  Both threads
queue their CUDA work on the device's default stream, which orders every
hand-off of a ScanResult's tensors.  Each scan's product writes are its
own (io/writers.py:scan_writes): a failed write is the failure of the
file that queued it.  The diagnostic figures of the default mode render
after the last file.  ``-d`` where no window can be opened, and a mode
that writes figures where matplotlib is absent, exit 2 with nothing
written (pipeline/run.py:check_supported).
``--mesh SPEC`` shards each scan's frames over the machine's cards
(pipeline/run.py); a mesh larger than the visible cards exits 2, nothing
written.

The session's steps are spans of one StageTimer's stage ``session``
(utils/timer.py): ``read`` (each file's read_scan), ``post wait`` (the
wait for the last scan's post-processing after each read), ``tail`` (the
wait after the last read) and, on the pool thread, ``post`` (each
process_scan, the outer range of that scan's post stages).  While a
profiler records each is the range ``stage:session:<step>``.  ``SESSION``
keeps the last call's seconds of each step, the posts' time queued in
the pool (``queue_s``), the files' wall time and the scans done.

A batch of more than ``PROBE_BATCH_BYTES`` rates the link to the card
once up front (io/feeder.py:probe_transfer_rate), so every file of it,
however small, takes the ``auto`` feed on the same reading (pipeline/
run.py:auto_feed).

The GUI (gui/main_window.py:run_app) hands ``handle_files`` the batch
progress meter (reference: Solex_recon.py:34-44); the CLI gives none.
Where the JAX driver swallows every error of the meter, an error here is
the batch's.

Not ported from the JAX driver: the relay-link probe
(``utils/backend.py:ensure_responsive_backend``, which falls back to the
CPU), the inline branch for one-core hosts, and the small-scan group read
of pipeline/batch.py, which on the card is slower than reading each scan
beside the last one's post-processing (that module's docstring).
"""

from __future__ import annotations

import contextvars
import glob
import os
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional

import torch

from ..config import Options
from ..io.feeder import probe_transfer_rate
from ..io.video import open_video
from ..io.writers import figure_barrier
from ..parallel.distributed import shard_folder_batch
from ..parallel.mesh import mesh_from_options
from ..pipeline.run import check_supported, process_scan, read_scan
from ..utils.device import resolve_device
from ..utils.timer import StageTimer, span
from .flags import UnsupportedOption, parse_cli, usage

CONFIG_NAME = "SHG_config.txt"
#: a batch of more bytes than this gets one link probe before its first file
PROBE_BATCH_BYTES = 256 * 1024**2

#: the last ``handle_files`` call's counters, reset at its start: scans
#: done; seconds of the reads, of the pool thread's posts, of the waits
#: for a post between reads and after the last read, of the posts' time
#: queued in the pool, and of the files' whole run (reads and posts)
SESSION: Dict[str, float] = {}


def read_ini(path: str = CONFIG_NAME) -> Options:
    try:
        return Options.load(path)
    except Exception:
        print("note: error reading config file - using default parameters")
        return Options()


def write_ini(options: Options, path: str = CONFIG_NAME) -> None:
    try:
        options.save(path)
    except Exception:
        traceback.print_exc()
        print("ERROR: failed to write config file: " + path)


def precheck_files(files: Iterable[str], options: Options) -> List[tuple]:
    """Validate openability; build per-file (file, options-copy) tasks.

    reference: SHG_MAIN.py:98-132.
    """
    files = list(files)
    options.tempo = 30000 if len(files) == 1 else 5000
    good = []
    for f in files:
        if not f or os.path.basename(f) == "":
            print("ERROR filename empty")
            continue
        try:
            with open(f, "rb"):
                pass
        except Exception:
            traceback.print_exc()
            print("ERROR opening file : ", f)
            continue
        good.append((f, options.copy()))
    return good


def is_openable(file: str) -> bool:
    """reference: SHG_MAIN.py:145-152."""
    try:
        return open_video(file).frame_count > 0
    except Exception:
        return False


def _post(scan, options: Options, timer: StageTimer, queued_at: float):
    """``process_scan`` on the pool thread, under the session's span
    ``post``; called through the module's name, which callers may wrap."""
    SESSION["queue_s"] += time.perf_counter() - queued_at
    with span("post"):
        return process_scan(scan, options, timer)


def handle_files(files: Iterable[str], options: Options,
                 device: torch.device,
                 meter: Optional[Callable[[int, int, str], object]] = None
                 ) -> int:
    """Process a batch, overlapping each scan's post-processing with the
    next scan's read.

    reference: SHG_MAIN.py:134-143 + Solex_recon.py:26-44.  Returns the
    number of files fully processed.  ``meter(i, n, message)`` is the
    GUI's progress meter: called before file i of a batch of n > 1 files
    is read, and with i = n when the batch is done.
    """
    SESSION.update(scans=0, read_s=0.0, post_s=0.0, post_wait_s=0.0,
                   tail_s=0.0, queue_s=0.0, wall_s=0.0)
    tasks = precheck_files(files, options)

    def progress(i: int, msg: str) -> None:
        if meter is not None and len(tasks) > 1:
            meter(i, len(tasks), msg)

    # a batch worth more bytes than a link probe costs gets one probe up
    # front (memoised), so every file rides the feed the same rate chose
    try:
        batch_bytes = sum(os.path.getsize(f) for f, _ in tasks)
    except OSError:
        batch_bytes = 0     # a file went away: its own read reports it
    if batch_bytes > PROBE_BATCH_BYTES:
        probe_transfer_rate(device)

    def drain(pending: list) -> int:
        n = 0
        for file, fut, timer in pending:
            try:
                fut.result()
                n += 1
                print(f"{file} done:\n{timer.summary()}")
            except Exception:
                print(f"ERROR ENCOUNTERED: {file}")
                traceback.print_exc()
        pending.clear()
        return n

    done = 0
    session = StageTimer()
    with session.stage("session"):
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="solex-torch-post") as pool:
            pending = []
            for i, (file, opts) in enumerate(tasks):
                print(f"file {file} is processing")
                progress(i, "Reading file...")
                timer = StageTimer()
                try:
                    with span("read"):
                        scan = read_scan(file, opts, device, timer)
                except Exception:
                    print(f"ERROR ENCOUNTERED: {file}")
                    traceback.print_exc()
                    continue
                # the previous scan's post-processing ran while this one
                # was read; wait for it before queueing this one
                with span("post wait"):
                    done += drain(pending)
                # the pool thread runs the post in a copy of this thread's
                # context, so its span ``post`` is the session's
                pending.append((file, pool.submit(
                    contextvars.copy_context().run, _post, scan, opts, timer,
                    time.perf_counter()), timer))
            with span("tail"):
                done += drain(pending)
    t = session.times
    SESSION.update(scans=done, read_s=t.get("session:read", 0.0),
                   post_s=t.get("session:post", 0.0),
                   post_wait_s=t.get("session:post wait", 0.0),
                   tail_s=t.get("session:tail", 0.0), wall_s=t["session"])
    # deferred diagnostic-figure lane: join here so every file exists when
    # the command finishes (io/writers.py)
    try:
        figure_barrier()
    except Exception:
        print("ERROR ENCOUNTERED")
        traceback.print_exc()
    progress(len(tasks), "Done.")
    return done


def folder_scan_files(input_dir: str) -> List[str]:
    """All SER/AVI scans in a folder (the single source of the glob —
    shared with parallel.distributed.shard_folder_batch).

    reference: SHG_MAIN.py:156,192.
    """
    return glob.glob(os.path.join(input_dir, "*.ser")) + glob.glob(
        os.path.join(input_dir, "*.avi")
    )


def handle_folder(options: Options, device: torch.device,
                  poll_seconds: float = 1.0,
                  stop_after: Optional[float] = None) -> int:
    """Folder batch / continuous-detect mode.

    reference: SHG_MAIN.py:154-208 — non-continuous processes the current
    glob; continuous polls for new files, batch size 1, skipping processed/
    unreadable files, until stopped (here: stop_after seconds, None = run
    until KeyboardInterrupt).  Returns files processed.
    """
    def todo() -> List[str]:
        # this process's share: every process computes the same
        # deterministic hash split locally, no coordinator (one process
        # takes the whole folder) — the host-scale analogue of the
        # reference's Pool(4), Solex_recon.py:30
        return shard_folder_batch(options, options.num_processes,
                                  options.process_id)

    if not options.continuous_detect_mode:
        files = todo()
        print(f"number of files todo: {len(files)}")
        return handle_files(files, options, device)

    processed = set()
    count = 0
    start = time.monotonic()
    try:
        while stop_after is None or time.monotonic() - start < stop_after:
            batch = [
                f
                for f in todo()
                if f not in processed and os.access(f, os.R_OK) and is_openable(f)
            ][:1]
            if batch:
                count += handle_files(batch, options, device)
                processed.update(batch)
            else:
                time.sleep(poll_seconds)
    except KeyboardInterrupt:
        print("continuous mode stopped")
    return count


def _profiled(run, profile_dir: str, device: torch.device) -> int:
    """``run()`` under torch.profiler (CPU activity, and CUDA activity on
    the card) on every thread, the session's post pool included; the trace
    goes into ``profile_dir`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=activities,
                 experimental_config=every_thread) as prof:
        rc = run()
    path = os.path.join(profile_dir, f"solex_torch_{os.getpid()}_"
                        f"{time.strftime('%Y%m%d_%H%M%S')}.trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # --profile[=dir] wraps the run in a torch.profiler trace (the
    # reference's only hook is a dead cProfile branch, SHG_MAIN.py:225-228)
    profile_dir = None
    rest = []
    for a in argv:
        if a == "--profile":
            profile_dir = os.path.join(tempfile.gettempdir(), "solex_profile")
        elif a.startswith("--profile="):
            profile_dir = a.split("=", 1)[1]
        else:
            rest.append(a)
    options = Options()
    try:
        files, device_name = parse_cli(options, rest)
    except UnsupportedOption as e:
        print(f"ERROR: {e}")
        return 2
    if not files and not options.input_dir:
        print(usage())
        return 1
    try:
        device = resolve_device(device_name)
        options.validate()
        check_supported(options)
        # a mesh this machine cannot hold fails here, before any file or
        # log is written; each file's read builds it again
        mesh_from_options(options.mesh, device)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        print(f"ERROR: {e}")
        return 2

    def run() -> int:
        if not files:
            return 0 if handle_folder(options, device) > 0 else 1
        n = handle_files(files, options, device)
        return 0 if n == len(files) else 1

    if profile_dir:
        return _profiled(run, profile_dir, device)
    return run()


if __name__ == "__main__":
    sys.exit(main())
