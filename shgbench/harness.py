"""One run of one benchmark cell: set-up, the measured window, the metrics
and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix or metric is
data found by name: ``BENCHMARK.json`` names the cell's configuration and
mix; ``configs/<config>.json`` holds the scan's geometry and synthetic
parameters and names its reference; ``mixes/<traffic>.json`` names the
kind of loop (``serial`` or ``session``) and the program's options;
``metrics/<metric>.py`` reads one metric from the run's records;
``limits/<cell>.json`` holds the limits of the compared numbers.

The program under test is ``solex_ser_recon_en_torch``; it is imported
only after the run's environment is set, and receives only the scan file.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import random
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import compare, roofline
from .generator import ScanFile, ScanModel

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "solex_ser_recon_en_tpu")


# -- what the benchmark names ---------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    e2e: List[dict]
    per_layer: List[dict]


def bench_with_pending(bench: Optional[dict] = None) -> dict:
    """``bench`` (by default BENCHMARK.json) with what the files under
    ``shgbench/pending/`` define and it lacks, as a later change would add
    it: each configuration, cell and metric of a name it does not hold
    appended, and each pending cell's name added to the ``workloads`` of
    the metrics it ``reports`` where it is not there yet.  A pending cell
    that ``bench`` already holds thus adds nothing; one that it holds with
    another configuration, traffic or number of chips (not another
    ``why``) raises ``ValueError``.  ``bench`` itself is not changed."""
    bench = (load_json(ROOT / "BENCHMARK.json") if bench is None
             else json.loads(json.dumps(bench)))
    pendings = [load_json(p)
                for p in sorted((BENCH_DIR / "pending").glob("*.json"))]
    for pending in pendings:
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            held = {e["name"]: e for e in bench[key]}
            for entry in pending.get(key, []):
                if entry["name"] not in held:
                    bench[key].append(entry)
                elif key == "workloads":
                    keys = ("config", "traffic", "chips")
                    have = {k: held[entry["name"]][k] for k in keys}
                    want = {k: entry[k] for k in keys}
                    if have != want:
                        raise ValueError(
                            f"workload {entry['name']!r} in BENCHMARK.json "
                            f"is {have}, its pending file defines {want}")
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for pending in pendings:
        for cell in pending.get("workloads", []):
            for name in pending.get("reports", []):
                cells = metrics[name].get("workloads")
                if cells is not None and cell["name"] not in cells:
                    cells.append(cell["name"])
    return bench


def load_cell(name: str, bench: Optional[dict] = None,
              override: Optional[dict] = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its configuration, mix,
    limits and metrics; ``override`` replaces configuration keys (tests
    run the same cell at a size the CPU can hold)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    config.update(override or {})

    def reports(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in names and reports(m)]
    return Cell(name=name, config_name=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]), config=config,
                mix=load_json(BENCH_DIR / "mixes" / f"{w['traffic']}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
                e2e=e2e, per_layer=per_layer)


def load_reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read(run)``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "shgbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_reference(config: dict):
    """The configuration's plain reference module, by its path."""
    path = ROOT / config["reference"]
    spec = importlib.util.spec_from_file_location(
        "shgbench_reference_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- what a run records ------------------------------------------------------------

@dataclass
class ScanRecord:
    latency_s: float
    ok: bool
    stages: Dict[str, float] = field(default_factory=dict)
    feed: Dict[str, float] = field(default_factory=dict)


@dataclass
class SessionRecord:
    wall_s: float
    files: int
    done: int
    feeds: List[dict] = field(default_factory=list)


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    model: ScanModel
    setup_s: float
    window_s: float
    scans: List[ScanRecord] = field(default_factory=list)
    sessions: List[SessionRecord] = field(default_factory=list)
    trace: object = None            # trace.TraceSummary of a traced run
    compute_s: Optional[float] = None   # the card's kernel time in the window
    product_shape: tuple = None     # (h, w) of the product image
    kind: str = ""

    @property
    def scans_done(self) -> int:
        if self.sessions:
            return sum(s.done for s in self.sessions)
        return sum(r.ok for r in self.scans)

    @property
    def frames_done(self) -> int:
        if self.sessions:
            return self.model.frames * sum(s.done for s in self.sessions)
        return self.model.frames * sum(r.ok for r in self.scans)

    def feeds(self) -> List[dict]:
        if self.sessions:
            return [f for s in self.sessions for f in s.feeds]
        return [r.feed for r in self.scans if r.ok]

    def stage_ms(self, *names: str) -> Optional[float]:
        ok = [r for r in self.scans if r.ok]
        if not ok:
            return None
        return 1e3 * sum(r.stages.get(n, 0.0) for r in ok for n in names
                         ) / len(ok)

    def roofline_pct(self, needle: str, bytes_per_scan: int) -> Optional[float]:
        """Share of the least time for ``bytes_per_scan`` per scan of the
        window that the kernels named ``needle`` took on the device."""
        if self.trace is None:
            return None
        secs, launches = self.trace.kernel_time(needle)
        n = self.scans_done
        if not launches or not n or secs <= 0:
            return None
        least = n * bytes_per_scan / roofline.peak_bandwidth(self.kind)
        return 100.0 * least / secs


def percentile(values: List[float], q: float) -> float:
    """Linear interpolation between order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


# -- the program's side ---------------------------------------------------------------

class _Sink:
    """Swallows the program's progress prints inside a run."""

    def write(self, s: str) -> int:
        return len(s)

    def flush(self) -> None:
        pass


def _tracing_timer_class():
    import torch

    from solex_ser_recon_en_torch.utils.timer import StageTimer

    from .trace import STAGE

    class TracingTimer(StageTimer):
        """The program's StageTimer, each stage also a profiler range."""

        @contextlib.contextmanager
        def stage(self, name: str):
            with torch.profiler.record_function(STAGE + name):
                with super().stage(name):
                    yield

    return TracingTimer


@contextlib.contextmanager
def _post_outputs():
    """Keep each requested shift's circularised disk and transversalium row
    gain of the last scan that ``pipeline.run`` post-processed, as that
    scan's own calls returned them (the calls themselves unchanged):
    ``single_image_process``, which ``_process_shifts`` calls once a
    requested shift with the circularised frame and a ``basefich`` that ends
    in ``_shift=S``, and the ``transversalium_gain`` it calls; by shift,
    under ``"products"``."""
    from solex_ser_recon_en_torch.pipeline import run as run_mod

    seen: Dict[str, Dict[int, dict]] = {}
    single, gain = run_mod.single_image_process, run_mod.transversalium_gain
    current: List[dict] = []

    def single_image_process(frame, hdr, options, circle, borders, basefich,
                             *a, **k):
        shift = int(basefich.rsplit("_shift=", 1)[1])
        current.append({"warped": frame})
        seen.setdefault("products", {})[shift] = current[-1]
        try:
            return single(frame, hdr, options, circle, borders, basefich,
                          *a, **k)
        finally:
            current.pop()

    def transversalium_gain(*a, **k):
        out = gain(*a, **k)
        if current:
            current[-1]["gain"] = out[0]
        return out

    run_mod.single_image_process = single_image_process
    run_mod.transversalium_gain = transversalium_gain
    try:
        yield seen
    finally:
        run_mod.single_image_process = single
        run_mod.transversalium_gain = gain


def _program_outputs(scan, opts, results, post) -> Dict[str, object]:
    """The timed path's results of one scan, brought to host arrays; each
    requested shift's circularised disk and row gain under ``products``."""
    import torch

    def host(p):
        h = {}
        if "warped" in p:
            h["warped"] = p["warped"].view(torch.int16).cpu().numpy().view(
                np.uint16)
        if "gain" in p:
            h["gain"] = np.asarray(p["gain"], np.float64)
        return h

    disks = scan.disk_list.view(torch.int16).cpu().numpy().view(np.uint16)
    return {"mean": np.array(scan.mean_img), "curve": np.array(
        scan.linefit.curve), "disks": disks, "shifts": list(scan.shifts),
        "ratio": float(opts.ratio_fixe), "tilt_deg": float(opts.slant_fix),
        "products": {s: host(p) for s, p in post.get("products", {}).items()}}


def product_pngs(folder: Path) -> Dict[str, Dict[int, Path]]:
    """The ``*_clahe.png`` of ``folder`` by scan (the name before
    ``_shift=``) and shift (the ``S`` of ``_shift=S_clahe.png``)."""
    found: Dict[str, Dict[int, Path]] = {}
    for p in sorted(folder.glob("*_clahe.png")):
        stem, shift = p.name[:-len("_clahe.png")].rsplit("_shift=", 1)
        found.setdefault(stem, {})[int(shift)] = p
    return found


def drive_serial(path: str, out_dir: Path, options: dict, device,
                 seconds: float, timer_cls, seed: int, keep: bool):
    """``read_scan`` then ``process_scan`` of one scan, back to back, until
    ``seconds`` have passed; returns (records, window seconds, the
    results of one scan drawn from the seed (and its PNG), of the last)."""
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.io.feeder import FEED
    from solex_ser_recon_en_torch.pipeline.run import process_scan, read_scan

    rng = random.Random(seed)
    records, sample, last = [], None, None
    t_start = time.perf_counter()
    i = 0

    def drop(entry):
        # a scan's files that no comparison reads: removed while their pages
        # are still dirty, so that no write-back of old products runs under
        # later scans
        if entry is not None and entry is not sample and entry is not last:
            shutil.rmtree(entry[4], ignore_errors=True)

    with _post_outputs() as post:
        while True:
            scan_dir = out_dir / f"scan{i:04d}"
            scan_dir.mkdir(parents=True)
            opts = Options(**options, output_dir=str(scan_dir))
            timer = timer_cls()
            t0 = time.perf_counter()
            try:
                scan = read_scan(path, opts, device, timer)
                res = process_scan(scan, opts, timer)
                ok = True
            except Exception:
                traceback.print_exc(limit=6, file=sys.stderr)
                ok, scan, res = False, None, None
            t1 = time.perf_counter()
            records.append(ScanRecord(t1 - t0, ok, dict(timer.times),
                                      dict(FEED)))
            entry = (scan, opts, res, dict(post), scan_dir)
            post.clear()
            if ok and keep:
                old = (sample, last)
                # one scan of the window drawn uniformly from the seed
                if rng.randrange(i + 1) == 0:
                    sample = entry
                last = entry
                for e in old:
                    drop(e)
            else:
                shutil.rmtree(scan_dir, ignore_errors=True)
            i += 1
            if t1 - t_start >= seconds:
                return records, t1 - t_start, sample, last


@contextlib.contextmanager
def _last_scan_of(module, found: dict):
    """Keep the ScanResult, options, results, circularised disk and row gain
    of the last scan that ``module``'s ``process_scan`` finished (the session loop's own call,
    unchanged)."""
    process = module.process_scan

    def process_scan(scan, options, timer=None):
        results = process(scan, options, timer)
        found["last"] = (scan, options, results, dict(post))
        post.clear()
        return results

    module.process_scan = process_scan
    try:
        with _post_outputs() as post:
            yield found
    finally:
        module.process_scan = process


def drive_session(links: List[str], out_dir: Path, options: dict, device,
                  seconds: float):
    """``handle_files`` over the session's files, one session after another
    until ``seconds`` have passed; returns (records, window seconds, the
    last session's output directory, the last scan's results)."""
    from solex_ser_recon_en_torch.cli import main as cli_main
    from solex_ser_recon_en_torch.config import Options
    from solex_ser_recon_en_torch.io.feeder import FEED

    records = []
    t_start = time.perf_counter()
    j = 0
    with _last_scan_of(cli_main, {}) as found:
        while True:
            if j:
                # the last session's files, which no comparison reads
                # (drive_serial's ``drop``)
                shutil.rmtree(sess_dir, ignore_errors=True)
            sess_dir = out_dir / f"session{j:03d}"
            sess_dir.mkdir(parents=True)
            feeds: List[dict] = []

            def meter(i, n, msg, feeds=feeds):
                if i > 0:       # file i - 1 has been read
                    feeds.append(dict(FEED))

            opts = Options(**options, output_dir=str(sess_dir))
            t0 = time.perf_counter()
            done = cli_main.handle_files(list(links), opts, device, meter)
            t1 = time.perf_counter()
            records.append(SessionRecord(t1 - t0, len(links), done, feeds))
            j += 1
            if t1 - t_start >= seconds:
                return records, t1 - t_start, sess_dir, found.get("last")


# -- one run -------------------------------------------------------------------------

def _io_counters() -> Dict[str, int]:
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (ln.split(":") for ln in f)}
    except OSError:
        return {}


def forbidden_modules() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             start: float, out=None, err=None,
             record: Optional[dict] = None) -> int:
    """One run: prints its result as the last line of ``out`` and its
    compared numbers as the last lines of ``err``.  ``start`` is the
    perf_counter reading at process start.  ``record``, when given,
    receives the result and every number compared (shgbench/calibrate.py).
    Returns the exit code."""
    import torch

    out = out or sys.stdout
    err = err or sys.stderr
    from solex_ser_recon_en_torch.utils.timer import StageTimer

    model = ScanModel.from_config(cell.config)
    tmp_root = Path(tempfile.mkdtemp(prefix="shgbench_"))
    scan_file = None
    try:
        scan_file = ScanFile(model, seed, device,
                             str(tmp_root / f"{cell.config_name}.ser"))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        kind = cell.mix["kind"]
        options = dict(cell.mix["options"])
        timer_cls = _tracing_timer_class() if trace else StageTimer
        links = [scan_file.path]
        if kind == "session":
            in_dir = tmp_root / "in"
            in_dir.mkdir()
            links = []
            for i in range(int(cell.mix["files"])):
                ln = in_dir / f"{cell.config_name}_{i:02d}.ser"
                os.symlink(scan_file.path, ln)
                links.append(str(ln))

        def window(secs: float, out_dir: Path, keep: bool):
            if kind == "serial":
                return drive_serial(scan_file.path, out_dir, options, device,
                                    secs, timer_cls, seed, keep)
            if kind == "session":
                return drive_session(links, out_dir, options, device, secs)
            raise ValueError(f"unknown kind of mix {kind!r}")

        with contextlib.redirect_stdout(_Sink()):
            # warm-up: the cell's own shapes through its own loop, untimed
            warm = cell.mix.get("warmup", {})
            if kind == "serial":
                for k in range(int(warm.get("scans", 2))):
                    drive_serial(scan_file.path, tmp_root / "warmup" / str(k),
                                 options, device, 0.0, StageTimer, seed, False)
            else:
                drive_session(links[:int(warm.get("files", 2))],
                              tmp_root / "warmup", options, device, 0.0)
            shutil.rmtree(tmp_root / "warmup", ignore_errors=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            setup_s = time.perf_counter() - start

            # a traced run records the host and the card; on the card every
            # other run records the card's activity alone, which an
            # end-to-end metric read from the device trace needs
            prof = None
            acts = []
            if trace:
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
            elif device.type == "cuda" and any(
                    m["source"] == "device_trace" for m in cell.e2e):
                acts = [torch.profiler.ProfilerActivity.CUDA]
            if acts:
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            from .trace import WINDOW
            with torch.profiler.record_function(WINDOW):
                res = window(seconds, tmp_root / "out", True)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            if prof is not None:
                prof.stop()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)

        run = Run(cell=cell, model=model, setup_s=setup_s, window_s=res[1],
                  kind=(torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"))
        attempted = failed = 0
        requested = list(dict.fromkeys(options["shift"]))
        # the product PNGs compared, one {shift: path} a scan
        pngs: List[Dict[int, Path]] = []
        progs: List[Dict[str, object]] = []
        if kind == "serial":
            records, _, sample, last = res
            run.scans = records
            attempted, failed = len(records), sum(not r.ok for r in records)
            for entry in {id(e): e for e in (sample, last) if e}.values():
                progs.append(_program_outputs(*entry[:4]))
                pngs.extend(product_pngs(entry[4]).values() or [{}])
            entry = sample = last = res = None
        else:
            records, _, last_dir, last = res
            run.sessions = records
            attempted = sum(s.files for s in records)
            failed = attempted - sum(s.done for s in records)
            if last is not None:
                progs.append(_program_outputs(*last))
            found = product_pngs(last_dir)
            pngs = [found.pop(Path(ln).stem, {}) for ln in links]
            failed += sum(not set(requested) <= set(p) for p in pngs)
            pngs += found.values()      # PNGs of no file of the session
            last = res = None
        if device.type == "cuda":
            torch.cuda.empty_cache()

        if prof is not None:
            from .trace import compute_seconds, summarize

            trace_path = tmp_root / "trace.json"
            prof.export_chrome_trace(str(trace_path))
            prof = None
            if trace:
                run.trace = summarize(str(trace_path))
                run.compute_s = run.trace.compute_s
            else:
                run.compute_s = compute_seconds(str(trace_path))
            trace_path.unlink()

        # the comparison, after the window and the peak reading
        ref_mod = load_reference(cell.config)
        ref = ref_mod.run(scan_file.path, shifts=list(options["shift"]),
                          fit_shift=int(cell.config["fit_shift"]))
        rows = [compare.scan_numbers(p, ref) for p in progs]
        strays = []
        for found in pngs:
            # each requested shift's product against the reference's of that
            # shift; a missing one, or one of a shift nobody asked for, makes
            # the run not correct
            if set(found) != set(requested):
                strays.append(found)
            imgs = {s: compare.read_png(str(p)) for s, p in found.items()
                    if s in requested}
            for img in imgs.values():
                run.product_shape = img.shape
            rows.append(compare.product_numbers(imgs, ref))
        numbers = compare.worst(rows)
        chk = compare.checks(numbers, cell.limits)
        correct = (bool(pngs) and not strays and failed == 0
                   and compare.passed(chk))

        metrics = {}
        for m in (cell.per_layer if trace else cell.e2e):
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
               "kind": run.kind, "count": cell.chips,
               "memory_peak_bytes": int(peak)}
        result = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": dev}
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            dev["window_s"] = run.trace.window_s
            result["breakdown"] = run.trace.breakdown()
        result["checks"] = chk

        io = _io_counters()
        print(f"shgbench: {cell.name} seed {seed}: {attempted} attempted, "
              f"{failed} failed in {run.window_s:.3f} s; the scan file "
              f"({scan_file.size} bytes) rendered and written in "
              f"{scan_file.seconds['render_write']:.3f} s, flushed in "
              f"{scan_file.seconds['fsync']:.3f} s; this process wrote "
              f"{io.get('write_bytes', 0)} bytes to storage "
              f"({io.get('wchar', 0)} bytes through write calls)", file=err)
        feeds = [f for f in run.feeds() if f.get("fill_s")]
        if feeds:
            # where a run's time went, in every run: host-clock stage means
            # and the feed's host copy rate
            stages = ", ".join(
                f"{n} {v:.1f} ms" for n, v in (
                    (n, run.stage_ms(n)) for n in (
                        "mean/max", "line fit", "ellipse fit", "warp",
                        "products")) if v is not None)
            rate = (sum(f["bytes"] for f in feeds)
                    / sum(f["fill_s"] for f in feeds) / 1e9)
            print(f"shgbench: stages a scan {stages or 'not timed'}; the "
                  f"feed's host copy {rate:.2f} GB/s", file=err)
        for found in strays:
            print(f"shgbench: products of shifts {sorted(found)} where "
                  f"{requested} were requested "
                  f"({', '.join(p.name for p in found.values()) or 'none'})",
                  file=err)
        for k, v in numbers.items():
            if k not in chk:
                print(f"number {k} {v!r} (not limited)", file=err)
        for k, c in chk.items():
            verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
            print(f"check {k} {c['value']!r} limit {c['limit']!r} {verdict}",
                  file=err)
        err.flush()
        bad = forbidden_modules()
        if bad:
            print(f"shgbench: the run loaded {', '.join(bad)}; no result",
                  file=err)
            return 4
        if record is not None:
            record.update(result=result, numbers=numbers)
        print(json.dumps(result), file=out)
        out.flush()
        return 0
    finally:
        if scan_file is not None:
            scan_file.close()
        shutil.rmtree(tmp_root, ignore_errors=True)
