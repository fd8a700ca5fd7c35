"""The folder session's spans and counter (cli/main.py: ``handle_files``,
``SESSION``) and its products against the benchmark's plain reference,
on the CPU at a small size.

Three scans of the ``fulldisk16_folder`` configuration's synthetic model at
300 frames x 512 rows x 96 spectral columns, each from its own seed, go
through one ``handle_files`` call; each file's pass A mean, disks,
circularised disk, row gain and ``_clahe.png`` are held to
``shgbench/reference/shg_c.py`` run on the same file, under the limits of
the ``fulldisk16.session`` cell."""

import json
import os

import pytest
import torch

from shgbench import compare
from shgbench.generator import ScanFile, ScanModel
from shgbench.harness import (ROOT, _post_outputs, _program_outputs,
                              load_reference)
from solex_ser_recon_en_torch.cli import main as cli
from solex_ser_recon_en_torch.config import Options

CPU = torch.device("cpu")
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)
STEPS = ("read", "post wait", "tail", "post")
KEYS = {"scans", "read_s", "post_s", "post_wait_s", "tail_s", "queue_s",
        "wall_s"}


def _config():
    with open(ROOT / "shgbench" / "configs" / "fulldisk16_folder.json") as f:
        cfg = json.load(f)
    # the benchmark's small size (shgbench/tests/conftest.py), the line
    # moved into the 96 columns
    cfg.update(frames=300, slit_px=512, spectral_px=96)
    cfg["assumed"] = dict(cfg["assumed"], line_poly=[48.0] + list(
        cfg["assumed"]["line_poly"][1:]))
    return cfg


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Three distinct scan files in one folder, and the configuration."""
    cfg = _config()
    model = ScanModel.from_config(cfg)
    folder = tmp_path_factory.mktemp("session_in")
    files = [ScanFile(model, seed, CPU, str(folder / f"s{i}.ser"))
             for i, seed in enumerate(SEEDS)]
    return cfg, [f.path for f in files]


def _options(out):
    return Options(shift=[0], clahe_only=True, output_dir=str(out))


@pytest.fixture(scope="module")
def session(scans, tmp_path_factory):
    """One ``handle_files`` over the three files: what it returned, a copy
    of ``SESSION``, each file's program outputs and its PNG."""
    cfg, paths = scans
    out = tmp_path_factory.mktemp("session_out")
    found = {}
    orig = cli.process_scan

    def process_scan(scan, options, timer=None):
        results = orig(scan, options, timer)
        found[os.path.basename(scan.basefich0)] = _program_outputs(
            scan, options, results, post)
        post.clear()
        return results

    with _post_outputs() as post:
        cli.process_scan = process_scan
        try:
            done = cli.handle_files(paths, _options(out), CPU)
        finally:
            cli.process_scan = orig
    return {"done": done, "counter": dict(cli.SESSION), "found": found,
            "out": out}


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_each_file_is_within_the_cells_limits(scans, session, i):
    cfg, paths = scans
    name = f"s{i}"
    prog = session["found"][name]
    ref = load_reference(cfg).run(paths[i], shifts=[0],
                                  fit_shift=int(cfg["fit_shift"]))
    png = compare.read_png(str(session["out"] / f"{name}_shift=0_clahe.png"))
    numbers = compare.worst([compare.scan_numbers(prog, ref),
                             compare.image_numbers(png, ref["clahe"], "png")])
    with open(ROOT / "shgbench" / "limits" / "fulldisk16.session.json") as f:
        limits = json.load(f)
    chk = compare.checks(numbers, limits)
    assert compare.passed(chk), chk


def test_the_counter_adds_up(session):
    s = session["counter"]
    assert set(s) == KEYS
    assert session["done"] == 3 and s["scans"] == 3
    assert all(v >= 0 for v in s.values())
    assert s["read_s"] > 0 and s["post_s"] > 0
    # the reading thread waits for no more post than the pool ran, and
    # what it waited for had been queued first
    assert s["post_wait_s"] + s["tail_s"] <= s["post_s"] + s["queue_s"]
    assert s["read_s"] + s["post_wait_s"] + s["tail_s"] <= s["wall_s"]


def test_a_second_call_resets_the_counter(scans, session, tmp_path):
    _, paths = scans
    cli.SESSION.update({k: 1e9 for k in KEYS})
    assert cli.handle_files(paths[:1], _options(tmp_path), CPU) == 1
    s = cli.SESSION
    assert set(s) == KEYS and s["scans"] == 1
    assert all(0 <= v < 1e9 for v in s.values())
    assert s["read_s"] > 0 and s["post_s"] > 0
    # one file: no read follows it, so it is waited for in the tail alone
    assert s["post_wait_s"] < s["tail_s"]


def test_a_file_that_fails_to_read_is_counted_out(scans, tmp_path):
    _, paths = scans
    bad = str(tmp_path / "bad.ser")
    with open(bad, "wb") as f:
        f.write(b"LUCAM-RECORDER" + b"\0" * 100)      # no complete header
    out = tmp_path / "out"
    out.mkdir()
    files = [paths[0], bad, paths[1]]
    assert cli.handle_files(files, _options(out), CPU) == 2
    s = cli.SESSION
    assert s["scans"] == 2
    assert s["read_s"] > 0 and s["post_s"] > 0 and s["wall_s"] > 0
    assert s["post_wait_s"] + s["tail_s"] <= s["post_s"] + s["queue_s"]
    assert sorted(p.name for p in out.glob("*_clahe.png")) == [
        "s0_shift=0_clahe.png", "s1_shift=0_clahe.png"]


def test_session_ranges_open_under_the_profiler(scans, tmp_path):
    """Each step is a range ``stage:session:<step>``; ``post`` opens on the
    pool thread and holds that scan's post stages (recorded where the
    profiler records every thread, as ``--profile`` does)."""
    _, paths = scans
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=every_thread) as prof:
        assert cli.handle_files(paths[:2], _options(tmp_path), CPU) == 2
    events = [e for e in prof.events() if e.name.startswith("stage:")]
    names = {e.name for e in events}
    for step in STEPS:
        assert f"stage:session:{step}" in names, step
    threads = {name: {e.thread for e in events if e.name == name}
               for name in ("stage:session:read", "stage:session:post")}
    assert threads["stage:session:read"].isdisjoint(
        threads["stage:session:post"])
    posts = [e for e in events if e.name == "stage:session:post"]
    fits = [e for e in events if e.name == "stage:ellipse fit"]
    assert len(posts) == len(fits) == 2
    for fit in fits:
        assert any(p.thread == fit.thread
                   and p.time_range.start <= fit.time_range.start
                   and fit.time_range.end <= p.time_range.end
                   for p in posts)


def test_no_session_range_without_a_profiler(scans, tmp_path, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def record_function(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    assert not torch.autograd._profiler_enabled()
    _, paths = scans
    assert cli.handle_files(paths[:2], _options(tmp_path), CPU) == 2
    assert not [n for n in opened if n.startswith("stage:session")]
    assert cli.SESSION["scans"] == 2 and cli.SESSION["post_s"] > 0

