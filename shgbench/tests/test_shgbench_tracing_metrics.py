"""The readers of the program's sub-spans and feed counter on hand-built
runs: their values, and None where the program records no such key (a
program without the spans) or a run has no trace."""

import json

import pytest

from shgbench.harness import Run, ScanRecord, load_reader
from shgbench.trace import TraceSummary, summarize

#: one scan's stage seconds as the program records them with its spans
STAGES = {
    "open": 0.001, "mean/max": 0.190, "mean/max:staging wait": 0.120,
    "mean/max:upload": 0.004, "mean/max:upload wait": 0.010,
    "mean/max:accumulate": 0.003, "mean/max:close": 0.015,
    "line fit": 0.011, "recon": 0.002, "ellipse fit": 0.038,
    "ellipse fit:downscale": 0.001, "ellipse fit:flood": 0.008,
    "ellipse fit:canny": 0.012, "ellipse fit:edges": 0.009,
    "ellipse fit:fit": 0.006, "warp": 0.001, "products": 0.030,
    "products:write barrier": 0.012,
}
FEED = {"bytes": 2_457_600_000, "fill_s": 0.16, "minflt": 600_123}
#: what a program without the spans records
BARE = {k: v for k, v in STAGES.items() if ":" not in k}

#: metric -> its reading on two scans recorded as ``STAGES`` and ``FEED``
WANT = {
    "feed_staging_wait_ms.single": 120.0,
    "feed_upload_wait_ms.single": 10.0,
    "feed_own_ms.single": 60.0,
    "feed_minflt_k.single": 600.123,
    "canny_ms.single": 12.0,
    "ellipse_host_ms.single": 23.0,
    "write_barrier_ms.single": 12.0,
}


def _run(stages, feed, trace=None, failed=0):
    scans = [ScanRecord(0.3, True, dict(stages), dict(feed))
             for _ in range(2)]
    scans += [ScanRecord(0.1, False, {}, {}) for _ in range(failed)]
    return Run(cell=None, model=None, setup_s=1.0, window_s=20.0,
               scans=scans, trace=trace)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value(name):
    read = load_reader(name)
    assert read(_run(STAGES, FEED, failed=1)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_without_the_programs_key(name):
    read = load_reader(name)
    bare_feed = {k: v for k, v in FEED.items() if k != "minflt"}
    assert read(_run(BARE, bare_feed)) is None
    assert read(_run({}, {}, failed=2)) is None


def test_feed_own_without_uploads():
    """A feed with no upload wait (the CPU's) takes it as none."""
    stages = {k: v for k, v in STAGES.items() if k != "mean/max:upload wait"}
    got = load_reader("feed_own_ms.single")(_run(stages, FEED))
    assert got == pytest.approx(70.0)


def test_idle_under_the_staging_wait():
    read = load_reader("feed_idle_staging_ms.single")
    trace = TraceSummary(window_s=20.0, busy_s=4.0, idle_by_host={
        "mean/max:staging wait": 0.2, "mean/max": 0.01})
    assert read(_run(STAGES, FEED, trace)) == pytest.approx(100.0)
    assert read(_run(STAGES, FEED)) is None                 # no trace
    bare = TraceSummary(window_s=20.0, busy_s=4.0,
                        idle_by_host={"mean/max": 0.2})
    assert read(_run(BARE, FEED, bare)) is None


def test_trace_charges_a_gap_to_the_innermost_sub_span(tmp_path):
    """The harness's stage range, the program's own and its sub-span, all
    nested: a gap inside the sub-span goes to ``<stage>:<name>``."""
    def ev(name, cat, ts, dur):
        return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X"}

    events = [
        ev("shgbench.window", "user_annotation", 0.0, 1000.0),
        ev("stage:mean/max", "user_annotation", 0.0, 1000.0),
        ev("stage:mean/max", "user_annotation", 1.0, 998.0),
        ev("stage:mean/max:staging wait", "user_annotation", 100.0, 300.0),
        ev("Memcpy HtoD", "gpu_memcpy", 0.0, 100.0),
        ev("Memcpy HtoD", "gpu_memcpy", 400.0, 500.0),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    s = summarize(str(p))
    assert s.idle_by_host == {"mean/max:staging wait": pytest.approx(300e-6),
                              "mean/max": pytest.approx(100e-6)}
