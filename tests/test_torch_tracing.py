"""The port's stages and sub-spans (utils/timer.py): keys, the profiler
ranges they open only while a profiler records, the summary, and the
spans of the feed and the ellipse fit (CPU)."""

import json
import time

import numpy as np
import pytest
import torch

from solex_ser_recon_en_torch import interop
from solex_ser_recon_en_torch.geometry.correct import ellipse_to_circle
from solex_ser_recon_en_torch.geometry.edges import HOST_CANNY_MAX_PX
from solex_ser_recon_en_torch.io import feeder
from solex_ser_recon_en_torch.io.ser import SerReader, write_ser
from solex_ser_recon_en_torch.utils import timer as timer_mod
from solex_ser_recon_en_torch.utils.timer import StageTimer, span

from torch_parity import limb_darkened_disk

CPU = torch.device("cpu")


@pytest.fixture
def ranges(monkeypatch):
    """The names of the profiler ranges the timer opens."""
    opened = []
    real = torch.profiler.record_function

    def record_function(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return opened


def test_span_with_no_stage_reads_no_clock_and_opens_no_range(
        monkeypatch, ranges):
    reads = []
    real = time.perf_counter

    def perf_counter():
        reads.append(1)
        return real()

    monkeypatch.setattr(timer_mod.time, "perf_counter", perf_counter)
    with span("staging wait") as s:
        pass
    monkeypatch.setattr(timer_mod.time, "perf_counter", real)
    assert not reads and not ranges and s.seconds == 0.0
    with span("staging wait", timed=True) as s:     # a caller's counter
        time.sleep(0.001)
    assert s.seconds > 0 and not ranges


def test_spans_in_a_stage_without_a_profiler(ranges):
    assert not torch.autograd._profiler_enabled()
    timer = StageTimer()
    with timer.stage("mean/max"):
        for _ in range(2):
            with span("staging wait") as s:
                time.sleep(0.001)
            with span("upload"):
                pass
    with timer.stage("products"), span("write barrier"):
        pass
    assert not ranges
    assert set(timer.times) == {"mean/max", "mean/max:staging wait",
                                "mean/max:upload", "products",
                                "products:write barrier"}
    assert 0 < s.seconds <= timer.times["mean/max:staging wait"]
    assert (timer.times["mean/max:staging wait"]
            + timer.times["mean/max:upload"] <= timer.times["mean/max"])
    assert timer.times["products:write barrier"] <= timer.times["products"]


def test_span_takes_the_innermost_open_stage_of_its_own_thread():
    import threading

    outer, inner = StageTimer(), StageTimer()
    seen = []
    with outer.stage("recon"):
        with inner.stage("mean/max"), span("upload"):
            pass
        with span("upload"):
            pass

        def elsewhere():            # a pool thread: no open stage there
            with span("upload") as s:
                seen.append(s.seconds)

        t = threading.Thread(target=elsewhere)
        t.start()
        t.join(10)
    assert not t.is_alive() and seen == [0.0]
    assert "mean/max:upload" in inner.times and "recon:upload" in outer.times
    assert "recon:upload" not in inner.times
    with span("upload"):
        pass
    assert set(outer.times) == {"recon", "recon:upload"}


def test_ranges_on_the_profilers_clock(tmp_path, ranges):
    timer = StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.stage("mean/max"):
            with span("staging wait"):
                time.sleep(0.002)
    assert ranges == ["stage:mean/max", "stage:mean/max:staging wait"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation"
           and e["name"].startswith("stage:")}
    outer, inner = got["stage:mean/max"], got["stage:mean/max:staging wait"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["dur"] >= 2000 * 0.9          # microseconds


def test_summary_totals_the_stages_alone():
    timer = StageTimer()
    timer.times.update({"open": 0.010, "mean/max": 0.200,
                        "mean/max:staging wait": 0.150,
                        "mean/max:upload wait": 0.020, "products": 0.030})
    timer.span_stage.update({"mean/max:staging wait": "mean/max",
                             "mean/max:upload wait": "mean/max"})
    lines = timer.summary().splitlines()
    assert lines == ["  open: 10.0 ms",
                     "  mean/max: 200.0 ms (own 30.0 ms)",
                     "    staging wait: 150.0 ms",
                     "    upload wait: 20.0 ms",
                     "  products: 30.0 ms",
                     "  total: 240.0 ms"]


@pytest.mark.parametrize("threads", [1, 3])
def test_feed_spans_share_the_feeds_clock_pairs(tmp_path, threads):
    frames = np.random.default_rng(5).integers(
        0, 65536, (30, 12, 18)).astype(np.uint16)
    path = str(tmp_path / "s.ser")
    write_ser(path, frames)
    timer = StageTimer()
    with timer.stage("mean/max"):
        it, _, _ = feeder.raw_device_chunks(SerReader(path), 7, CPU,
                                            threads=threads)
        got = [c for _, c, _ in it]
    np.testing.assert_array_equal(torch.cat(got).numpy(), frames)
    feed = feeder.FEED
    assert feed["chunks"] == 5
    # one clock pair each: the counter and the span read the same seconds
    assert feed["consumer_wait_s"] == timer.times["mean/max:staging wait"]
    assert {"mean/max:upload", "mean/max:close"} <= set(timer.times)
    assert "mean/max:upload wait" not in timer.times      # CUDA only
    assert isinstance(feed["minflt"], int) and feed["minflt"] >= 0
    assert feed["close_s"] <= timer.times["mean/max:close"]


@pytest.mark.parametrize("side", [1040, 400], ids=["device_canny",
                                                   "host_canny"])
def test_ellipse_fit_records_its_steps(side):
    small_px = (side // 4) ** 2
    assert (small_px > HOST_CANNY_MAX_PX) == (side == 1040)
    disk = interop.tensor(limb_darkened_disk(side, side, 3))
    timer = StageTimer()
    with timer.stage("ellipse fit"):
        geo = ellipse_to_circle(disk, need_image=False)
    assert 1.0 < geo.ratio < 1.2
    steps = {k.split(":", 1)[1] for k in timer.times if ":" in k}
    assert steps == {"downscale", "flood", "canny", "edges", "fit"}
    assert sum(timer.times[f"ellipse fit:{s}"] for s in steps) <= \
        timer.times["ellipse fit"]
