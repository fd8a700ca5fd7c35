"""The trace reduction on a hand-made Chrome trace."""

import json

import pytest

from shgbench.trace import compute_seconds, summarize


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X"}


def test_busy_idle_kernels_and_gaps(tmp_path):
    events = [
        _ev("shgbench.window", "user_annotation", 100.0, 1000.0),
        _ev("stage:mean/max", "user_annotation", 100.0, 500.0),
        _ev("stage:ellipse fit", "user_annotation", 600.0, 400.0),
        _ev("aten::copy_", "cpu_op", 650.0, 10.0),
        _ev("sum_max_kernel<true, 2>", "kernel", 150.0, 100.0),
        _ev("sum_max_kernel<true, 2>", "kernel", 200.0, 100.0),   # overlaps
        _ev("Memcpy HtoD", "gpu_memcpy", 400.0, 100.0),
        _ev("hist_kernel<u16>", "kernel", 900.0, 50.0),
        _ev("outside", "kernel", 5000.0, 10.0),                   # not in it
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    s = summarize(str(p))
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(300e-6)      # 150-300, 400-500, 900-950
    assert s.compute_s == pytest.approx(200e-6)   # the copy left out
    assert compute_seconds(str(p)) == pytest.approx(200e-6)
    assert s.kernel_time("sum_max_kernel") == (pytest.approx(200e-6), 2)
    assert "outside" not in s.kernel_s
    # gaps 100-150 and 300-400 (mean/max), 500-900 (its middle in ellipse
    # fit), 950-1100 (its middle past every range)
    assert s.idle_by_host["mean/max"] == pytest.approx(150e-6)
    assert s.idle_by_host["ellipse fit"] == pytest.approx(400e-6)
    assert s.idle_by_host["untraced host work"] == pytest.approx(150e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0].startswith("sum_max_kernel")
    assert len(b["idle_gaps"]) <= 10


def test_no_window_or_no_device_activity_raises(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [_ev("x", "kernel", 0, 1)]}))
    with pytest.raises(RuntimeError):
        summarize(str(p))
    p.write_text(json.dumps({"traceEvents": [
        _ev("shgbench.window", "user_annotation", 0, 10)]}))
    with pytest.raises(RuntimeError):
        summarize(str(p))


def test_compute_seconds_of_a_card_only_trace(tmp_path):
    """A trace of the card alone holds no window range: every kernel and
    memset counts once, overlaps merged, copies left out."""
    events = [
        _ev("recon_chunks_kernel", "kernel", 0.0, 40.0),
        _ev("hist_kernel<u16>", "kernel", 30.0, 20.0),       # overlaps
        _ev("Memset (Device)", "gpu_memset", 100.0, 5.0),
        _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 200.0, 900.0),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    assert compute_seconds(str(p)) == pytest.approx(55e-6)
    p.write_text(json.dumps({"traceEvents": events[3:]}))
    with pytest.raises(RuntimeError):
        compute_seconds(str(p))
