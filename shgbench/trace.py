"""Reduction of a torch.profiler trace of the measured window.

The harness wraps the window in a ``shgbench.window`` range and each
program stage of the ``single`` mixes in a ``stage:<name>`` range
(harness.TracingTimer).  From the Chrome trace this computes the device's
busy time (the union of the kernel, copy and memset intervals inside the
window), the device time and launches of every kernel by name, and the
device's idle gaps, each charged to what the host was doing at its
middle: the innermost ``stage:`` range, else the innermost traced CPU
operation, else untraced host work.  ``compute_seconds`` reads the
device's compute time alone (kernels and memsets, no copies) from a trace
of the card's activity only, the one every run on the card records.
"""

from __future__ import annotations

import collections
import heapq
import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: what the card computes: its kernels and memsets, not the copies the
#: host paces
COMPUTE_CATS = ("kernel", "gpu_memset")
WINDOW = "shgbench.window"
STAGE = "stage:"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    compute_s: float = 0.0
    kernel_s: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def kernel_time(self, needle: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``needle``."""
        hits = [k for k in self.kernel_s if needle in k]
        return (sum(self.kernel_s[k] for k in hits),
                sum(self.launches[k] for k in hits))

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _length(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def _innermost(spans: List[Tuple[float, float, str]], points: List[float]
               ) -> List[str]:
    """For each sorted point, the name of the shortest span covering it
    (or '')."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    live: list = []           # (length, end, name)
    out, j = [], 0
    for p in points:
        while j < len(spans) and starts[j] <= p:
            s, e, name = spans[j]
            heapq.heappush(live, (e - s, e, name))
            j += 1
        # drop spans that ended: rebuild lazily from the heap's top
        keep = [x for x in live if x[1] >= p]
        if len(keep) != len(live):
            live = keep
            heapq.heapify(live)
        out.append(live[0][2] if live else "")
    return out


def summarize(trace_path: str) -> TraceSummary:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no shgbench.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, comp, stages, ops = [], [], [], []
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    launches: Dict[str, int] = collections.defaultdict(int)
    for e in events:
        if "dur" not in e or "ts" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if t < w0 or s > w1:
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((max(s, w0), min(t, w1)))
            if cat in COMPUTE_CATS:
                comp.append(dev[-1])
            kernel_s[e["name"]] += (min(t, w1) - max(s, w0)) / 1e6
            launches[e["name"]] += 1
        elif cat == "user_annotation" and e["name"].startswith(STAGE):
            stages.append((s, t, e["name"][len(STAGE):]))
        elif cat == "cpu_op":
            ops.append((s, t, e["name"]))
    if not dev:
        raise RuntimeError("the profiler recorded no device activity in the "
                           "window")
    busy = _union(dev)
    busy_us = _length(busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    mids = [(s + e) / 2 for s, e in gaps]
    by_stage = _innermost(stages, mids)
    by_op = _innermost(ops, mids)
    idle: Dict[str, float] = collections.defaultdict(float)
    for (s, e), st, op in zip(gaps, by_stage, by_op):
        idle[st or op or "untraced host work"] += (e - s) / 1e6
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                        compute_s=_length(_union(comp)) / 1e6,
                        kernel_s=dict(kernel_s), launches=dict(launches),
                        idle_by_host=dict(idle))



def compute_seconds(trace_path: str) -> float:
    """The union of the kernel and memset intervals of a trace recorded
    around the window alone, in seconds (clipped to the ``shgbench.window``
    range where the trace holds one)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    w0, w1 = float("-inf"), float("inf")
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    comp = []
    for e in events:
        if e.get("cat") in COMPUTE_CATS and "dur" in e and "ts" in e:
            s = float(e["ts"])
            t = s + float(e["dur"])
            if t >= w0 and s <= w1:
                comp.append((max(s, w0), min(t, w1)))
    if not comp:
        raise RuntimeError("the profiler recorded no kernel in the window")
    return _length(_union(comp)) / 1e6
