"""Per-stage wall-time accounting (the reference's only profiling hook is a
dead cProfile branch, SHG_MAIN.py:225-228; we do better).

The port's own copy of solex_ser_recon_en_tpu/utils/timer.py, with notes:
``note(key, value)`` records what a run decided (pipeline/run.py: the feed
taken, which pass A and pass B ran), printed before the stages.

Sub-spans: ``stage(name)`` makes its timer the current one of the calling
thread (a context variable), and ``span(name)`` anywhere below it adds
its seconds to ``times["<stage>:<name>"]`` of that timer, for the
innermost open stage.  The feed's waits, the ellipse fit's steps and the
write barrier are such spans (io/feeder.py, geometry/, pipeline/run.py).
A thread with no open stage (the feed's copy threads, the writer pool)
reads no clock in ``span`` and records nothing.

While a torch profiler records, every stage and span is also a profiler
range named ``stage:<stage>`` or ``stage:<stage>:<name>``, on the trace's
clock beside the device's activity; with no profiler recording, a stage
or span costs one flag check and opens no range.  The flag is the
process's, so a thread other than the profiler's (the session's post
pool, cli/main.py) opens its ranges too; torch keeps them where the
profiler records every thread (``profile_all_threads``, as ``--profile``
does) and drops them otherwise.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, Optional, Tuple

import torch

#: prefix of the profiler range of a stage or a sub-span
RANGE = "stage:"

#: the calling thread's innermost open stage: (timer, stage name)
_CURRENT: ContextVar[Optional[Tuple["StageTimer", str]]] = ContextVar(
    "solex_torch_stage", default=None)


def _open_range(key: str):
    """The entered profiler range ``RANGE + key`` while a profiler records,
    else None."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    rng = torch.profiler.record_function(RANGE + key)
    rng.__enter__()
    return rng


class StageTimer:
    def __init__(self):
        self.times: Dict[str, float] = {}
        self.notes: Dict[str, str] = {}
        #: each sub-span's key in ``times`` -> its stage
        self.span_stage: Dict[str, str] = {}

    @contextmanager
    def stage(self, name: str):
        token = _CURRENT.set((self, name))
        rng = _open_range(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0
            if rng is not None:
                rng.__exit__(None, None, None)
            _CURRENT.reset(token)

    def note(self, key: str, value: str) -> None:
        self.notes[key] = value

    def summary(self) -> str:
        """Notes, then each stage with its sub-spans indented under it and,
        where it has some, its own time (the stage less its sub-spans);
        ``total`` sums the stages alone."""
        stages = [k for k in self.times if k not in self.span_stage]
        lines = [f"  {k}: {v}" for k, v in self.notes.items()]
        for k in stages:
            subs = [s for s, st in self.span_stage.items() if st == k]
            line = f"  {k}: {self.times[k]*1000:.1f} ms"
            if subs:
                own = self.times[k] - sum(self.times[s] for s in subs)
                line += f" (own {own*1000:.1f} ms)"
            lines.append(line)
            lines += [f"    {s[len(k) + 1:]}: {self.times[s]*1000:.1f} ms"
                      for s in subs]
        total = sum(self.times[k] for k in stages)
        lines.append(f"  total: {total*1000:.1f} ms")
        return "\n".join(lines)


class span:
    """Sub-span ``name`` of the calling thread's innermost open stage (see
    the module's docstring).  ``seconds`` holds what it measured once it
    has exited; ``timed=True`` measures it even with no open stage, for a
    caller that keeps the seconds in a counter of its own."""

    __slots__ = ("name", "timed", "seconds", "_cur", "_rng", "_t0")

    def __init__(self, name: str, timed: bool = False):
        self.name = name
        self.timed = timed
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._cur = cur = _CURRENT.get()
        self._rng = None
        if cur is not None:
            self._rng = _open_range(f"{cur[1]}:{self.name}")
        if cur is not None or self.timed:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        cur = self._cur
        if cur is None and not self.timed:
            return False
        self.seconds = time.perf_counter() - self._t0
        if cur is not None:
            timer, stage = cur
            key = f"{stage}:{self.name}"
            timer.times[key] = timer.times.get(key, 0.0) + self.seconds
            timer.span_stage[key] = stage
            if self._rng is not None:
                self._rng.__exit__(None, None, None)
        return False
