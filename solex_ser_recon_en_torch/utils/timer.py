"""Per-stage wall-time accounting (the reference's only profiling hook is a
dead cProfile branch, SHG_MAIN.py:225-228; we do better).

The port's own copy of solex_ser_recon_en_tpu/utils/timer.py."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class StageTimer:
    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.times.values())
        lines = [f"  {k}: {v*1000:.1f} ms" for k, v in self.times.items()]
        lines.append(f"  total: {total*1000:.1f} ms")
        return "\n".join(lines)
