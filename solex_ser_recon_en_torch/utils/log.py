"""Per-run text log.

The port's own copy of solex_ser_recon_en_tpu/utils/log.py.

reference: solex_util.py:29-54 (clearlog / logme / write_complete) — a
``<base>_log.txt`` next to the outputs recording start/end time and the
scientifically meaningful diagnostics (shifts, dims, y-limits, polynomial
fit, Y/X ratio, tilt, correction matrix, disk position/radius, settings).
"""

from __future__ import annotations

import datetime
import traceback

from ..config import Options, output_path


class RunLog:
    """Appends the same lines the reference writes, but through ONE
    line-buffered handle per instance instead of an open/close cycle per
    line (O_APPEND keeps interleaving with a concurrent instance safe, and
    line buffering keeps the on-disk file current after every entry)."""

    def __init__(self, base: str, options: Options):
        self.path = output_path(base + "_log.txt", options)
        self.enabled = not options._nolog
        self._f = None

    def _handle(self, mode: str = "a"):
        if self._f is None or self._f.closed:
            self._f = open(self.path, mode, buffering=1)
        return self._f

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            try:
                self._f.close()
            except Exception:
                pass
        self._f = None

    __del__ = close

    def clear(self) -> None:
        if not self.enabled:
            return
        try:
            self.close()
            # Truncate with a short-lived 'w' handle, then reopen in 'a':
            # every handle this instance retains is O_APPEND, so lines from
            # a concurrent RunLog on the same path interleave instead of
            # being overwritten at a stale 'w'-mode offset.
            with open(self.path, "w") as f:
                f.write("start time: " + str(datetime.datetime.now()) + "\n")
            self._handle("a")
        except Exception:
            traceback.print_exc()
            print("ERROR: failed to log file: " + self.path)

    def __call__(self, s: str) -> None:
        if not self.enabled:
            return
        try:
            self._handle().write(s + "\n")
        except Exception:
            traceback.print_exc()
            print("ERROR: failed to log file: " + self.path)

    def complete(self) -> None:
        self("end time: " + str(datetime.datetime.now()))
        self.close()
