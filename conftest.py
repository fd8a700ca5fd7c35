"""A per-test watchdog for the whole test suite.

Each test (its setup, call and teardown) runs under
``faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)``: a test that
hangs for WATCHDOG_S seconds has every thread's stack dumped into the
run's log and its process ended, so the run reaches its end with that test
failed instead of stopping at the command's time limit.  Under
pytest-xdist the ended worker is reported ("node down") and replaced, and
the other workers go on.  No test comes near the limit: the slowest take
tens of seconds.

The dump goes to a duplicate of the process's standard error taken at
configure time, when pytest's output capture is suspended, so it is not
lost in a test's captured output when the process ends.
"""

import faulthandler
import os
import sys

import pytest

#: seconds a single test may take before its process is ended
WATCHDOG_S = 300

_stderr_fd = None


def pytest_configure(config):
    global _stderr_fd
    try:
        fileno = sys.stderr.fileno()
    except (AttributeError, ValueError):
        fileno = -1
    if fileno == -1:    # pytest-xdist replaces sys.stderr with no real file
        fileno = sys.__stderr__.fileno()
    _stderr_fd = os.dup(fileno)


def pytest_unconfigure(config):
    global _stderr_fd
    if _stderr_fd is not None:
        os.close(_stderr_fd)
        _stderr_fd = None


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True, file=_stderr_fd)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
