"""The card's idle time charged to the feed's ``staging wait`` (the
innermost program range at the gap's middle is
``stage:mean/max:staging wait``), a completed scan's share of it in the
traced window; None without a trace or such a range."""


def read(run):
    if run.trace is None or not run.scans_done:
        return None
    idle = run.trace.idle_by_host.get("mean/max:staging wait")
    if idle is None:
        return None
    return 1e3 * idle / run.scans_done
