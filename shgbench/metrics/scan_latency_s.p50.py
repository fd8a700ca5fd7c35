"""Median latency of the traced window's completed scans: from the
read_scan call to the return of process_scan, whose write barrier has
joined the _clahe.png (host clock; the profiler's cost included)."""


def read(run):
    lat = [r.latency_s for r in run.scans if r.ok]
    if not lat:
        return None
    from shgbench.harness import percentile

    return percentile(lat, 50)
