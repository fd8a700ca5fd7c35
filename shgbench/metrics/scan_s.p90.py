"""90th percentile of the latency of the window's completed scans, as
scan_latency_s.p50 takes it (host clock)."""


def read(run):
    lat = [r.latency_s for r in run.scans if r.ok]
    if not lat:
        return None
    from shgbench.harness import percentile

    return percentile(lat, 90)
