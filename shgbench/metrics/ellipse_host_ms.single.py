"""The ellipse fit's host steps: the program's sub-spans ``flood`` (the
blurs' readbacks, the percentile, the histogram and its cubic),
``edges`` (labelling, region sizes, convex hull, crop) and ``fit`` (the
least squares and the correction's geometry) of stage ``ellipse fit``
(geometry/edges.py, geometry/correct.py), a scan's mean over the window;
None where the program records none of them."""

KEYS = ("ellipse fit:flood", "ellipse fit:edges", "ellipse fit:fit")


def read(run):
    if not any(k in r.stages for r in run.scans if r.ok for k in KEYS):
        return None
    return run.stage_ms(*KEYS)
