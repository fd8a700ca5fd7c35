"""The ellipse fit's Canny (the device or host Canny and its readback):
the program's sub-span ``canny`` of stage ``ellipse fit``
(geometry/edges.py), a scan's mean over the window; None where the
program records no such span."""


def read(run):
    key = "ellipse fit:canny"
    if not any(key in r.stages for r in run.scans if r.ok):
        return None
    return run.stage_ms(key)
