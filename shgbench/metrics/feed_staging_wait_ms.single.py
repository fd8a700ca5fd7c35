"""The feed consumer's waits for a filled pinned staging buffer: the
program's sub-span ``staging wait`` of stage ``mean/max``
(io/feeder.py), a scan's mean over the window; None where the program
records no such span."""


def read(run):
    key = "mean/max:staging wait"
    if not any(key in r.stages for r in run.scans if r.ok):
        return None
    return run.stage_ms(key)
