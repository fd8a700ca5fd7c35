"""The feed consumer's waits for a chunk's upload to finish before its
staging buffer goes back to the producer: the program's sub-span
``upload wait`` of stage ``mean/max`` (io/feeder.py), a scan's mean over
the window; None where the program records no such span."""


def read(run):
    key = "mean/max:upload wait"
    if not any(key in r.stages for r in run.scans if r.ok):
        return None
    return run.stage_ms(key)
