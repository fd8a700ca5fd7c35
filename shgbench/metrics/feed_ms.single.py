"""Pass A's feed: the program's stage ``mean/max`` (the SER's host copies
into pinned staging, the uploads, the sum/max kernel), a scan's mean over
the window."""


def read(run):
    return run.stage_ms("mean/max")
