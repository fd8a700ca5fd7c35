"""The line fit: the program's stage ``line fit`` (two box blurs, three
cubic fits on the host), a scan's mean over the window."""


def read(run):
    return run.stage_ms("line fit")
