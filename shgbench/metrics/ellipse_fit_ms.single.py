"""The ellipse fit: the program's stage ``ellipse fit`` (downscale, flood,
Canny on the card, labelling, hull and least squares on the host), a
scan's mean over the window."""


def read(run):
    return run.stage_ms("ellipse fit")
