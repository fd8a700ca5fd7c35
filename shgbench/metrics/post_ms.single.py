"""Post-processing: the program's stages ``ellipse fit``, ``warp`` and
``products`` (transversalium, CLAHE, stretch, the PNG's encode and write),
a scan's mean over the window."""


def read(run):
    return run.stage_ms("ellipse fit", "warp", "products")
