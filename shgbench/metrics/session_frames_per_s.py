"""Frames of every scan that the window's whole sessions completed, over
the window (host clock)."""


def read(run):
    if not run.sessions or run.window_s <= 0:
        return None
    return run.frames_done / run.window_s
