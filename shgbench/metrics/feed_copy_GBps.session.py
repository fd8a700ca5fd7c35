"""The feed's host copy rate: bytes the producer filled into pinned staging
over its fill time (io.feeder.FEED, read by handle_files' meter after
each file's read), over the window's sessions."""


def read(run):
    feeds = [f for f in run.feeds() if f.get("fill_s")]
    if not feeds:
        return None
    return sum(f["bytes"] for f in feeds) / sum(f["fill_s"] for f in feeds) / 1e9
