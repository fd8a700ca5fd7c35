"""The process's minor page faults during the feed, in thousands
(``io.feeder.FEED["minflt"]`` after each read_scan), a scan's mean over
the window; None where the program keeps no such counter."""


def read(run):
    feeds = [f for f in run.feeds() if "minflt" in f]
    if not feeds:
        return None
    return sum(f["minflt"] for f in feeds) / len(feeds) / 1e3
