"""The reading thread's wait for the post-processing a scan: the waits
between reads and after the last read over the scans done, of the last
session in the window (the program's counter ``cli.main.SESSION``); None
where the program keeps no such counter."""

import sys


def read(run):
    mod = sys.modules.get("solex_ser_recon_en_torch.cli.main")
    s = getattr(mod, "SESSION", None)
    if not s or not s.get("scans"):
        return None
    return 1e3 * (s["post_wait_s"] + s["tail_s"]) / s["scans"]
