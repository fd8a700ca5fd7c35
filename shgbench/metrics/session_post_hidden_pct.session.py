"""Share of the post-processing that ran behind the next scan's read: the
pool thread's post time less the reading thread's waits for it, over the
post time, of the last session in the window (the program's counter
``cli.main.SESSION``); None where the program keeps no such counter."""

import sys


def read(run):
    mod = sys.modules.get("solex_ser_recon_en_torch.cli.main")
    s = getattr(mod, "SESSION", None)
    if not s or not s.get("post_s"):
        return None
    return 100.0 * (s["post_s"] - s["post_wait_s"] - s["tail_s"]) / s["post_s"]
