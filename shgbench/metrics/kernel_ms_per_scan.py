"""The card's compute time per scan: the union of the kernel and memset
intervals in the window's device trace (no copies, which the host paces)
over the scans completed in it."""


def read(run):
    n = run.scans_done
    if run.compute_s is None or not n or run.compute_s <= 0:
        return None
    return 1e3 * run.compute_s / n
