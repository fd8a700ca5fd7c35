"""Kernel B3 (csrc/recon.cu, ``recon_chunks_kernel``): the least time for
the distinct taps of the true line's columns at the scan's shifts (the fit
shift, 0 and the mix's requested shifts, each once, as ``read_scan``
orders them) and their uint16 disks, a scan, over its device time in the
trace."""


def read(run):
    import numpy as np

    from shgbench import roofline

    m = run.model
    shifts = list(dict.fromkeys([int(run.cell.config["fit_shift"]), 0]
                                + list(run.cell.mix["options"]["shift"])))
    floor = np.floor(m.line_center(np.arange(m.ih, dtype=np.float64)))
    taps = roofline.distinct_taps(floor, shifts, m.iw)
    return run.roofline_pct("recon_chunks_kernel", roofline.recon_bytes(
        m.frames, m.ih, m.sample_bytes, len(shifts), taps))
