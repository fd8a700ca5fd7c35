"""Pass A's kernel (csrc/sum_max.cu, ``sum_max_kernel``): the least time
for the bytes of the window's scans (every raw sample read once, the
int32 sum and maximum written once a scan) over the kernel's device time
in the trace, against the card's published bandwidth."""


def read(run):
    m = run.model
    from shgbench import roofline

    return run.roofline_pct("sum_max_kernel", roofline.sum_max_bytes(
        m.frames, m.ih, m.iw, m.sample_bytes))
