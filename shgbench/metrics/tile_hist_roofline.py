"""Kernel B5 (csrc/hist.cu, ``hist_kernel``): the least time for each
product image of the scan (one a requested shift of the mix) read twice
and 5 x 65536 int32 bins, a scan, over its device time in the trace."""


def read(run):
    from shgbench import roofline

    if run.product_shape is None:
        return None
    h, w = run.product_shape
    return run.roofline_pct("hist_kernel", len(run.cell.mix["options"][
        "shift"]) * roofline.tile_hist_bytes(h, w))
