"""Kernel B4 (csrc/warp.cu, ``hresample_kernel``): the least time for its
float32 inputs and output at the product image's size, one image a
requested shift of the mix, a scan, over its device time in the trace."""


def read(run):
    from shgbench import roofline

    if run.product_shape is None:
        return None
    h, w = run.product_shape
    return run.roofline_pct("hresample_kernel", roofline.hresample_bytes(
        h, w, run.model.frames, len(run.cell.mix["options"]["shift"])))
