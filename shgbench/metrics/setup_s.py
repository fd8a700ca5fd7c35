"""Process start to the first timed call: torch and CUDA, loading the
built kernels, rendering the scan, the warm-up of the cell's shapes and
the link probe (host clock)."""


def read(run):
    return run.setup_s
