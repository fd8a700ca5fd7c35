"""solex_ser_recon_en_torch — spectroheliograph (SHG / Sol'Ex) reconstruction
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of ``solex_ser_recon_en_tpu`` (the JAX package,
which stays the reference).  Layout and module names mirror it:

- ``io/``        the device feed of raw SER chunks (pinned staging buffers
                 and a copy stream).
- ``ops/``       device operations on tensors; ``recon_cuda``, ``warp_fast``
                 and ``clahe`` wrap the CUDA kernels of ``csrc/`` and keep
                 their plain PyTorch versions beside them.
- ``geometry/``  spectral-line fit, limb edges, ellipse fit, warp geometry.
- ``pipeline/``  read_scan -> process_scan -> products (``shg -c`` path).
- ``cli/``       ``python -m solex_ser_recon_en_torch.cli -c file.ser``.
- ``interop.py`` turns the JAX package's stage results into this
                 package's stage inputs (parity tests).

The package never imports jax.  It reuses a few jax-free leaf modules of
the JAX package (config, SER/FITS I/O, the run log, the timer); importing
those runs the JAX package's ``__init__``, whose compile-cache setup
loads jax unless ``SOLEX_NO_COMPILE_CACHE=1``; this module sets that
variable before any such import.
"""

import os as _os

_os.environ.setdefault("SOLEX_NO_COMPILE_CACHE", "1")

__version__ = "0.1.0"

from solex_ser_recon_en_tpu.config import Options  # noqa: E402,F401
