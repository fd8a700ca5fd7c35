"""solex_ser_recon_en_torch — spectroheliograph (SHG / Sol'Ex) reconstruction
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of ``solex_ser_recon_en_tpu`` (the JAX package,
which stays the reference).  Layout and module names mirror it:

- ``config.py``  ``Options`` and ``output_path``.
- ``io/``        SER reading and writing, the device feed of raw SER chunks
                 (pinned staging buffers and a copy stream), PNG encode and
                 decode, the product-write pool, the synthetic scan.
- ``ops/``       device operations on tensors; ``recon_cuda``, ``warp_fast``,
                 ``clahe`` and ``fused_cuda`` wrap the CUDA kernels of
                 ``csrc/`` and keep their plain PyTorch versions beside them.
- ``geometry/``  spectral-line fit, limb edges, ellipse fit, warp geometry.
- ``models/``    the fused device step (``shg_forward``).
- ``pipeline/``  read_scan -> process_scan -> products (``shg -c`` path).
- ``analyser/``  the spectral analyser: auto-dispersion, GOTO, save.
- ``cli/``       ``python -m solex_ser_recon_en_torch -c file.ser`` (also
                 ``.cli``), the CLAHE tool and the analyser's command line.
- ``bench_device.py``, ``bench_kernels.py``  the device-resident legs and
                 the kernel shoot-out.
- ``interop.py`` turns the JAX package's stage results into this
                 package's stage inputs (parity tests).

The package imports neither jax nor anything of the JAX package: the few
jax-free modules it needs from there (config, SER I/O, the run log, the
timer, the PNG encoder, the write pool, the synthetic scan) are copies of
its own.
"""

__version__ = "0.1.0"
