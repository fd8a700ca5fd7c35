"""The device step of SHG reconstruction (counterpart of
solex_ser_recon_en_tpu/models): ``shg_forward`` and ``example_inputs``,
the pair that ``__graft_entry__.entry()`` returns for the JAX package."""

from .shg import example_inputs, shg_forward

__all__ = ["shg_forward", "example_inputs"]
