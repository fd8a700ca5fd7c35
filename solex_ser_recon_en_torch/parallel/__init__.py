"""Device meshes (parallel/mesh.py) and multi-process scale-out
(parallel/distributed.py)."""

from .mesh import make_mesh, shard_scan_recon, device_pipeline_step  # noqa: F401
