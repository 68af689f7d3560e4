"""Data parallelism over torch.distributed (mesh.py)."""

from mvdfusion_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_mean_, barrier, broadcast_, gather_objects, init_distributed, is_main, local_first, make_mesh,
    spawn,
)

__all__ = ["Mesh", "all_reduce_mean_", "barrier", "broadcast_", "gather_objects", "init_distributed", "is_main",
           "local_first", "make_mesh", "spawn"]
