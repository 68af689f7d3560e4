"""The (dp, sp, tp) mesh over torch.distributed (mesh.py) and tensor
parallelism's collectives (tensor.py)."""

from mvdfusion_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_mean_, barrier, broadcast_, gather_objects, gather_params, init_distributed, is_main,
    local_first, make_mesh, param_layout, param_spec, shard_params_, spawn,
)

__all__ = ["Mesh", "all_reduce_mean_", "barrier", "broadcast_", "gather_objects", "gather_params",
           "init_distributed", "is_main", "local_first", "make_mesh", "param_layout", "param_spec", "shard_params_",
           "spawn"]
