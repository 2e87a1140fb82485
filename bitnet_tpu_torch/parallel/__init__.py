"""The parallel modes over ``torch.distributed``: meshes of ranks, each
rank's shard, and the pipeline, sequence and ring modes (the counterpart of
``bitnet_tpu/parallel/``).  One process a rank; see ``mesh.py``."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, single_device_mesh
from .multihost import host_mesh, init_distributed
from .sharding import (allocate_sharded_cache, allocate_sharded_paged_cache,
                       shard_params, validate_mesh_for)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "single_device_mesh",
    "host_mesh",
    "init_distributed",
    "allocate_sharded_cache",
    "allocate_sharded_paged_cache",
    "shard_params",
    "validate_mesh_for",
]
