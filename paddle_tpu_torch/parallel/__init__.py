"""paddle_tpu_torch.parallel (port of paddle_tpu/parallel/): the rank
mesh and the sharded train step over torch.distributed (see api.py for
the design).

Waiting for slice 9b: pipeline.py (pipeline parallelism) and
ring_attention.py (ring and Ulysses attention). compat.py, a shard_map
shim of the JAX package, has no torch counterpart.
"""
from .mesh import (  # noqa: F401
    build_mesh, set_global_mesh, get_global_mesh, ensure_global_mesh,
    register_ring, ring_axis, TopologyError,
)
from .api import (  # noqa: F401
    ShardedTrainStep, ShardingStage, shard_activation, shard_batch,
    shard_batch_activation, mark_sharding, param_spec,
)

__all__ = ["build_mesh", "set_global_mesh", "get_global_mesh",
           "ensure_global_mesh", "register_ring", "ring_axis",
           "TopologyError", "ShardedTrainStep", "ShardingStage",
           "shard_activation", "shard_batch", "shard_batch_activation",
           "mark_sharding", "param_spec"]
