"""paddle_tpu_torch.parallel (port of paddle_tpu/parallel/): the rank
mesh and the sharded train step over torch.distributed (see api.py for
the design), pipeline parallelism (pipeline.py) and ring and Ulysses
attention (ring_attention.py). compat.py, a shard_map shim of the JAX
package, has no torch counterpart: a rank here is a process.
"""
from .mesh import (  # noqa: F401
    build_mesh, set_global_mesh, get_global_mesh, ensure_global_mesh,
    register_ring, ring_axis, TopologyError,
)
from .api import (  # noqa: F401
    ShardedTrainStep, ShardingStage, shard_activation, shard_batch,
    shard_batch_activation, mark_sharding, param_spec,
)
from .ring_attention import ring_attention, ulysses_attention  # noqa: F401
from . import pipeline  # noqa: F401

__all__ = ["build_mesh", "set_global_mesh", "get_global_mesh",
           "ensure_global_mesh", "register_ring", "ring_axis",
           "TopologyError", "ShardedTrainStep", "ShardingStage",
           "shard_activation", "shard_batch", "shard_batch_activation",
           "mark_sharding", "param_spec", "ring_attention",
           "ulysses_attention", "pipeline"]
