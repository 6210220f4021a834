"""paddle.distributed (port of paddle_tpu/distributed/__init__.py): the
tensor-parallel layers in single-GPU form, `fleet.utils` (recompute)
and the elastic supervisor. The collectives, DataParallel, spawn,
launch, MoE and the fleet singleton wait for the multi-GPU slice
(ROADMAP Queue 1 item 7)."""
from .tp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding)
from . import fleet  # noqa: F401
from . import elastic  # noqa: F401
from .elastic import (  # noqa: F401
    ElasticSupervisor, ElasticJobError, WorkerSpec, elastic_spawn,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "fleet", "elastic",
           "ElasticSupervisor", "ElasticJobError", "WorkerSpec",
           "elastic_spawn"]
