"""paddle.distributed (port of paddle_tpu/distributed/__init__.py): the
collectives over torch.distributed, the parallel environment and
DataParallel, spawn and launch, the tensor-parallel layers, MoE, the
fleet and the elastic supervisor, the parameter server and the
DistributeTranspiler over it.
"""
from .collective import (  # noqa: F401
    ReduceOp, Group, new_group, get_group, all_reduce, all_gather,
    all_gather_object, broadcast, reduce, scatter, alltoall, barrier,
    reduce_scatter, send, recv, wait, get_rank, get_world_size,
    c_allreduce_sum, c_allreduce_max, c_allreduce_min, c_allreduce_prod,
    c_broadcast, c_allgather, c_reducescatter, c_sync_calc_stream,
    c_sync_comm_stream, c_gen_nccl_id, c_comm_init,
)
from .parallel import (  # noqa: F401
    init_parallel_env, ParallelEnv, DataParallel,
)
from .tp_layers import (  # noqa: F401
    split, ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    ParallelCrossEntropy,
)
from .moe import MoEMLP  # noqa: F401
from . import fleet  # noqa: F401
from .spawn import spawn  # noqa: F401
from .launch import launch  # noqa: F401
from . import elastic  # noqa: F401
from .elastic import (  # noqa: F401
    ElasticSupervisor, ElasticJobError, WorkerSpec, elastic_spawn,
)
from . import ps  # noqa: F401
from . import transpiler  # noqa: F401
from .transpiler import (  # noqa: F401
    DistributeTranspiler, DistributeTranspilerConfig,
)


class meta_parallel:
    """The meta_parallel namespace (later Paddle exposes the layers
    there)."""
    from .tp_layers import (ColumnParallelLinear, RowParallelLinear,
                            VocabParallelEmbedding, ParallelCrossEntropy)


__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_object", "broadcast", "reduce",
           "scatter", "alltoall", "barrier", "reduce_scatter", "send",
           "recv", "wait", "get_rank", "get_world_size", "c_allreduce_sum",
           "c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
           "c_broadcast", "c_allgather", "c_reducescatter",
           "c_sync_calc_stream", "c_sync_comm_stream", "c_gen_nccl_id",
           "c_comm_init", "init_parallel_env", "ParallelEnv",
           "DataParallel", "split", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "MoEMLP", "fleet", "spawn", "launch",
           "elastic", "ElasticSupervisor", "ElasticJobError", "WorkerSpec",
           "elastic_spawn", "meta_parallel", "ps", "transpiler",
           "DistributeTranspiler", "DistributeTranspilerConfig"]
