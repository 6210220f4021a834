"""Tensor-parallel layers in single-GPU form (port of
paddle_tpu/distributed/tp_layers.py).

The JAX layers mark their weights with a PartitionSpec over the 'tp'
mesh axis and let GSPMD insert the collectives; without a mesh they are
plain layers. The port has no mesh yet (real tensor parallelism over
NCCL is a later slice), so these classes add no behaviour to Linear and
Embedding: they exist only so that models/gpt.py builds its layers under
the same names as the JAX package's call sites. Parameter names
(`qkv.weight`, `lm_head.weight`, ...) come from the attribute names in
the models, not from these classes."""
from __future__ import annotations

from ..nn.layer.common import Embedding, Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class ColumnParallelLinear(Linear):
    """Weight [in, out] (sharded on out columns under tp > 1).
    gather_output only names the output's layout across a mesh; on one
    device both values give the same result, as in the JAX package run
    without a mesh."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, name=None):
        super().__init__(in_features, out_features, weight_attr,
                         None if has_bias else False)
        self.gather_output = gather_output


class RowParallelLinear(Linear):
    """Weight [in, out] (sharded on in rows under tp > 1).
    input_is_parallel only names the input's layout across a mesh; on
    one device both values give the same result."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, name=None):
        super().__init__(in_features, out_features, weight_attr,
                         None if has_bias else False)
        self.input_is_parallel = input_is_parallel


class VocabParallelEmbedding(Embedding):
    """Embedding table [vocab, dim] (sharded on vocab under tp > 1)."""
