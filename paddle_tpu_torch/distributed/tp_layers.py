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
    """Weight [in, out] (sharded on out columns under tp > 1)."""

    def __init__(self, in_features, out_features, has_bias=True):
        super().__init__(in_features, out_features, bias=has_bias)


class RowParallelLinear(Linear):
    """Weight [in, out] (sharded on in rows under tp > 1)."""

    def __init__(self, in_features, out_features, has_bias=True):
        super().__init__(in_features, out_features, bias=has_bias)


class VocabParallelEmbedding(Embedding):
    """Embedding table [vocab, dim] (sharded on vocab under tp > 1)."""
