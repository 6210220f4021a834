"""Tensor-parallel layers in single-GPU form (port of
paddle_tpu/distributed/tp_layers.py).

The JAX layers mark their weights with a PartitionSpec over the 'tp'
mesh axis and let GSPMD insert the collectives; without a mesh they are
plain layers. The port has no mesh yet (real tensor parallelism over
NCCL is a later slice), so these classes are Linear and Embedding
under the JAX package's names, with one difference the reference has
too: RowParallelLinear adds its bias after the product (where the
tensor-parallel sum would go), so under AMP O1 the bias add runs in
float32 (bf16 product + f32 bias), as in the JAX package. Parameter
names (`qkv.weight`, `lm_head.weight`, ...) come from the attribute
names in the models, not from these classes."""
from __future__ import annotations

from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import Embedding, Linear
from ..nn.layer.layers import Layer

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

    def forward(self, x):
        out = F.linear(x, self.weight, None)
        return out if self.bias is None else out + self.bias


class VocabParallelEmbedding(Embedding):
    """Embedding table [vocab, dim] (sharded on vocab under tp > 1)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None):
        Layer.__init__(self)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = None
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 0.02))
