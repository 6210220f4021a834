"""Tensor-parallel layers over the mesh's tp group (port of
paddle_tpu/distributed/tp_layers.py; reference: collective.py:566-750,
paddle.distributed.split and the Megatron layers).

The JAX layers hold whole weights marked with a PartitionSpec over 'tp'
and let GSPMD insert the collectives. Here each rank holds its slice,
and the layers call the collectives themselves through four autograd
Functions over the tp group (identity forward / all-reduce backward and
its mirror, all-gather / slice and its mirror):

- ColumnParallelLinear: weight [in, out/tp] (its out columns), bias
  [out/tp]; gather_output all-gathers the output's last dim. With
  `_tp_groups` g > 1 the out dim is g blocks each split over tp (the
  GPT's fused qkv: each rank holds its heads of q, of k and of v);
- RowParallelLinear: weight [in/tp, out]; an input that is not already
  parallel is sliced; the partial products are all-reduced and the bias
  is added after the sum (so under AMP O1 the add runs in f32, as in
  the JAX package);
- VocabParallelEmbedding: table [vocab/tp, dim], a lookup of the ids in
  this rank's range (the others give zero rows) and an all-reduce;
- ParallelCrossEntropy: softmax cross-entropy over vocab-sliced logits,
  with all-reduces of the row max, of the sum of exponentials and of
  the target's logit; its backward is softmax - one-hot on the slice.

Every weight is drawn whole by its initializer and then sliced, so a
tp run starts from the weights of the tp == 1 model of the same seed;
at tp 1 (no mesh, or a mesh with tp 1) the layers are plain Linear and
Embedding. The mesh must be set before the layers are built
(parallel.set_global_mesh or fleet.init). load_jax_state takes a whole
JAX array and keeps this rank's slice; nn.layer.layers.gather_jax_state
gathers the whole state dict back under the JAX names.
"""
from __future__ import annotations

import torch

from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.layers import Layer
from ..parallel import api as _api
from ..parallel import mesh as _mesh

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "split"]


# ------------------------------------------------------------ the group
def tp_degree() -> int:
    """The global mesh's tp size (1 without a mesh)."""
    m = _mesh.get_global_mesh()
    return 1 if m is None else m.shape["tp"]


def _tp(built_for=None):
    """(process group, size, this rank's index) of the tp axis; a layer
    built for another tp degree than the mesh's raises."""
    n = tp_degree()
    if built_for is not None and n != built_for:
        raise RuntimeError(f"a layer built for tp={built_for} runs under a "
                           f"mesh with tp={n}")
    if n == 1:
        return None, 1, 0
    m = _mesh.get_global_mesh()
    return m.group("tp"), n, m.coord("tp")


def _counted_all_reduce(t, pg):
    from . import collective as C
    return C._all_reduce(t, C.ReduceOp.SUM, pg)


def _gather_last(x, pg, n):
    """Every rank's x concatenated on the last dim, in rank order."""
    from . import collective as C
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    C._all_gather(out, x, pg)
    return out.movedim(0, -2).reshape(x.shape[:-1] + (n * x.shape[-1],))


def _slice_last(x, n, r):
    w = x.shape[-1] // n
    return x[..., r * w:(r + 1) * w].contiguous()


class _CopyToTP(torch.autograd.Function):
    """x forward; the gradient summed over the tp group backward."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _counted_all_reduce(g.contiguous().clone(), ctx.pg), None


class _ReduceFromTP(torch.autograd.Function):
    """The sum over the tp group forward; the gradient as is backward."""

    @staticmethod
    def forward(ctx, x, pg):
        return _counted_all_reduce(x.contiguous().clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The last dim all-gathered forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, pg, n, r):
        ctx.n, ctx.r = n, r
        return _gather_last(x.contiguous(), pg, n)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.n, ctx.r), None, None, None


class _ScatterToTP(torch.autograd.Function):
    """This rank's slice of the last dim forward; all-gathered backward."""

    @staticmethod
    def forward(ctx, x, pg, n, r):
        ctx.pg, ctx.n = pg, n
        return _slice_last(x, n, r)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g.contiguous(), ctx.pg, ctx.n), None, None, None


def copy_to_tp(x, built_for=None):
    """x, with its gradient summed over the tp group in backward: the
    input side of a column-parallel product that bypasses
    ColumnParallelLinear.forward (the GPT's sliced q/k/v)."""
    pg, n, _ = _tp(built_for)
    return _CopyToTP.apply(x, pg) if n > 1 else x


# --------------------------------------------------------- the layers
def _sliced(p, spec, groups=1):
    """p, drawn whole, cut to this rank's slice and marked with spec."""
    _api.mark_sharding(p, *spec)
    p._split_groups = groups
    p._whole_shape = tuple(p.shape)
    local = _api.local_piece(p.detach(), p)
    if tuple(local.shape) != tuple(p.shape):
        p.data = local.contiguous()
    return p


class ColumnParallelLinear(Layer):
    """Weight [in, out] split on its out columns over 'tp'
    (reference: _parallel_linear axis=1, collective.py:659)."""

    # blocks of the out dim, each split over tp (a subclass for the
    # GPT's fused qkv sets 3: each rank holds its heads of q, k and v)
    _tp_groups = 1

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, name=None):
        super().__init__()
        self.gather_output = gather_output
        self._tp_size = tp_degree()
        g = self._tp_groups
        self.weight = _sliced(self.create_parameter(
            [in_features, out_features], attr=weight_attr), (None, "tp"), g)
        self.bias = None
        if has_bias:
            self.bias = _sliced(self.create_parameter(
                [out_features], is_bias=True), ("tp",), g)

    def forward(self, x):
        pg, n, r = _tp(self._tp_size)
        if n > 1:
            x = _CopyToTP.apply(x, pg)
        out = F.linear(x, self.weight, self.bias)
        if n > 1 and self.gather_output:
            out = _GatherFromTP.apply(out, pg, n, r)
        return out


class _FusedQKVLinear(ColumnParallelLinear):
    """The fused qkv projection of the GPT and BERT attention: its out
    columns are three blocks (q, k, v), each split over tp, so each rank
    holds its heads of all three."""
    _tp_groups = 3


class RowParallelLinear(Layer):
    """Weight [in, out] split on its in rows over 'tp'; the partial
    results are summed over tp (reference: _parallel_linear axis=0 with
    c_allreduce_sum, collective.py:627)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, name=None):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        self._tp_size = tp_degree()
        self.weight = _sliced(self.create_parameter(
            [in_features, out_features], attr=weight_attr), ("tp", None))
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)
            _api.mark_sharding(self.bias)

    def forward(self, x):
        pg, n, r = _tp(self._tp_size)
        if n > 1 and not self.input_is_parallel:
            x = _ScatterToTP.apply(x, pg, n, r)
        out = F.linear(x, self.weight, None)
        if n > 1:
            out = _ReduceFromTP.apply(out, pg)
        return out if self.bias is None else out + self.bias


class VocabParallelEmbedding(Layer):
    """Embedding table split on the vocab dim over 'tp' (reference:
    _parallel_embedding, collective.py:566: per-rank sub-table, masked
    lookup, c_allreduce_sum)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = None
        self._tp_size = tp_degree()
        self.weight = _sliced(self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 0.02)), ("tp", None))

    def forward(self, x):
        pg, n, r = _tp(self._tp_size)
        if n == 1:
            return F.embedding(x, self.weight)
        rows = self.weight.shape[0]
        ids = torch.as_tensor(x, device=self.weight.device).long()
        local = ids - r * rows
        inside = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(inside, local, 0), self.weight)
        out = out * inside.unsqueeze(-1).to(out.dtype)
        return _ReduceFromTP.apply(out, pg)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row cross-entropy of logits split on the last dim over tp."""

    @staticmethod
    def forward(ctx, logits, label, pg, start, ignore_index):
        from . import collective as C
        z = logits.float()
        m = z.max(dim=-1).values
        C._all_reduce(m, C.ReduceOp.MAX, pg)
        e = torch.exp(z - m.unsqueeze(-1))
        s = e.sum(dim=-1)
        C._all_reduce(s, C.ReduceOp.SUM, pg)
        width = z.shape[-1]
        local = label - start
        inside = (local >= 0) & (local < width)
        idx = torch.where(inside, local, 0).unsqueeze(-1)
        tgt = torch.gather(z, -1, idx).squeeze(-1) * inside
        C._all_reduce(tgt, C.ReduceOp.SUM, pg)
        valid = label != ignore_index
        loss = (torch.log(s) + m - tgt) * valid
        ctx.save_for_backward(e / s.unsqueeze(-1), idx, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        soft, idx, inside, valid = ctx.saved_tensors
        grad = soft.scatter_add(-1, idx, -inside.to(soft.dtype).unsqueeze(-1))
        grad = grad * (g * valid).unsqueeze(-1)
        return grad.to(ctx.dtype), None, None, None, None


class ParallelCrossEntropy(Layer):
    """reference: later paddle's mp cross entropy (c_softmax_with_
    cross_entropy): `input` holds this rank's vocab slice of the logits;
    the result is the per-row loss (reduction "none"), the whole-vocab
    F.cross_entropy's."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, input, label):
        pg, n, r = _tp()
        if n == 1:
            return F.cross_entropy(input, label, reduction="none")
        lab = torch.as_tensor(label, device=input.device).long()
        keep = lab.ndim == input.ndim
        if keep:
            lab = lab.squeeze(-1)
        loss = _VocabParallelCE.apply(input, lab, pg,
                                      r * input.shape[-1], -100)
        return loss.unsqueeze(-1) if keep else loss


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """paddle.distributed.split (reference: collective.py:566-750):
    builds the parallel layer and applies it to x.

    operation='embedding': size=(vocab, dim), the vocab split.
    operation='linear': size=(in, out); axis=0 row-parallel, axis=1
    column-parallel."""
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr)
        return layer(x)
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=not gather_out)
        else:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
        return layer(x)
    raise ValueError(f"unknown operation {operation!r}")
