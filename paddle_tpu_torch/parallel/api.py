"""The sharding annotations and the sharded train step (port of
paddle_tpu/parallel/api.py).

The JAX package marks parameters and activations with PartitionSpecs,
jits the whole step over a Mesh and lets XLA's SPMD partitioner insert
the collectives. The port runs one process per GPU over
torch.distributed, so its step issues the collectives itself, over
flat buckets of gradients and parameters (the design of ZeRO and of
torch's DDP/FSDP buckets, written out here rather than taken from FSDP,
because the port's optimizers, Paddle's formulas in
optimizer/optimizers.py, must run unchanged on the shards, and state
dicts must keep the JAX names).

`ShardedTrainStep(model, loss_fn, optimizer, mesh, sharding_stage,
batch_spec, donate, grad_accum_steps)` is called with the GLOBAL batch,
as the JAX step is, and gives its loss and parameters:

- each rank trains on its rows of the batch (`shard_batch` over the
  batch_spec axes, ("dp", "sharding") by default, which the step also
  sets as the mesh's `batch_axes`: MoE layers route the batch whole
  across them) and the returned loss is the mean of the ranks' losses;
- data parallel: a parameter's gradient is the mean over the batch axes
  (and over "ep" when experts are split; a parameter split over an axis,
  tp or ep, by its mark_sharding spec is not averaged over it, and an
  expert's gradient, summed by the all-to-all's backward over the ep
  ranks' tokens, is divided by the ep size), one all-reduce per flat
  bucket of parameters that share a dtype and a group;
- ZeRO-1 (sharding_stage 1): every unmarked parameter with a dimension
  divisible by the sharding degree (`_shard_dim`, the largest) is split
  on that dimension over "sharding"; its optimizer state holds only this
  rank's chunk; the gradient bucket is all-reduced over the sharding
  group, each rank updates its chunks, and one all-gather of the
  updated chunks rebuilds the parameters (the chunks stay the truth
  between steps: a parameter written since the last gather, by
  set_value or a loaded state dict, is cut into its chunk again);
- ZeRO-2 reduce-scatters the gradient bucket instead (each rank
  receives only the mean of its chunks), then all-reduces those over
  the rest of the batch axes;
- ZeRO-3 also keeps only the chunks of those parameters between steps
  (the model's parameters hold empty tensors): one all-gather
  materialises them before the forward and they are dropped after the
  backward; `unshard()` (every rank calls it) puts the whole parameters
  back into the model, for a checkpoint or an evaluation, and the next
  step shards them again;
- sequence parallelism (sp > 1): each rank also takes its chunk of
  every row's positions (`shard_batch` splits dim 1 over "sp", the JAX
  package's activation layout), sp joins the averaged axes (each sp
  rank's gradient is that of its share of the mean: the attention's
  collectives carry the cross-chunk terms home) and the returned loss is
  the mean over sp too;
- pipeline parallelism (pp > 1): the pipeline containers
  (parallel/pipeline.py) own their pp collectives; a parameter marked
  ("pp", ...) is a stage's slab, split over pp and never averaged over
  it, and the replicated ones come out of the pipeline with equal
  gradients on every stage;
- clipping: ClipGradByGlobalNorm (and ClipGradByNorm) sum the squares of
  the pieces each rank holds and all-reduce them over the group the
  pieces are split over (sharding for ZeRO chunks, pp, tp or ep for
  split parameters), so every rank clips with the norm of the whole
  gradient; ClipGradByValue clamps the pieces; any other clip runs its
  `clip_arrays` on the whole gradients, as the JAX step does (pieces
  are all-gathered first and cut again after);
- Lamb and Lars take each parameter's norm whole: over ZeRO chunks and
  pp / tp / ep slices the optimizer's `_whole_norm` all-reduces the
  pieces' sums of squares over the same group;
- gradient merge (grad_accum_steps k > 1): the local gradients of k
  calls accumulate as sum(g / k); the k-th call reduces and applies
  them (the JAX step's accumulator and lax.cond), so the merge costs
  one reduction per k calls;
- AMP O2 (amp.decorate): low-precision parameters train through the
  optimizer's f32 masters, which for ZeRO chunks are chunks too.

At sharding degree 1 (one GPU) the ZeRO stages still go through the
bucket path (a reduce-scatter and an all-gather over a group of one),
so a run on one card exercises NCCL; the updates are then those of
jit.TrainStep.

`shard_activation` and `shard_batch_activation` keep their names and
return their input: torch has no layout constraint to attach.
`donate` is accepted and ignored (eager PyTorch updates in place).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.tensor import box, plain, plain_dispatch
from . import mesh as _mesh

__all__ = ["P", "shard_activation", "shard_batch_activation",
           "shard_batch", "mark_sharding", "param_spec", "local_piece",
           "whole_piece", "ShardingStage", "ShardedTrainStep"]


def P(*spec) -> tuple:
    """A partition spec: per dimension, the mesh axis it is split over
    (or a tuple of axes, or None). The JAX package's PartitionSpec."""
    return tuple(spec)


# ---------------------------------------------------------- annotation
def shard_activation(x, *spec):
    """The JAX package's layout constraint; torch has none: x."""
    return x


def shard_batch_activation(x):
    """The JAX package's canonical batch layout constraint: x."""
    return x


def shard_batch(data, mesh=None, spec=("dp",)):
    """This rank's piece of the global batch `data`: dim 0 split evenly
    over the mesh axes in `spec` (the rank's index along them, row-major
    in the mesh's axis order) and, on a mesh with sp > 1, dim 1 (the
    sequence) over "sp"."""
    mesh = mesh or _mesh.ensure_global_mesh()
    t = torch.from_numpy(np.asarray(data)) if isinstance(
        data, np.ndarray) else plain(data)
    if not torch.is_tensor(t) or t.ndim == 0:
        return box(t)
    axes = tuple(a for a in spec if mesh.shape.get(a, 1) > 1)
    if axes:
        t = _chunk(t, 0, mesh.axis_size(axes), mesh.coord(axes), axes)
    sp = mesh.shape.get("sp", 1)
    if sp > 1 and t.ndim >= 2:
        t = _chunk(t, 1, sp, mesh.coord("sp"), ("sp",))
    return box(t)


def _chunk(t, dim: int, n: int, i: int, axes):
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {t.shape[dim]} does not split over "
                         f"{axes} ({n} ranks)")
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def mark_sharding(param, *spec):
    """Attach a partition spec to a parameter (ShardedTrainStep reads it;
    the tensor-parallel layers and MoE mark theirs)."""
    param._partition_spec = tuple(spec)
    return param


def param_spec(param) -> Optional[tuple]:
    return getattr(param, "_partition_spec", None)


def _auto_fsdp_spec(arr, axis="sharding", size=1):
    """The JAX package's ZeRO-3 layout: the largest dim divisible by
    `size` split over `axis`, else replicated (())."""
    if size <= 1:
        return ()
    d = _shard_dim(tuple(arr.shape), size)
    if d is None:
        return ()
    spec = [None] * len(arr.shape)
    spec[d] = axis
    return tuple(spec)


def _shard_dim(shape, n: int) -> Optional[int]:
    """The largest dimension of `shape` divisible by n (the first of
    equals), or None (a scalar, or no such dimension)."""
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n == 0 and shape[d] >= n:
            return d
    return None


def _split_axes(spec) -> set:
    out = set()
    for s in spec or ():
        if isinstance(s, (tuple, list)):
            out |= {a for a in s if a is not None}
        elif s is not None:
            out.add(s)
    return out


def _split_dims(p, mesh):
    """[(dim, axis)] of p's spec over mesh axes of size > 1."""
    if mesh is None:
        return []
    return [(d, a) for d, a in enumerate(param_spec(p) or ())
            if isinstance(a, str) and mesh.shape.get(a, 1) > 1]


def local_piece(whole, p, mesh=None):
    """This rank's piece of `whole` (a tensor of p's whole shape) under
    p's spec: each split dim cut into the axis size's chunks (within
    each of p._split_groups blocks), this rank's chunk kept."""
    mesh = mesh or _mesh.get_global_mesh()
    g = getattr(p, "_split_groups", 1)
    out = whole
    for d, a in _split_dims(p, mesh):
        n, r = mesh.shape[a], mesh.coord(a)
        x = out.movedim(d, 0)
        rest = tuple(x.shape[1:])
        x = x.reshape((g, n, x.shape[0] // (g * n)) + rest)[:, r]
        out = x.reshape((-1,) + rest).movedim(0, d)
    return out


def whole_piece(local, p, mesh=None):
    """The whole tensor from every rank's `local` piece of p (an
    all-gather over each split axis; every rank of it calls this)."""
    from ..distributed import collective as C
    mesh = mesh or _mesh.get_global_mesh()
    g = getattr(p, "_split_groups", 1)
    out = local
    for d, a in _split_dims(p, mesh):
        n = mesh.shape[a]
        x = out.movedim(d, 0).contiguous()
        rest = tuple(x.shape[1:])
        parts = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device)
        C._all_gather(parts, x, mesh.group(a))
        parts = parts.reshape((n, g, x.shape[0] // g) + rest)
        out = parts.transpose(0, 1).reshape((-1,) + rest).movedim(0, d)
    return out


class ShardingStage:
    """ZeRO stages (reference: DistributedStrategy sharding_configs /
    sharding_optimizer.py)."""
    OFF = 0
    OPTIMIZER = 1   # ZeRO-1: shard optimizer states
    GRADIENT = 2    # ZeRO-2: + gradients (reduce-scatter)
    PARAMETER = 3   # ZeRO-3: + parameters


class _Bucket:
    """Parameters reduced together: one dtype, one group.

    kind "full": each rank holds the whole parameter (or its tp/ep
    slice); the flat gradient is all-reduced over `pg` (mean) and
    divided by `div`. kind "zero": each parameter is split on `dims[i]`
    into n chunks; the flat layout is [n, S], row r holding rank r's
    chunk of every parameter at `offs[i]`."""

    def __init__(self, kind, dtype, pg, div=1, n=1):
        self.kind, self.dtype, self.pg, self.div, self.n = \
            kind, dtype, pg, div, n
        self.names: List[str] = []
        self.params: list = []
        self.dims: List[int] = []
        self.shapes: list = []   # whole shapes
        self.offs: List[int] = []
        self.sizes: List[int] = []
        self.width = 0

    def add(self, name, p, dim=None):
        self.names.append(name)
        self.params.append(p)
        self.dims.append(dim)
        shape = tuple(p.shape)
        self.shapes.append(shape)
        numel = int(np.prod(shape, dtype=np.int64))
        size = numel // self.n
        self.offs.append(self.width)
        self.sizes.append(size)
        self.width += size


def _versions(params) -> list:
    """The in-place write counters of `params`."""
    return [p._version for p in params]


def _blocks(t, d, n):
    """t, a parameter or its gradient, as [n, shape[d] / n, *the other
    dims] (a view): block r is rank r's ZeRO chunk."""
    return t.movedim(d, 0).unflatten(0, (n, -1))


class ShardedTrainStep:
    """The distributed train step (see the module docstring).
    loss_fn(model, *batch) -> scalar loss (or a tuple whose first entry
    is the loss)."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 sharding_stage: int = ShardingStage.OFF,
                 batch_spec=("dp", "sharding"), donate=True,
                 grad_accum_steps: int = 1):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh or _mesh.ensure_global_mesh()
        _mesh.set_global_mesh(self.mesh)
        self.sharding_stage = int(sharding_stage)
        self._batch_spec = tuple(batch_spec)
        self._k = max(int(grad_accum_steps), 1)
        self._count = 0
        self._acc = None
        self._plan = None
        shape = self.mesh.shape
        self._n_shard = shape["sharding"] if self.sharding_stage else 1
        self.mesh.batch_axes = tuple(a for a in self._batch_spec
                                     if a in _mesh.AXES)
        sp = {"sp"} if shape["sp"] > 1 else set()
        self._avg_axes = tuple(a for a in _mesh.AXES if a in set(
            self._batch_spec) | ({"ep"} if shape["ep"] > 1 else set()) | sp)
        # every group this step reduces over, made now: new_group is a
        # collective every rank calls in the same order
        self._batch_pg = self.mesh.group(
            [a for a in self._batch_spec if a in _mesh.AXES] + list(sp))
        for axes in self._groups_needed():
            self.mesh.group(axes)

    # ------------------------------------------------------------ plan
    def _groups_needed(self):
        shard = ("sharding",) if self.sharding_stage else ()
        rest = tuple(a for a in self._avg_axes if a not in shard)
        out = [self._avg_axes, rest, ("pp",), ("tp",), ("ep",)]
        if shard:
            out.append(shard)
        for a in ("tp", "ep"):
            out.append(tuple(x for x in self._avg_axes if x != a))
        return [tuple(a) for a in out if a]

    def _trained(self):
        from ..jit import _trains
        return [(k, p) for k, p in self.model.named_parameters()
                if _trains(p)]

    def _build_plan(self, params):
        mesh, stage, n = self.mesh, self.sharding_stage, self._n_shard
        buckets: Dict[tuple, _Bucket] = {}
        for name, p in params:
            split = _split_axes(param_spec(p)) & {
                a for a in _mesh.AXES if mesh.shape[a] > 1}
            d = _shard_dim(tuple(p.shape), n) \
                if stage and not split else None
            if d is not None:
                rest = tuple(a for a in self._avg_axes if a != "sharding")
                key = ("zero", p.dtype)
                if key not in buckets:
                    buckets[key] = _Bucket(
                        "zero", p.dtype, mesh.group(rest), n=n)
                    buckets[key].shard_pg = mesh.group("sharding")
                buckets[key].add(name, p, d)
                continue
            axes = tuple(a for a in self._avg_axes if a not in split)
            div = mesh.shape["ep"] if "ep" in split else 1
            key = ("full", p.dtype, axes, div)
            if key not in buckets:
                buckets[key] = _Bucket("full", p.dtype, mesh.group(axes),
                                       div=div)
                buckets[key].split = split
            buckets[key].add(name, p)
        self._plan = list(buckets.values())
        self._shards = {}
        for b in self._plan:
            if b.kind == "zero":
                b.pbuf = torch.empty(b.width, dtype=b.dtype,
                                     device=b.params[0].device)
                # each chunk's shape: [shape[d] / n, *the other dims]
                b.chunk_shapes = [
                    (shape[d] // n,) + shape[:d] + shape[d + 1:]
                    for shape, d in zip(b.shapes, b.dims)]
                b.chunks = [b.pbuf[o:o + s] for o, s in
                            zip(b.offs, b.sizes)]
                self._load_chunks(b)
                if stage >= ShardingStage.PARAMETER:
                    for p in b.params:
                        p.data = p.data.new_empty(0)
            for name, p in zip(b.names, b.params):
                self._shards[name] = b

    def _me(self, b) -> int:
        return self.mesh.coord("sharding") if b.n > 1 else 0

    @torch.no_grad()
    def _load_chunks(self, b):
        """This rank's chunks, cut from the model's whole parameters."""
        me = self._me(b)
        torch._foreach_copy_(
            [c.view(cs) for c, cs in zip(b.chunks, b.chunk_shapes)],
            [_blocks(p.detach(), d, b.n)[me]
             for p, d in zip(b.params, b.dims)])
        b.versions = _versions(b.params)

    @torch.no_grad()
    def _gather(self, b):
        """Whole parameters from every rank's chunks: one all-gather."""
        from ..distributed import collective as C
        full = torch.empty(b.n * b.width, dtype=b.dtype,
                           device=b.pbuf.device)
        if b.shard_pg is None:
            full.copy_(b.pbuf)
        else:
            C._all_gather(full, b.pbuf, b.shard_pg)
        rows = full.view(b.n, b.width)
        for p, shape in zip(b.params, b.shapes):
            if p.numel() == 0:   # ZeRO-3: materialise the parameter
                p.data = p.data.new_empty(shape)
        torch._foreach_copy_(
            [_blocks(p.detach(), d, b.n) for p, d in zip(b.params, b.dims)],
            [rows[:, o:o + s].unflatten(1, cs) for o, s, cs in
             zip(b.offs, b.sizes, b.chunk_shapes)])
        b.versions = _versions(b.params)

    def unshard(self):
        """ZeRO-3: put the whole parameters back into the model (every
        rank calls it); the next step shards them again."""
        if self._plan is None or self.sharding_stage < 3:
            return
        for b in self._plan:
            if b.kind == "zero":
                self._gather(b)

    # ---------------------------------------------------------- reduce
    def _reduce(self, grads):
        """{name: reduced gradient}: whole for "full" buckets, this
        rank's 1-D chunk for "zero" buckets."""
        from ..distributed import collective as C
        out = {}
        for b in self._plan:
            if b.kind == "full":
                flat = torch.cat([grads[k].reshape(-1) for k in b.names])
                if b.pg is not None:
                    C._all_reduce(flat, C.ReduceOp.AVG, b.pg)
                if b.div != 1:
                    flat.div_(b.div)
                for k, shape, o in zip(b.names, b.shapes, b.offs):
                    out[k] = flat[o:o + int(np.prod(shape))].view(shape)
                continue
            send = torch.empty(b.n, b.width, dtype=b.dtype,
                               device=b.pbuf.device)
            torch._foreach_copy_(
                [send[:, o:o + s].unflatten(1, cs) for o, s, cs in
                 zip(b.offs, b.sizes, b.chunk_shapes)],
                [_blocks(grads[k], d, b.n) for k, d in
                 zip(b.names, b.dims)])
            mine = torch.empty(b.width, dtype=b.dtype, device=send.device)
            if b.shard_pg is None:
                mine.copy_(send[0])
            elif self.sharding_stage == ShardingStage.OPTIMIZER:
                C._all_reduce(send, C.ReduceOp.AVG, b.shard_pg)
                mine.copy_(send[self._me(b)])
            else:
                C._reduce_scatter(mine, send.view(-1), C.ReduceOp.AVG,
                                  b.shard_pg)
            if b.pg is not None:
                C._all_reduce(mine, C.ReduceOp.AVG, b.pg)
            for k, o, s in zip(b.names, b.offs, b.sizes):
                out[k] = mine[o:o + s]
        return out

    # ------------------------------------------------------------ clip
    def _piece_group(self, name):
        """The group whose ranks hold disjoint pieces of `name`'s
        gradient, or None."""
        b = self._shards[name]
        if b.kind == "zero":
            return b.shard_pg
        split = [a for a in ("pp", "tp", "ep") if a in b.split]
        return self.mesh.group(split) if split else None

    @torch.no_grad()
    def _clip(self, grads):
        from ..distributed import collective as C
        from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                               ClipGradByValue)
        clip = self.optimizer._grad_clip
        if clip is None:
            return grads
        by_name = dict(self._params)
        names = [k for k in sorted(grads)
                 if getattr(by_name[k], "need_clip", True)]
        if isinstance(clip, ClipGradByValue):
            for k in names:
                grads[k] = grads[k].clamp(clip.min, clip.max)
            return grads
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
            return self._clip_whole(clip, grads)
        sq = {k: grads[k].float().square().sum() for k in names}
        groups = {}
        for k in names:
            groups.setdefault(id(self._piece_group(k)), []).append(k)
        for ks in groups.values():
            pg = self._piece_group(ks[0])
            if pg is not None:
                vec = torch.stack([sq[k] for k in ks])
                C._all_reduce(vec, C.ReduceOp.SUM, pg)
                sq.update(zip(ks, vec.unbind(0)))
        if isinstance(clip, ClipGradByGlobalNorm):
            if not names:
                return grads
            norm = torch.sqrt(sum(sq[k] for k in names))
            scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
            for k in names:
                grads[k] = grads[k] * scale.to(grads[k].dtype)
            return grads
        for k in names:
            scale = torch.clamp(clip.clip_norm / torch.clamp(
                sq[k].sqrt(), min=1e-12), max=1.0)
            grads[k] = grads[k] * scale.to(grads[k].dtype)
        return grads

    def _clip_whole(self, clip, grads):
        """Any other clip: its clip_arrays over the whole gradients in
        name order (the JAX step's call), every piece gathered whole
        first and cut back to this rank's after."""
        names = sorted(grads)
        whole = [self._whole_grad(k, grads[k]) for k in names]
        clipped = clip.clip_arrays(whole)
        for k, g in zip(names, clipped):
            grads[k] = self._local_grad(k, g)
        return grads

    def _whole_grad(self, name, g):
        from ..distributed import collective as C
        b = self._shards[name]
        if b.kind == "full":
            return whole_piece(g, b.params[b.names.index(name)], self.mesh)
        i = b.names.index(name)
        rows = torch.empty((b.n,) + tuple(g.shape), dtype=g.dtype,
                           device=g.device)
        if b.shard_pg is None:
            rows[0].copy_(g)
        else:
            C._all_gather(rows, g, b.shard_pg)
        blocks = rows.unflatten(1, b.chunk_shapes[i])
        return blocks.flatten(0, 1).movedim(0, b.dims[i])

    def _local_grad(self, name, whole):
        b = self._shards[name]
        if b.kind == "full":
            return local_piece(whole, b.params[b.names.index(name)],
                               self.mesh)
        i = b.names.index(name)
        return _blocks(whole, b.dims[i], b.n)[self._me(b)].reshape(-1)

    # ----------------------------------------------------------- apply
    def _state(self, p, chunk):
        """The optimizer's accumulators for `p`, made for `chunk` (its
        ZeRO chunk or itself) on first use."""
        opt = self.optimizer
        st = opt._accumulators.get(id(p))
        if st is None or any(v.ndim and v.shape != chunk.shape
                             for k, v in st.items()):
            st = opt._accumulators[id(p)] = opt._fresh_state(chunk)
        return st

    @torch.no_grad()
    def _apply(self, grads):
        flat_params, states = {}, {}
        for b in self._plan:
            if b.kind == "zero":
                # the chunks hold the parameters since the last gather,
                # unless the caller wrote a parameter (set_value, a
                # loaded state dict) since then
                if self.sharding_stage < ShardingStage.PARAMETER and \
                        _versions(b.params) != b.versions:
                    self._load_chunks(b)
                views = b.chunks
            else:
                views = [p.detach() for p in b.params]
            for k, p, v in zip(b.names, b.params, views):
                flat_params[k] = v
                states[k] = self._state(p, v)
        self.optimizer._norm_groups = {
            k: self._piece_group(k) for k in flat_params
            if self._piece_group(k) is not None}
        self.optimizer.apply_updates(flat_params, grads, states)
        for b in self._plan:
            if b.kind == "zero" and \
                    self.sharding_stage < ShardingStage.PARAMETER:
                self._gather(b)

    # ------------------------------------------------------------ call
    @plain_dispatch
    def __call__(self, *args):
        from ..distributed import collective as C
        params = self._params = self._trained()
        if self._plan is None:
            self._build_plan(params)
        zero3 = self.sharding_stage >= ShardingStage.PARAMETER
        if zero3:
            for b in self._plan:
                if b.kind == "zero":
                    self._gather(b)
        dev = next(iter(p.device for _, p in params))
        local = [shard_batch(plain(a).to(dev) if torch.is_tensor(a) else
                             torch.from_numpy(np.asarray(a)).to(dev),
                             self.mesh, self._batch_spec)
                 for a in args]
        out = self.loss_fn(self.model, *[plain(a) for a in local])
        loss = out[0] if isinstance(out, (tuple, list)) else out
        got = torch.autograd.grad(loss, [p for _, p in params],
                                  allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g)
                 for (k, p), g in zip(params, got)}
        if zero3:
            for b in self._plan:
                if b.kind == "zero":
                    for p in b.params:
                        p.data = p.data.new_empty(0)
        if self._k > 1:
            if self._acc is None:
                self._acc = {k: torch.zeros_like(g)
                             for k, g in grads.items()}
            for k, g in grads.items():
                self._acc[k].add_(g / self._k)
            grads = self._acc
        self._count += 1
        if self._count % self._k == 0:
            with torch.profiler.record_function("optimizer"):
                self._apply(self._clip(self._reduce(grads)))
            if self._acc is not None:
                for a in self._acc.values():
                    a.zero_()
        self.optimizer._global_step += 1
        loss = loss.detach().reshape(()).clone()
        if self._batch_pg is not None:
            C._all_reduce(loss, C.ReduceOp.AVG, self._batch_pg)
        return box(loss)
