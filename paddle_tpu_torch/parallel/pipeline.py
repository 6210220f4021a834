"""Pipeline parallelism (port of paddle_tpu/parallel/pipeline.py;
reference: fluid/optimizer.py:3718 PipelineOptimizer,
framework/section_worker.cc:34-105, the all-forward-then-all-backward
GPipe schedule).

Layer parameters are stacked on a leading [num_layers] dim, as in the
JAX package (`blk.qkv_w` is [L, H, 3H]), and split over the mesh's "pp"
axis: stage r holds layers [r L/pp, (r+1) L/pp) of every stacked
parameter, marked ("pp", None, ...) so ShardedTrainStep never averages
it over pp. The JAX package runs the schedule as a fori_loop under
shard_map and lets autodiff of ppermute give the backward pipeline; a
rank here is a process, so `pipeline_spmd` builds one
torch.autograd.Function (`_GPipe`) around the whole schedule:
- its forward runs every microbatch forward in turn: stage 0 takes the
  microbatch, the others receive the activation from the stage above
  (explicit send/recv over the pp group), each runs its local layers and
  sends the result down; the last stage keeps the outputs, which are
  then broadcast to every pp rank (the JAX package's psum(outs * mask));
- its backward runs every microbatch backward in reverse order, each
  stage receiving the output gradient from the stage below and sending
  its input gradient up, from the per-microbatch graphs the forward
  kept. The order is written out: autograd through send/recv would run
  the backward in whatever order autograd picks, which can deadlock
  against the peer stage. The input gradients, computed by stage 0,
  are broadcast to every pp rank, so a replicated parameter upstream of
  the pipeline (the embeddings) gets the same gradient on every stage.
So ShardedTrainStep's single backward drives it unchanged. With
`remat_stages` each layer runs under the port's `recompute` (slice 8c:
dropout draws and casts replayed bitwise), so a stage keeps one input
per layer and microbatch instead of every internal (the JAX package's
jax.checkpoint(stage_fn)); without it the graphs keep everything. At
pp = 1 the same schedule runs with no collective (the JAX package's
`no_pp` path: the microbatches one after another through every layer).

`PipelinedGPT` is the stacked-parameter GPT: the loss (embeddings,
ln_f, head and cross-entropy) runs on every pp rank, as the JAX package
replicates them; its block is `_gpt_block_forward` (pre-LN, eps 1e-5,
tanh GELU, the qkv split as reshape(B, T, 3, nh, hd)), whose causal
attention goes through kernel K1 on CUDA and its plain version on the
CPU. Weights come from the seed, or from the JAX package
(`PipelinedGPT.load_jax_params`); `state_dict()` gives the whole stacked
tensors, gathered over pp, under the JAX names. `num_micro` (the port's
attribute; the fleet sets it from pipeline_configs' accumulate_steps)
defaults to the pp degree, as in the JAX package. `PipelineLayer` stacks
any same-structured blocks and keeps the JAX package's refusals.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.place import DeviceLike, default_device
from ..core.tensor import EagerParamBase, plain
from ..nn.layer.layers import Layer, load_jax_state
from ..ops.kernels.flash_attention import flash_attention
from . import mesh as _mesh
from .api import local_piece, mark_sharding, whole_piece

__all__ = ["pipeline_spmd", "PipelinedGPT", "pipelined_gpt_loss_fn",
           "PipelineLayer"]


class _Schedule:
    """What _GPipe needs besides tensors: the per-layer function, the
    stacked parameters' names, the pp group and this stage's place."""

    def __init__(self, layer_fn, names, pg, rank, stages):
        self.layer_fn, self.names = layer_fn, names
        self.pg, self.rank, self.stages = pg, rank, stages


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, xs, *slabs):
        from ..distributed import collective as C
        r, S, pg = sched.rank, sched.stages, sched.pg
        # each layer's slice of each slab as a leaf of its own, so the
        # backward takes per-layer gradients (autograd through slab[l]
        # would write a zero-filled slab for every layer and microbatch)
        layers = [{k: s[layer].detach().requires_grad_(s.requires_grad)
                   for k, s in zip(sched.names, slabs)}
                  for layer in range(slabs[0].shape[0])]
        outs = torch.zeros_like(xs)
        graphs = []
        with torch.enable_grad():
            for m in range(xs.shape[0]):
                if r == 0:
                    x = xs[m].detach()
                else:
                    x = C._recv(torch.empty_like(xs[m]), r - 1, pg)
                x.requires_grad_(True)
                y = x
                for p in layers:
                    y = sched.layer_fn(p, y)
                if r < S - 1:
                    C._send(y.detach(), r + 1, pg)
                else:
                    outs[m] = y.detach()
                graphs.append((x, y))
        if S > 1:
            C._broadcast(outs, S - 1, pg)
        ctx.sched, ctx.graphs, ctx.layers = sched, graphs, layers
        ctx.slabs = [(s.shape, s.dtype, s.device, s.requires_grad)
                     for s in slabs]
        return outs

    @staticmethod
    def backward(ctx, dys):
        from ..distributed import collective as C
        sched, graphs, layers = ctx.sched, ctx.graphs, ctx.layers
        r, S, pg = sched.rank, sched.stages, sched.pg
        trained = [(li, k) for li, p in enumerate(layers)
                   for k, t in p.items() if t.requires_grad]
        grads = [torch.zeros(shape, dtype=dt, device=dev) if rg else None
                 for shape, dt, dev, rg in ctx.slabs]
        slot = {k: i for i, k in enumerate(sched.names)}
        dxs = torch.zeros((len(graphs),) + tuple(graphs[0][0].shape),
                          dtype=graphs[0][0].dtype,
                          device=graphs[0][0].device)
        for m in reversed(range(len(graphs))):
            x, y = graphs[m]
            graphs[m] = None
            if r == S - 1:
                dy = dys[m].contiguous()
            else:
                dy = C._recv(torch.empty_like(y), r + 1, pg)
            got = torch.autograd.grad(
                y, [x] + [layers[li][k] for li, k in trained], dy,
                allow_unused=True)
            if r > 0:
                C._send(got[0], r - 1, pg)
            else:
                dxs[m] = got[0]
            for (li, k), g in zip(trained, got[1:]):
                if g is not None:
                    grads[slot[k]][li] += g
        if S > 1:
            C._broadcast(dxs, 0, pg)
        return (None, dxs, *grads)


def pipeline_spmd(stage_fn, mesh, num_stages: int, num_micro: int,
                  remat_stages: bool = True):
    """Build f(stacked_params, xs) -> ys running the GPipe schedule over
    the mesh's pp group (module docstring).

    stage_fn(layer_params, x) -> x : ONE layer's forward, layer_params
    the {name: tensor} of one layer. stacked_params: {name: this stage's
    slab [L / num_stages, ...]}. xs: [num_micro, micro_batch, ...] (the
    same on every pp rank). Returns ys of xs's shape, on every pp rank.
    """
    layer_fn = stage_fn
    if remat_stages:
        from ..distributed.fleet.utils import recompute

        def layer_fn(p, x):
            return recompute(stage_fn, p, x)
    pp = int(mesh.shape.get("pp", 1))
    if pp != num_stages:
        raise ValueError(f"num_stages {num_stages} != the mesh's pp {pp}")
    pg = mesh.group("pp") if pp > 1 else None
    rank = mesh.coord("pp")

    def run(stacked: Dict[str, torch.Tensor], xs):
        names = sorted(stacked)
        if xs.shape[0] != num_micro:
            raise ValueError(f"{xs.shape[0]} microbatches, built for "
                             f"{num_micro}")
        return _GPipe.apply(_Schedule(layer_fn, names, pg, rank, pp), xs,
                            *[stacked[k] for k in names])
    return run


# ---------------------------------------------------------------------------
# Pipelined GPT: stacked-parameter variant of models.gpt.GPT
# ---------------------------------------------------------------------------
def _gpt_block_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                       num_heads: int = 1) -> torch.Tensor:
    """One pre-LN GPT block over one layer's parameters (the JAX
    package's _gpt_block_forward); causal attention through K1 on CUDA,
    its plain version on the CPU."""
    B, T, H = x.shape
    h = TF.layer_norm(x, (H,), p["ln1_w"], p["ln1_b"], 1e-5)
    qkv = h @ p["qkv_w"] + p["qkv_b"]
    hd = H // num_heads
    qkv = qkv.reshape(B, T, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    att = flash_attention(q, k, v, causal=True, scale=1.0 / math.sqrt(hd),
                          heads_major=True)
    att = att.transpose(1, 2).reshape(B, T, H)
    x = x + att @ p["out_w"] + p["out_b"]
    h2 = TF.layer_norm(x, (H,), p["ln2_w"], p["ln2_b"], 1e-5)
    return x + TF.gelu(h2 @ p["up_w"] + p["up_b"], approximate="tanh") \
        @ p["down_w"] + p["down_b"]


class _StackedLayer(Layer):
    """A Layer whose parameters carry the JAX package's dotted names
    ("blk.qkv_w", "pipe.fc1.weight"): registered under attribute-safe
    names, listed under their own by named_parameters and state_dict."""

    def _add(self, name: str, value: torch.Tensor, spec) -> None:
        p = EagerParamBase(value, name=name)
        mark_sharding(p, *spec)
        p._whole_shape = tuple(getattr(value, "_whole_shape", value.shape))
        self.register_parameter(name.replace(".", "__"), p)
        self._names.append(name)

    def named_parameters(self, *args, **kwargs):
        return iter([(n, self._parameters[n.replace(".", "__")])
                     for n in self._names])

    def named_buffers(self, *args, **kwargs):
        return iter([])

    def buffers(self, *args, **kwargs):
        return []

    def param(self, name: str) -> torch.Tensor:
        return self._parameters[name.replace(".", "__")]

    @torch.no_grad()
    def state_dict(self, *args, **kwargs):
        """{JAX name: the whole tensor}, stage slabs gathered over pp
        (every pp rank calls it)."""
        return {n: whole_piece(p.detach(), p, self.mesh)
                for n, p in self.named_parameters()}

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load whole tensors (numpy or torch) under the JAX names; each
        stage keeps its slab."""
        load_jax_state(self, {k: plain(v).detach().cpu().float().numpy()
                              if torch.is_tensor(v) else np.asarray(v)
                              for k, v in state_dict.items()})
        return [], []


def _stacked(whole: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's piece of `whole` under `spec` (a stand-in parameter
    carries the spec to local_piece)."""
    class _Spec:
        _partition_spec = tuple(spec)
    out = local_piece(whole, _Spec(), mesh)
    out._whole_shape = tuple(whole.shape)
    return out


class PipelinedGPT(_StackedLayer):
    """GPT with layer-stacked parameters for pp sharding (see the module
    docstring). Exposes named_parameters()/parameters() under the JAX
    names, so it plugs into the optimizers and ShardedTrainStep. Weights
    are drawn on the CPU from `seed` (normal(0, 0.02) matrices and
    embeddings, unit LayerNorms, zero biases: the JAX package's
    families) and cut to this stage's slabs on `device`; seed None
    leaves them unset for a caller that loads them (load_jax_params,
    from_gpt)."""

    def __init__(self, cfg, mesh=None, device: DeviceLike = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh or _mesh.ensure_global_mesh()
        self._pp = int(self.mesh.shape.get("pp", 1))
        H, L = cfg.hidden_size, cfg.num_layers
        if L % self._pp:
            raise ValueError(f"{L} layers do not divide over pp="
                             f"{self._pp} stages")
        inner = cfg.ffn_mult * H
        V = cfg.vocab_size
        mat, one, zero = "normal", "ones", "zeros"
        shapes = [
            ("wte", (V, H), mat, ()), ("wpe", (cfg.max_seq_len, H), mat, ()),
            ("ln_f_w", (H,), one, ()), ("ln_f_b", (H,), zero, ()),
            ("head_w", (H, V), mat, ()),
            ("blk.ln1_w", (L, H), one, ("pp",)),
            ("blk.ln1_b", (L, H), zero, ("pp",)),
            ("blk.qkv_w", (L, H, 3 * H), mat, ("pp", None, None)),
            ("blk.qkv_b", (L, 3 * H), zero, ("pp", None)),
            ("blk.out_w", (L, H, H), mat, ("pp", None, None)),
            ("blk.out_b", (L, H), zero, ("pp", None)),
            ("blk.ln2_w", (L, H), one, ("pp",)),
            ("blk.ln2_b", (L, H), zero, ("pp",)),
            ("blk.up_w", (L, H, inner), mat, ("pp", None, None)),
            ("blk.up_b", (L, inner), zero, ("pp", None)),
            ("blk.down_w", (L, inner, H), mat, ("pp", None, None)),
            ("blk.down_b", (L, H), zero, ("pp", None))]
        g = None if seed is None else torch.Generator().manual_seed(seed)
        self._names: List[str] = []
        with default_device(device) as dev:
            for name, shape, kind, spec in shapes:
                if g is None:
                    local = torch.empty(
                        (shape[0] // self._pp,) + shape[1:] if spec
                        else shape, device=dev)
                    local._whole_shape = shape
                else:
                    whole = torch.empty(shape)
                    if kind == mat:
                        whole.normal_(0.0, 0.02, generator=g)
                    else:
                        whole.fill_(1.0 if kind == one else 0.0)
                    local = _stacked(whole, spec, self.mesh)
                    whole_shape = local._whole_shape
                    local = local.to(dev)
                    local._whole_shape = whole_shape
                self._add(name, local, spec)
        self._num_heads = cfg.num_heads
        self.num_micro: Optional[int] = None
        self.remat_stages = True
        self._pipelines: Dict[int, Callable] = {}

    @property
    def device(self) -> torch.device:
        return self.param("wte").device

    @classmethod
    def load_jax_params(cls, cfg, params: Dict[str, np.ndarray],
                        device: DeviceLike = None,
                        mesh=None) -> "PipelinedGPT":
        """A PipelinedGPT holding the JAX model's weights: `params` is the
        numpy form of its state_dict() (whole stacked arrays); each stage
        keeps its slab."""
        return load_jax_state(cls(cfg, mesh, device=device, seed=None),
                              params)

    # models/gpt.py's names of one block's tensors, by stacked name
    _GPT_BLOCK = {"ln1_w": "ln1.weight", "ln1_b": "ln1.bias",
                  "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
                  "out_w": "attn.out.weight", "out_b": "attn.out.bias",
                  "ln2_w": "ln2.weight", "ln2_b": "ln2.bias",
                  "up_w": "mlp.up.weight", "up_b": "mlp.up.bias",
                  "down_w": "mlp.down.weight", "down_b": "mlp.down.bias"}
    _GPT_TOP = {"wte": "wte.weight", "wpe": "wpe.weight",
                "ln_f_w": "ln_f.weight", "ln_f_b": "ln_f.bias",
                "head_w": "lm_head.weight"}

    @classmethod
    @torch.no_grad()
    def from_gpt(cls, gpt, mesh=None) -> "PipelinedGPT":
        """The port's models.gpt.GPT (dense MLPs, tp 1) as a PipelinedGPT
        on its device and in its dtype: the same weights, each block's
        stacked on the leading dim (the fused qkv's columns are q, k, v
        with heads in order in both layouts)."""
        own = dict(gpt.named_parameters())
        m = cls(gpt.cfg, mesh, device=gpt.device, seed=None)
        m.to(own["wte.weight"].dtype)
        for name, p in m.named_parameters():
            if name.startswith("blk."):
                key = cls._GPT_BLOCK[name[4:]]
                whole = torch.stack([own[f"blocks.{i}.{key}"]
                                     for i in range(gpt.cfg.num_layers)])
            else:
                whole = own[cls._GPT_TOP[name]]
            p.copy_(local_piece(whole, p, m.mesh))
        return m

    # -------------------------------------------------------------- loss
    def logits(self, input_ids, num_micro=None):
        """[B, T, V] next-token logits (the loss's, before the
        cross-entropy)."""
        cfg = self.cfg
        M = num_micro or self.num_micro or max(self._pp, 1)
        ids = torch.as_tensor(plain(input_ids), device=self.device).long()
        B, T = ids.shape
        if B % M:
            raise ValueError(f"batch {B} must divide into {M} "
                             f"microbatches")
        x = TF.embedding(ids, self.param("wte")) \
            + self.param("wpe")[:T][None]
        xs = x.reshape(M, B // M, T, cfg.hidden_size)
        if M not in self._pipelines:
            nh = self._num_heads
            self._pipelines[M] = pipeline_spmd(
                lambda p, a: _gpt_block_forward(p, a, nh), self.mesh,
                self._pp, M, remat_stages=self.remat_stages)
        stacked = {n[4:]: p for n, p in self.named_parameters()
                   if n.startswith("blk.")}
        ys = self._pipelines[M](stacked, xs)
        y = TF.layer_norm(ys.reshape(B, T, cfg.hidden_size),
                          (cfg.hidden_size,), self.param("ln_f_w"),
                          self.param("ln_f_b"), 1e-5)
        return y @ self.param("head_w")

    def loss(self, input_ids, labels, num_micro=None):
        from ..nn.functional import cross_entropy
        logits = self.logits(input_ids, num_micro)
        lab = torch.as_tensor(plain(labels), device=self.device).long()
        return cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                             lab.reshape(-1))


def pipelined_gpt_loss_fn(model, input_ids, labels):
    return model.loss(input_ids, labels)


# ---------------------------------------------------------------------------
# Generic pipeline container: stack ANY same-shaped Layer blocks
# ---------------------------------------------------------------------------
class PipelineLayer(_StackedLayer):
    """Pipeline-parallel container over arbitrary same-structured blocks
    (reference: distributed/fleet/meta_parallel PipelineLayer): the
    blocks' parameters are stacked on a leading [num_layers] dim split
    over the mesh's pp axis, as "pipe.<name>", and the first block's
    forward runs on each layer's slice of them (torch.func.
    functional_call) under pipeline_spmd's schedule.

    Every block must have the same parameter tree (names and shapes: the
    port checks both, the JAX package the names before stacking) and map
    [micro_batch, ...] -> the same shape. Blocks with buffers (BatchNorm
    running stats) are refused: stat updates are not functional across
    microbatches; so are blocks holding dropout layers, as in the JAX
    package (its staged schedule replays one stage function with a fixed
    key, so masks would repeat across layers and microbatches)."""

    def __init__(self, layers, mesh=None, num_micro=None,
                 remat_stages=True):
        super().__init__()
        blocks = list(layers)
        if not blocks:
            raise ValueError("PipelineLayer needs at least one block")
        self.mesh = mesh or _mesh.ensure_global_mesh()
        self._pp = int(self.mesh.shape.get("pp", 1))
        L = len(blocks)
        if L % max(self._pp, 1) != 0:
            raise ValueError(f"{L} blocks do not divide over pp="
                             f"{self._pp} stages")
        self.num_micro = num_micro
        self.remat_stages = remat_stages

        def structure(b):
            return [(k, tuple(p.shape)) for k, p in b.named_parameters()]
        names = [k for k, _ in structure(blocks[0])]
        for b in blocks[1:]:
            if structure(b) != structure(blocks[0]):
                raise ValueError(
                    "PipelineLayer blocks must share one parameter "
                    f"structure; got {structure(blocks[0])} vs "
                    f"{structure(b)}")
        for b in blocks:
            if any(True for _ in b.named_buffers()):
                raise ValueError(
                    "PipelineLayer blocks must be buffer-free (running "
                    "stats cannot update functionally across microbatches)")
        from ..nn.layer import common as _common
        rng_types = (_common.Dropout, _common.Dropout2D, _common.Dropout3D,
                     _common.AlphaDropout)
        for b in blocks:
            for sub in b.sublayers(include_self=True):
                if isinstance(sub, rng_types):
                    raise ValueError(
                        f"PipelineLayer blocks may not contain RNG layers "
                        f"({type(sub).__name__}): the staged schedule "
                        "replays one stage function, so dropout masks "
                        "would repeat across layers and microbatches")

        self._names = []
        for name in names:
            with torch.no_grad():
                whole = torch.stack([dict(b.named_parameters())[name]
                                     .detach() for b in blocks])
            spec = ("pp",) + (None,) * (whole.ndim - 1)
            self._add(f"pipe.{name}", _stacked(whole, spec, self.mesh), spec)
        self._block_names = names
        # the template runs outside the module tree: its own parameters
        # are never trained (functional_call swaps in each layer's)
        self.__dict__["_template"] = blocks[0]
        self.__dict__["blocks"] = blocks
        self._pipelines: Dict[int, Callable] = {}

    def train(self, mode: bool = True):
        super().train(mode)
        for b in self.blocks:
            b.train(mode)
        return self

    def eval(self):
        return self.train(False)

    def _stage_fn(self, layer_params, x):
        out = torch.func.functional_call(
            self._template, {n: layer_params[f"pipe.{n}"]
                             for n in self._block_names}, (x,))
        return out[0] if isinstance(out, (tuple, list)) else out

    def forward(self, x, num_micro=None):
        xv = plain(x) if torch.is_tensor(x) else torch.as_tensor(x)
        M = num_micro or self.num_micro or max(self._pp, 1)
        B = xv.shape[0]
        if B % M:
            raise ValueError(f"batch {B} must divide into {M} microbatches")
        xs = xv.reshape((M, B // M) + tuple(xv.shape[1:]))
        if M not in self._pipelines:
            self._pipelines[M] = pipeline_spmd(
                self._stage_fn, self.mesh, self._pp, M,
                remat_stages=self.remat_stages)
        ys = self._pipelines[M](dict(self.named_parameters()), xs)
        return ys.reshape((B,) + tuple(ys.shape[2:]))
