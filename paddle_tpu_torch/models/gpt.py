"""GPT: the decoder-only transformer, as a Layer (a torch.nn.Module).

Port of paddle_tpu/models/gpt.py. Parameter names and layouts are the
JAX package's: a linear weight is [in, out] (Paddle's layout), so
`blocks.{i}.attn.qkv.weight` is [C, 3C] and `lm_head.weight` is [C, V].
A parameter dict therefore moves between the packages unchanged
(`GPT.load_jax_params`, no transposes).

The forward is the full-sequence causal forward of training: attention
goes through nn.functional.scaled_dot_product_attention, which routes to
flash kernel K1 (heads-major, any ported head dim) or, at head dim 64,
to the packed-pair kernel K2 (`sliced_qkv(pack_pairs=True)`), and
`GPT.loss` / `gpt_loss_fn` add the fused hard-label cross-entropy.
Serving runs the functional decode of models/generation.py over the
same parameters.

Activation recompute takes every `use_recompute` value of the JAX GPT
(paddle_tpu/models/gpt.py:45-52): True recomputes each block inside
GPTBlock.forward; "none", "full" and "group:k" wrap contiguous groups
of k blocks (1 for "full") in one checkpoint each in GPT.forward;
"auto" resolves through the committed plan (jaxplan.json, read as data
by analysis/jaxplan.py). The checkpoint is distributed.fleet.utils.
recompute, which replays the port's dropout draws and casts, so a
recomputed forward is bitwise the first.

Mixture-of-experts (moe_experts > 0): every moe_every-th block (those
with layer_idx % moe_every == moe_every - 1) takes a distributed.moe.
MoEMLP in place of the dense MLP, and GPT.loss adds moe_aux_weight
times each MoE block's load-balance loss; under recompute the aux
losses ride the checkpointed function's return and are put back on
their layers (paddle_tpu/models/gpt.py:221-229, 320-353).

Tensor parallelism: built under a global mesh with tp > 1, each block
holds num_heads / tp heads (the fused qkv's columns hold each rank's
heads of q, of k and of v) and the MLP's inner slice; the token
embedding and the head are split over the vocabulary (the head's
logits all-gathered). Weights are drawn whole from the seed and cut, so
every tp degree starts from the same model.

Sequence parallelism: under a global mesh with sp > 1 each sequence is
split over the sp group (ShardedTrainStep's shard_batch gives rank i
positions [i T/sp, (i+1) T/sp) of every row, and the model takes wpe at
those positions). Attention then needs the keys before the chunk:
- with context_parallel, attention is parallel/ring_attention.py's ring
  over the sp group (paddle_tpu/models/gpt.py:155-198), and attention
  dropout under it raises, as in the JAX package;
- without it, each rank all-gathers K and V over sp and attends, under
  the causal mask, to keys [0, (i+1) T/sp): one full block over the
  earlier chunks and one causal block over its own (two launches of K1
  on the card, merged by their logsumexps as the ring's hops are, so K1
  only ever sees Tq = Tk on its diagonal); the all-gather's backward
  reduce-scatters the K and V gradients.
`sequence_parallel` alone names a layout in the JAX package and changes
no result; the port accepts it. Each rank's loss is the mean over its
tokens, so the mean over the ranks is the sequence's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..analysis import jaxplan
from ..core.place import DeviceLike, default_device
from ..core.tensor import plain
from ..distributed.fleet.utils import recompute
from ..distributed.moe import MoEMLP
from ..distributed.tp_layers import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding, _FusedQKVLinear,
                                     copy_to_tp, tp_degree)
from ..nn import functional as F
from ..nn.layer import Dropout, Embedding, LayerList, LayerNorm
from ..nn.layer.layers import Layer, load_jax_state
from ..ops.kernels import packed_flash
from ..ops.kernels.flash_attention import (flash_attention_bwd,
                                           flash_attention_fwd)
from ..parallel.api import local_piece
from ..parallel.ring_attention import merge, ring_attention
from ..static.program import ParamVariable, set_initial_value

__all__ = ["GPTConfig", "GPT", "GPTAttention", "sliced_qkv", "gpt_loss_fn"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_mult: int = 4
    dropout: float = 0.0
    use_recompute: object = False
    sequence_parallel: bool = False
    context_parallel: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @staticmethod
    def gpt3_1p3b():
        return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                         num_heads=16, max_seq_len=2048)

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=64)

    @property
    def geom(self):
        """(num_layers, num_heads, head_dim, max_seq_len): the static
        geometry tuple models/generation.py and the engine take."""
        return (self.num_layers, self.num_heads,
                self.hidden_size // self.num_heads, self.max_seq_len)


def sliced_qkv(x, qkv_layer, num_heads: int, head_dim: int,
               pack_pairs: bool = False):
    """q/k/v from a fused qkv projection as three linears against slices
    of its weight (paddle_tpu/models/gpt.py:85-126, the tp == 1 path).
    Each comes back as a strided view: heads-major [B, H, T, D], or with
    pack_pairs [B, H/2, T, 2D] (adjacent head pairs merged, K2's
    layout). The flash kernels read these views in place."""
    B, T = x.shape[0], x.shape[1]
    HD = num_heads * head_dim
    w, bias = qkv_layer.weight, qkv_layer.bias
    out = []
    for i in range(3):
        o = F.linear(x, w[:, i * HD:(i + 1) * HD],
                     bias[i * HD:(i + 1) * HD])
        if pack_pairs:
            o = o.reshape(B, T, num_heads // 2, 2 * head_dim)
        else:
            o = o.reshape(B, T, num_heads, head_dim)
        out.append(o.transpose(1, 2))
    return out


class GPTAttention(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        tp = self._tp = tp_degree()
        if cfg.num_heads % tp:
            raise ValueError(f"num_heads {cfg.num_heads} does not split "
                             f"over tp={tp}")
        self.num_heads = cfg.num_heads // tp   # this rank's heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = _FusedQKVLinear(cfg.hidden_size, 3 * cfg.hidden_size,
                                      gather_output=False)
        self.out = RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                     input_is_parallel=True)

    def _pack_gate(self, T: int) -> bool:
        return packed_flash.route_gate(
            self.head_dim, self.num_heads, T, T,
            dropout_active=self.cfg.dropout > 0.0 and self.training)

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        if _sp_size() > 1:
            q, k, v = sliced_qkv(copy_to_tp(x, self._tp), self.qkv,
                                 self.num_heads, self.head_dim)
            out = self._sequence_parallel(q, k, v)
            return self.out(out.transpose(1, 2).reshape(B, T, -1))
        pack = self._pack_gate(T)
        q, k, v = sliced_qkv(copy_to_tp(x, self._tp), self.qkv, self.num_heads,
                             self.head_dim,
                             pack_pairs=pack)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.cfg.dropout,
            training=self.training, _heads_major=True, _packed_pairs=pack)
        # [B, H, T, D] or packed [B, H/2, T, 2D] -> [B, T, C], heads in
        # natural order either way
        return self.out(out.transpose(1, 2).reshape(B, T, -1))


    def _sequence_parallel(self, q, k, v):
        """Attention of this rank's chunk of the sequence (module
        docstring): the ring with context_parallel, else the all-gathered
        keys."""
        if self.cfg.dropout > 0.0 and self.training:
            raise NotImplementedError(
                "attention dropout under sequence or context parallelism "
                "is not implemented (per-chunk RNG across the sp ranks); "
                "set dropout=0.0 or run with sp=1")
        if self.cfg.context_parallel:
            return ring_attention(q, k, v, "sp", causal=True)
        from ..parallel.mesh import get_global_mesh
        mesh = get_global_mesh()
        return _GatheredAttention.apply(
            q, k, v, mesh.group("sp"), mesh.shape["sp"], mesh.coord("sp"),
            1.0 / math.sqrt(q.shape[-1]))


class _GatheredAttention(torch.autograd.Function):
    """Causal attention of rank i's sequence chunk over the keys of the
    sp group, all-gathered (module docstring); the backward
    reduce-scatters the keys' gradients home."""

    @staticmethod
    def forward(ctx, q, k, v, pg, n, i, scale):
        from ..distributed import collective as C
        B, H, tl, D = k.shape
        kv = torch.stack([k, v])
        parts = torch.empty((n,) + tuple(kv.shape), dtype=kv.dtype,
                            device=kv.device)
        C._all_gather(parts, kv, pg)
        prefix = parts[:i].permute(1, 2, 3, 0, 4, 5).reshape(
            2, B, H, i * tl, D)
        acc = None
        if i:
            acc = merge(acc, *flash_attention_fwd(q, prefix[0], prefix[1],
                                                  False, scale))
        acc = merge(acc, *flash_attention_fwd(q, k, v, True, scale))
        o, lse = acc[0].to(q.dtype), acc[1].contiguous()
        ctx.save_for_backward(q, k, v, prefix, o, lse)
        ctx.sp = (pg, n, i, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        from ..distributed import collective as C
        q, k, v, prefix, o, lse = ctx.saved_tensors
        pg, n, i, scale = ctx.sp
        B, H, tl, D = k.shape
        do = do.contiguous()
        # [chunk, k|v, B, H, T/sp, D]: chunk c's gradients go to rank c
        dkv = torch.zeros((n, 2, B, H, tl, D), dtype=torch.float32,
                          device=q.device)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, True, scale)
        dq = dq.float()
        dkv[i, 0] += dk.float()
        dkv[i, 1] += dv.float()
        if i:
            gq, gk, gv = flash_attention_bwd(q, prefix[0], prefix[1], o, lse,
                                             do, False, scale)
            dq += gq.float()
            dkv[:i, 0] += gk.float().reshape(B, H, i, tl, D).movedim(2, 0)
            dkv[:i, 1] += gv.float().reshape(B, H, i, tl, D).movedim(2, 0)
        mine = torch.empty(dkv.shape[1:], dtype=torch.float32,
                           device=q.device)
        C._reduce_scatter(mine, dkv, C.ReduceOp.SUM, pg)
        return (dq.to(q.dtype), mine[0].to(k.dtype), mine[1].to(v.dtype),
                None, None, None, None)


def _sp_size() -> int:
    from ..parallel.mesh import get_global_mesh
    mesh = get_global_mesh()
    return 1 if mesh is None else mesh.shape["sp"]


class GPTMLP(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        inner = cfg.ffn_mult * cfg.hidden_size
        self.up = ColumnParallelLinear(cfg.hidden_size, inner,
                                       gather_output=False)
        self.down = RowParallelLinear(inner, cfg.hidden_size,
                                      input_is_parallel=True)

    def forward(self, x):
        return self.down(F.gelu(self.up(x), approximate=True))


class GPTBlock(Layer):
    """layer_idx names the block's place in the stack: with moe_experts,
    the blocks at layer_idx % moe_every == moe_every - 1 are MoE."""

    def __init__(self, cfg: GPTConfig, layer_idx: int = 0):
        super().__init__()
        self.cfg = cfg
        self.layer_idx = layer_idx
        self.ln1 = LayerNorm(cfg.hidden_size)
        self.attn = GPTAttention(cfg)
        self.ln2 = LayerNorm(cfg.hidden_size)
        every = max(cfg.moe_every, 1)
        if cfg.moe_experts > 0 and layer_idx % every == every - 1:
            self.mlp = MoEMLP(cfg.hidden_size, cfg.moe_experts,
                              ffn_hidden_size=cfg.ffn_mult * cfg.hidden_size,
                              top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor)
        else:
            self.mlp = GPTMLP(cfg)

    def _body(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))

    def forward(self, x):
        # `is True` on purpose: the planned policies ("auto", "full",
        # "group:k", truthy strings) are applied by GPT.forward's block
        # loop; only the boolean recomputes here, one block at a time
        if self.cfg.use_recompute is True:
            return _recompute_blocks([self], x)
        return self._body(x)


def _resolve_remat_group(cfg: GPTConfig) -> int:
    """cfg.use_recompute as GPT.forward's checkpoint group size (0: no
    GPT-level recompute; booleans give 0, True recomputing inside each
    GPTBlock). "auto" reads the committed plan (paddle_tpu/models/
    gpt.py:244-257)."""
    pol = cfg.use_recompute
    if pol is True or pol is False or pol is None:
        return 0
    if isinstance(pol, str):
        if pol == "auto":
            pol = jaxplan.committed_remat_policy()
        return jaxplan.remat_group_size(pol, cfg.num_layers)
    raise ValueError(
        f"use_recompute must be a bool, 'auto', 'none', 'full' or "
        f"'group:<k>', got {pol!r}")


class GPT(Layer):
    """GPT over an explicit device. Weights are drawn on the CPU from
    `seed` (normal(0, 0.02) token embedding, normal(0, 1) position
    embedding, Xavier-uniform linears, zero biases, unit LayerNorms, the
    JAX package's initializer families) and copied into layers built on
    `device`, so one seed gives the same model on the CPU and the GPU."""

    def __init__(self, cfg: Optional[GPTConfig] = None,
                 device: DeviceLike = None, seed: int = 0, **kwargs):
        super().__init__()
        cfg = cfg or GPTConfig(**kwargs)
        _check_supported(cfg)
        self.cfg = cfg
        with default_device(device):
            self.wte = VocabParallelEmbedding(cfg.vocab_size,
                                              cfg.hidden_size)
            self.wpe = Embedding(cfg.max_seq_len, cfg.hidden_size)
            self.drop = Dropout(cfg.dropout)
            self.blocks = LayerList([GPTBlock(cfg, layer_idx=i)
                                     for i in range(cfg.num_layers)])
            self.ln_f = LayerNorm(cfg.hidden_size)
            self.lm_head = ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, has_bias=False)
        _resolve_remat_group(cfg)  # a value the JAX GPT refuses raises here
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            # drawn whole on the CPU whatever device the layers were
            # built on, then cut to this rank's piece (tp / ep)
            draw = torch.empty(tuple(getattr(p, "_whole_shape", p.shape)),
                               device="cpu")
            last = name.rsplit(".", 1)[-1]
            if name == "wte.weight" or last in ("router", "w_up", "w_down"):
                draw.normal_(0.0, 0.02, generator=g)
            elif name == "wpe.weight":
                draw.normal_(0.0, 1.0, generator=g)
            elif name.endswith(".weight") and p.ndim == 2:
                lim = math.sqrt(6.0 / (draw.shape[0] + draw.shape[1]))
                draw.uniform_(-lim, lim, generator=g)
            elif "ln" in name and name.endswith(".weight"):
                draw.fill_(1.0)
            else:
                draw.zero_()
            if isinstance(p, ParamVariable):
                # built in static mode: the startup program gives it
                set_initial_value(p, draw)
                continue
            p.copy_(local_piece(draw, p))

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def _remat_group(self) -> int:
        """GPT.forward's checkpoint group size (0: none at this level),
        read from cfg.use_recompute at each call (jaxplan caches the
        committed plan), so a new value applies to a built model."""
        return _resolve_remat_group(self.cfg)

    def forward(self, input_ids):
        ids = torch.as_tensor(input_ids, device=self.device).long()
        T = ids.shape[1]
        # under sequence parallelism this rank holds chunk sp-coord of
        # every row
        start = 0
        if _sp_size() > 1:
            from ..parallel.mesh import get_global_mesh
            start = get_global_mesh().coord("sp") * T
        pos = torch.arange(start, start + T, device=self.device)[None]
        x = self.drop(self.wte(ids) + self.wpe(pos))
        g = self._remat_group
        if g:
            blocks = list(self.blocks)
            for s in range(0, len(blocks), g):
                x = _recompute_blocks(blocks[s:s + g], x)
        else:
            for blk in self.blocks:
                x = blk(x)
        return self.lm_head(self.ln_f(x))

    def loss(self, input_ids, labels):
        """Mean hard-label cross-entropy of the next-token logits, plus
        moe_aux_weight times each MoE block's load-balance loss."""
        logits = self(input_ids)
        labels = torch.as_tensor(plain(labels), device=self.device)
        loss = F.cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                               labels.reshape(-1))
        if self.cfg.moe_experts > 0 and self.cfg.moe_aux_weight > 0:
            for blk in self.blocks:
                if isinstance(blk.mlp, MoEMLP) and \
                        blk.mlp.aux_loss is not None:
                    loss = loss + self.cfg.moe_aux_weight * blk.mlp.aux_loss
        return loss

    @classmethod
    def load_jax_params(cls, cfg: GPTConfig, params: Dict[str, np.ndarray],
                        device: DeviceLike = None) -> "GPT":
        """A GPT holding the JAX package's weights: `params` is the numpy
        form of paddle_tpu.models.generation.extract_params(model). Names
        and shapes must match exactly (same layouts, no transposes)."""
        return load_jax_state(cls(cfg, device=device), params)


def _recompute_blocks(group, x):
    """`group`'s blocks in turn as one checkpointed segment. The MoE
    blocks' aux losses ride the segment's return and are put back on
    their layers afterwards (paddle_tpu/models/gpt.py:320-340)."""
    moe = [b.mlp for b in group if isinstance(b.mlp, MoEMLP)]

    def segment(x_):
        for b in group:
            x_ = b._body(x_)
        return (x_, *[m.aux_loss for m in moe])

    out, *auxes = recompute(segment, x)
    for m, aux in zip(moe, auxes):
        m.aux_loss = aux
    return out


def gpt_loss_fn(model, input_ids, labels):
    """loss_fn signature for jit.TrainStep."""
    return model.loss(input_ids, labels)


def _check_supported(cfg: GPTConfig) -> None:
    if cfg.hidden_size % cfg.num_heads:
        raise ValueError(f"hidden_size {cfg.hidden_size} is not divisible "
                         f"by num_heads {cfg.num_heads}")
