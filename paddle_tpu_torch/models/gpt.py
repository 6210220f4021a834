"""GPT: the decoder-only transformer, as a torch.nn.Module.

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
same parameters. Tensor/sequence/context parallelism, MoE and remat are
not ported in this slice: their config fields exist so configs read the
same, and setting them raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..core.place import DeviceLike, resolve_device
from ..distributed.tp_layers import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding)
from ..nn import functional as F
from ..nn.layer import Dropout, Embedding, LayerNorm
from ..nn.layer.layers import load_jax_state
from ..ops.kernels import packed_flash

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


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = ColumnParallelLinear(cfg.hidden_size,
                                        3 * cfg.hidden_size,
                                        gather_output=False)
        self.out = RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                     input_is_parallel=True)

    def _pack_gate(self, T: int) -> bool:
        return packed_flash.route_gate(
            self.head_dim, self.num_heads, T, T,
            dropout_active=self.cfg.dropout > 0.0 and self.training)

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        pack = self._pack_gate(T)
        q, k, v = sliced_qkv(x, self.qkv, self.num_heads, self.head_dim,
                             pack_pairs=pack)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.cfg.dropout,
            training=self.training, _heads_major=True, _packed_pairs=pack)
        # [B, H, T, D] or packed [B, H/2, T, 2D] -> [B, T, C], heads in
        # natural order either way
        return self.out(out.transpose(1, 2).reshape(B, T, -1))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        inner = cfg.ffn_mult * cfg.hidden_size
        self.up = ColumnParallelLinear(cfg.hidden_size, inner,
                                       gather_output=False)
        self.down = RowParallelLinear(inner, cfg.hidden_size,
                                      input_is_parallel=True)

    def forward(self, x):
        return self.down(F.gelu(self.up(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size)
        self.attn = GPTAttention(cfg)
        self.ln2 = LayerNorm(cfg.hidden_size)
        self.mlp = GPTMLP(cfg)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """GPT over an explicit device. Weights are drawn on the CPU from
    `seed` (normal(0, 0.02) token embedding, normal(0, 1) position
    embedding, Xavier-uniform linears, zero biases, unit LayerNorms, the
    JAX package's initializer families) and then moved, so one seed
    gives the same model on the CPU and the GPU."""

    def __init__(self, cfg: Optional[GPTConfig] = None,
                 device: DeviceLike = None, seed: int = 0, **kwargs):
        super().__init__()
        cfg = cfg or GPTConfig(**kwargs)
        _check_supported(cfg)
        self.cfg = cfg
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = Embedding(cfg.max_seq_len, cfg.hidden_size)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(GPTBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size)
        self.lm_head = ColumnParallelLinear(cfg.hidden_size, cfg.vocab_size,
                                            has_bias=False)
        self._init_weights(seed)
        self.to(resolve_device(device))

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name == "wte.weight":
                p.normal_(0.0, 0.02, generator=g)
            elif name == "wpe.weight":
                p.normal_(0.0, 1.0, generator=g)
            elif name.endswith(".weight") and p.ndim == 2:
                lim = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                p.uniform_(-lim, lim, generator=g)
            elif "ln" in name and name.endswith(".weight"):
                p.fill_(1.0)
            else:
                p.zero_()

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, input_ids):
        ids = torch.as_tensor(input_ids, device=self.device).long()
        T = ids.shape[1]
        pos = torch.arange(T, device=self.device)
        x = self.drop(self.wte(ids) + self.wpe(pos)[None])
        for blk in self.blocks:
            x = blk(x)
        return self.lm_head(self.ln_f(x))

    def loss(self, input_ids, labels):
        """Mean hard-label cross-entropy of the next-token logits."""
        logits = self(input_ids)
        labels = torch.as_tensor(labels, device=self.device)
        return F.cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                               labels.reshape(-1))

    @classmethod
    def load_jax_params(cls, cfg: GPTConfig, params: Dict[str, np.ndarray],
                        device: DeviceLike = None) -> "GPT":
        """A GPT holding the JAX package's weights: `params` is the numpy
        form of paddle_tpu.models.generation.extract_params(model). Names
        and shapes must match exactly (same layouts, no transposes)."""
        return load_jax_state(cls(cfg, device=device), params)


def gpt_loss_fn(model, input_ids, labels):
    """loss_fn signature for jit.TrainStep."""
    return model.loss(input_ids, labels)


def _check_supported(cfg: GPTConfig) -> None:
    if cfg.hidden_size % cfg.num_heads:
        raise ValueError(f"hidden_size {cfg.hidden_size} is not divisible "
                         f"by num_heads {cfg.num_heads}")
    unported = {"use_recompute": cfg.use_recompute not in (False, None,
                                                           "none"),
                "sequence_parallel": cfg.sequence_parallel,
                "context_parallel": cfg.context_parallel,
                "moe_experts": cfg.moe_experts > 0}
    bad = [k for k, on in unported.items() if on]
    if bad:
        raise NotImplementedError(
            f"GPTConfig {bad}: not ported yet (later slice)")
