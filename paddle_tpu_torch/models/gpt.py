"""GPT: the decoder-only transformer, as a torch.nn.Module.

Port of paddle_tpu/models/gpt.py. Parameter names and layouts are the
JAX package's: a linear weight is [in, out] (Paddle's layout), so
`blocks.{i}.attn.qkv.weight` is [C, 3C] and `lm_head.weight` is [C, V].
A parameter dict therefore moves between the packages unchanged
(`GPT.load_jax_params`, no transposes).

The forward is the full-sequence causal forward, kept for parity with
the JAX Layer; serving runs the functional decode of
models/generation.py over the same parameters. Tensor/sequence/context
parallelism, MoE and remat are not ported in this slice: their config
fields exist so configs read the same, and setting them raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.place import DeviceLike, resolve_device

__all__ = ["GPTConfig", "GPT"]


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


class Linear(nn.Module):
    """y = x @ weight + bias with weight [in, out] (Paddle's layout)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias \
            else None

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = cfg.dropout

    def forward(self, x):
        B, T, C = x.shape
        qkv = self.qkv(x).reshape(B, T, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # [B, H, T, D]
        scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(self.head_dim))
        causal = torch.ones(T, T, dtype=torch.bool,
                            device=x.device).tril()
        scores = scores.masked_fill(~causal, -1e30)
        probs = F.dropout(torch.softmax(scores, dim=-1), self.dropout,
                          self.training)
        out = (probs @ v).transpose(1, 2).reshape(B, T, C)
        return self.out(out)


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        inner = cfg.ffn_mult * cfg.hidden_size
        self.up = Linear(cfg.hidden_size, inner)
        self.down = Linear(inner, cfg.hidden_size)

    def forward(self, x):
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
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
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size)
        self.drop = nn.Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(GPTBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
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

    @classmethod
    def load_jax_params(cls, cfg: GPTConfig, params: Dict[str, np.ndarray],
                        device: DeviceLike = None) -> "GPT":
        """A GPT holding the JAX package's weights: `params` is the numpy
        form of paddle_tpu.models.generation.extract_params(model). Names
        and shapes must match exactly (same layouts, no transposes)."""
        model = cls(cfg, device=device)
        own = dict(model.named_parameters())
        missing = sorted(set(own) - set(params))
        extra = sorted(set(params) - set(own))
        if missing or extra:
            raise ValueError(f"parameter names differ: missing {missing}, "
                             f"unexpected {extra}")
        with torch.no_grad():
            for name, p in own.items():
                src = np.asarray(params[name])
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{name}: shape {src.shape} != {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(src)))
        return model


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
