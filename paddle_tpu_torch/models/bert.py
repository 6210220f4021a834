"""BERT/ERNIE bidirectional encoders with the MLM + NSP pretraining heads,
as torch.nn.Modules.

Port of paddle_tpu/models/bert.py (BASELINE configs 3 and 4: BERT-base
and ERNIE-large pretraining). Parameter names and layouts are the JAX
package's: a linear weight is [in, out], `bert.layers.{i}.attn.qkv.weight`
is [C, 3C], and the MLM decoder is tied to `bert.word_emb.weight` (no
separate V x C matrix), beside a per-vocab `mlm_bias`. A state dict
therefore moves between the packages unchanged (`load_jax_params`, no
transposes).

Attention is non-causal. At head dim 64 with an even head count, no
mask, no active dropout and T at least `flash_attention_min_seq`, the
heads go as packed pairs to kernel K2 (`_pack_gate`, the model-side gate
of ops/kernels/packed_flash.py): ERNIE-large at T 512. Anything else takes
composed attention (BERT-base at T 128 under the default min_seq of 512,
a mask, dropout in training), as in the JAX package, whose flash route
has no mask or dropout either.

Not ported: a tensor-parallel mesh. The parallel linears and the vocab
embedding are plain layers on one device (distributed/tp_layers.py), and
the JAX package's `shard_batch_activation`, the identity without a mesh,
is dropped.
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
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear
from ..nn.layer.layers import load_jax_state
from ..ops.kernels import packed_flash
from .gpt import sliced_qkv

__all__ = ["BertConfig", "Bert", "BertForPretraining",
           "bert_pretrain_loss_fn", "bert_base", "ernie_large",
           "make_bert_pretrain_batch"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position: int = 512
    type_vocab_size: int = 2
    ffn_mult: int = 4
    dropout: float = 0.0
    layer_norm_eps: float = 1e-12


def bert_base():
    return BertConfig()


def ernie_large():
    """ERNIE-large (BASELINE config 4): BERT's architecture at 24 layers,
    hidden 1024, 16 heads, vocab 18000 and 4 token types."""
    return BertConfig(vocab_size=18000, hidden_size=1024, num_layers=24,
                      num_heads=16, max_position=512, type_vocab_size=4)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = ColumnParallelLinear(cfg.hidden_size,
                                        3 * cfg.hidden_size,
                                        gather_output=False)
        self.out = RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                     input_is_parallel=True)

    def _pack_gate(self, T: int, attn_mask) -> bool:
        """Whether the heads go as packed pairs to K2."""
        return packed_flash.route_gate(
            self.head_dim, self.num_heads, T, T,
            dropout_active=self.cfg.dropout > 0.0 and self.training,
            masked=attn_mask is not None)

    def forward(self, x, attn_mask=None):
        B, T = x.shape[0], x.shape[1]
        pack = self._pack_gate(T, attn_mask)
        q, k, v = sliced_qkv(x, self.qkv, self.num_heads, self.head_dim,
                             pack_pairs=pack)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False,
            dropout_p=self.cfg.dropout, training=self.training,
            _heads_major=True, _packed_pairs=pack)
        return self.out(out.transpose(1, 2).reshape(B, T, -1))


class BertLayer(nn.Module):
    """Post-LN encoder block (residual, then LayerNorm), GELU tanh."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attn = BertSelfAttention(cfg)
        self.ln1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        inner = cfg.ffn_mult * cfg.hidden_size
        self.up = ColumnParallelLinear(cfg.hidden_size, inner,
                                       gather_output=False)
        self.down = RowParallelLinear(inner, cfg.hidden_size,
                                      input_is_parallel=True)
        self.ln2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.drop(self.attn(x, attn_mask)))
        h = self.down(F.gelu(self.up(x), approximate=True))
        return self.ln2(x + self.drop(h))


@torch.no_grad()
def _draw(module: nn.Module, seed: int) -> None:
    """The JAX package's initializer families, drawn on the CPU from
    `seed`: the vocab embedding normal(0, 0.02), the other embeddings
    normal(0, 1), linear weights Xavier-normal; biases and LayerNorms
    keep their zeros and ones."""
    g = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith("word_emb.weight"):
            p.normal_(0.0, 0.02, generator=g)
        elif name.endswith("_emb.weight"):
            p.normal_(0.0, 1.0, generator=g)
        elif p.ndim == 2:
            p.normal_(0.0, math.sqrt(2.0 / sum(p.shape)), generator=g)


class _JaxParams:
    @classmethod
    def load_jax_params(cls, cfg: BertConfig, params: Dict[str, np.ndarray],
                        device: DeviceLike = None):
        """A model holding the JAX package's weights: `params` is the
        numpy form of the JAX model's `state_dict()`. Names and shapes
        must match exactly (same layouts, no transposes)."""
        return load_jax_state(cls(cfg, device=device), params)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


class Bert(_JaxParams, nn.Module):
    """Encoder trunk: embeddings, N bidirectional blocks and the pooler,
    over an explicit device. Weights are drawn on the CPU from `seed`
    and then moved, so one seed gives the same model on either device."""

    def __init__(self, cfg: Optional[BertConfig] = None,
                 device: DeviceLike = None, seed: int = 0, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError(f"hidden_size {cfg.hidden_size} is not "
                             f"divisible by num_heads {cfg.num_heads}")
        self.cfg = cfg
        self.word_emb = VocabParallelEmbedding(cfg.vocab_size,
                                               cfg.hidden_size)
        self.pos_emb = Embedding(cfg.max_position, cfg.hidden_size)
        self.type_emb = Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.emb_ln = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.drop = Dropout(cfg.dropout)
        self.layers = nn.ModuleList(BertLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size)
        _draw(self, seed)
        self.to(resolve_device(device))

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        """(sequence output [B, T, C], pooled tanh(pooler(x[:, 0])))."""
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        T = ids.shape[1]
        x = self.word_emb(ids) + self.pos_emb(torch.arange(T, device=dev))
        if token_type_ids is not None:
            x = x + self.type_emb(
                torch.as_tensor(token_type_ids, device=dev).long())
        x = self.drop(self.emb_ln(x))
        if attn_mask is not None:
            attn_mask = torch.as_tensor(attn_mask, device=dev)
        for layer in self.layers:
            x = layer(x, attn_mask)
        return x, F.tanh(self.pooler(x[:, 0]))


class BertForPretraining(_JaxParams, nn.Module):
    """MLM + NSP heads over the trunk. The MLM logits are
    h @ word_emb.weight^T + mlm_bias, tied to the word embedding, whose
    one parameter (and, under O2, one f32 master) takes the gradients of
    both uses."""

    def __init__(self, cfg: Optional[BertConfig] = None,
                 device: DeviceLike = None, seed: int = 0, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        self.cfg = cfg
        self.bert = Bert(cfg, device="cpu", seed=seed)
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size)
        self.mlm_ln = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.nsp = Linear(cfg.hidden_size, 2)
        _draw(self.mlm_transform, seed + 1)
        _draw(self.nsp, seed + 2)
        self.to(resolve_device(device))

    def forward(self, input_ids, token_type_ids=None, attn_mask=None,
                masked_positions=None):
        """(MLM logits, NSP logits [B, 2]). With masked_positions [B, P]
        the MLM head runs only on those rows ([B, P, V] logits, the
        reference's gather before the pretraining heads); without, on
        every position ([B, T, V])."""
        seq, pooled = self.bert(input_ids, token_type_ids, attn_mask)
        if masked_positions is not None:
            idx = torch.as_tensor(masked_positions, device=seq.device).long()
            seq = torch.gather(seq, 1, idx[..., None].expand(
                -1, -1, seq.shape[-1]))
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq), approximate=True))
        logits = torch.matmul(h, self.bert.word_emb.weight.t()) \
            + self.mlm_bias
        return logits, self.nsp(pooled)

    def loss(self, input_ids, token_type_ids, mlm_labels, nsp_labels=None,
             masked_positions=None):
        """Mean MLM cross-entropy over the labels that are not -100, plus
        the NSP cross-entropy when nsp_labels [B] are given. mlm_labels
        are [B, T], or [B, P] aligned with masked_positions."""
        logits, nsp_logits = self(input_ids, token_type_ids,
                                  masked_positions=masked_positions)
        dev = logits.device
        mlm = F.cross_entropy(
            logits.reshape(-1, self.cfg.vocab_size),
            torch.as_tensor(mlm_labels, device=dev).reshape(-1),
            ignore_index=-100)
        if nsp_labels is None:
            return mlm
        return mlm + F.cross_entropy(nsp_logits,
                                     torch.as_tensor(nsp_labels, device=dev))


def bert_pretrain_loss_fn(model, input_ids, token_type_ids, mlm_labels,
                          nsp_labels, masked_positions=None):
    """loss_fn signature for jit.TrainStep."""
    return model.loss(input_ids, token_type_ids, mlm_labels, nsp_labels,
                      masked_positions=masked_positions)


def make_bert_pretrain_batch(rng, vocab_size, bs, seq, mask_rate=0.15):
    """Synthetic MLM + NSP batch, the JAX package's recipe: the same
    numpy calls in the same order, so one RandomState gives the same
    arrays in both packages. Returns numpy (input_ids int32 [bs, seq],
    token_type_ids int32, mlm_labels int64 [bs, P], nsp_labels int64
    [bs], masked_positions int32 [bs, P]); P = round(mask_rate * seq)
    positions a row, drawn without replacement and sorted."""
    x = rng.randint(0, vocab_size, (bs, seq), dtype=np.int32)
    tt = rng.randint(0, 2, (bs, seq), dtype=np.int32)
    P = max(1, int(round(seq * mask_rate)))
    pos = np.stack([rng.choice(seq, P, replace=False) for _ in range(bs)])
    pos.sort(axis=1)
    mlm = rng.randint(0, vocab_size, (bs, P)).astype(np.int64)
    nsp = rng.randint(0, 2, (bs,)).astype(np.int64)
    return x, tt, mlm, nsp, pos.astype(np.int32)
