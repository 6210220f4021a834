"""Autoregressive generation with a KV cache for models.gpt.GPT.

Port of paddle_tpu/models/generation.py. The JAX package composes its
decode from jitted sub-programs over a flat parameter dict; the port
keeps the same functional decomposition (the serving path in
inference/serving/attention.py reuses `_token_embed`, `_decode_qkv`,
`_attn_merge`, `_decode_attn` and `_decode_head` verbatim) and runs it
eagerly. Matrix products stay `torch.matmul`, as XLA owned them in JAX.

Differences from the JAX package, all deliberate:
- the dense cache is updated IN PLACE (`_cache_write` writes the new
  token's K/V into the [B, H, S, D] buffers; JAX returned new buffers);
- `geom` is the same static (num_layers, num_heads, head_dim,
  max_seq_len) tuple, and every tensor lives on the parameters' device.

Sampling `generate`, beam search and export are not ported yet; the
greedy `generate` with `eos_token_id` is.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["extract_params", "prefill", "decode_step", "generate"]

NEG_INF = -1e30

Params = Dict[str, torch.Tensor]
Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def extract_params(model) -> Params:
    """GPT module -> flat {name: tensor} dict for the decode functions
    (detached views of the live parameters, same names as the JAX
    package's extract_params)."""
    return {k: p.detach() for k, p in model.named_parameters()}


def _ln(x, w, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _gelu(x):
    c0 = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c0 * (x + 0.044715 * x ** 3)))


def _qkv_proj(p: Params, i: int, x, geom):
    """ln1 + fused qkv projection -> [3, B, H, t, D]."""
    _, H, D, _ = geom
    pre = f"blocks.{i}."
    h = _ln(x, p[pre + "ln1.weight"], p[pre + "ln1.bias"])
    qkv = h @ p[pre + "attn.qkv.weight"] + p[pre + "attn.qkv.bias"]
    B, t = x.shape[0], x.shape[1]
    return qkv.reshape(B, t, 3, H, D).permute(2, 0, 3, 1, 4)


def _block(p: Params, i: int, x, q, k_cache, v_cache, pos_mask, geom):
    """One pre-LN block over x [B, t, H*D]: attention of q [B, H, t, D]
    against the cache [B, H, S, D], then the MLP. pos_mask True=attend:
    [t, S] shared across the batch or [B, 1, t, S] per sequence."""
    _, H, D, _ = geom
    scores = torch.einsum("bhtd,bhsd->bhts", q, k_cache) \
        * (1.0 / math.sqrt(D))
    mask = pos_mask if pos_mask.ndim == 4 else pos_mask[None, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    att = torch.einsum("bhts,bhsd->bhtd", probs, v_cache)
    return _attn_merge(p, i, x, att, geom)


def _attn_merge(p: Params, i: int, x, att, geom):
    """Post-attention half of _block: heads-major att [B, H, t, D] ->
    out-projection residual, then the MLP. The ragged paged-attention
    kernel replaces only the score/softmax math and reuses this half."""
    _, H, D, _ = geom
    pre = f"blocks.{i}."
    B, t = x.shape[0], x.shape[1]
    att = att.transpose(1, 2).reshape(B, t, H * D)
    x = x + att @ p[pre + "attn.out.weight"] + p[pre + "attn.out.bias"]
    h = _ln(x, p[pre + "ln2.weight"], p[pre + "ln2.bias"])
    h = _gelu(h @ p[pre + "mlp.up.weight"] + p[pre + "mlp.up.bias"])
    return x + h @ p[pre + "mlp.down.weight"] + p[pre + "mlp.down.bias"]


def _embed(p: Params, ids, pos0: int):
    t = ids.shape[1]
    pos = torch.arange(pos0, pos0 + t, device=ids.device)
    return p["wte.weight"][ids.long()] + p["wpe.weight"][pos][None]


@torch.no_grad()
def prefill(params: Params, input_ids, geom):
    """Full forward over the prompt [B, T]; returns (last-position logits
    [B, V], cache: L-list of (k [B, H, max_seq, D], v)) with positions
    past T zero, as the JAX prefill returns them."""
    L, H, D, S = geom
    dev = params["wte.weight"].device
    ids = torch.as_tensor(input_ids, device=dev)
    B, T = ids.shape
    x = _embed(params, ids, 0)
    ar_s = torch.arange(S, device=dev)
    causal = (torch.arange(T, device=dev)[:, None] >= ar_s[None, :]) \
        & (ar_s[None, :] < T)
    cache: Cache = []
    for i in range(L):
        qkv = _qkv_proj(params, i, x, geom)
        kc = x.new_zeros(B, H, S, D)
        vc = x.new_zeros(B, H, S, D)
        kc[:, :, :T] = qkv[1]
        vc[:, :, :T] = qkv[2]
        cache.append((kc, vc))
        x = _block(params, i, x, qkv[0], kc, vc, causal, geom)
    x = _ln(x, params["ln_f.weight"], params["ln_f.bias"])
    return x[:, -1] @ params["lm_head.weight"], cache


def _token_embed(params: Params, tokens, positions):
    """Per-row embedding: tokens [B] at per-sequence positions [B] ->
    [B, 1, C]."""
    return params["wte.weight"][tokens.long()][:, None] \
        + params["wpe.weight"][positions.long()][:, None]


def _decode_qkv(params: Params, i: int, x, geom):
    return _qkv_proj(params, i, x, geom)


def _cache_write(kc, vc, k_new, v_new, pos: int) -> None:
    """Write the new token's K/V [B, H, 1, D] at position pos of the
    dense [B, H, S, D] cache, in place."""
    kc[:, :, pos] = k_new[:, :, 0]
    vc[:, :, pos] = v_new[:, :, 0]


def _decode_attn(params: Params, i: int, x, q, kc, vc, positions, geom):
    """One block over the dense-layout context [B, H, S, D], attending
    row b to positions <= positions[b]."""
    S = kc.shape[2]
    attend = (torch.arange(S, device=kc.device)[None, :]
              <= positions[:, None])[:, None, None, :]
    return _block(params, i, x, q, kc, vc, attend, geom)


def _decode_head(params: Params, x):
    x = _ln(x, params["ln_f.weight"], params["ln_f.bias"])
    return x[:, 0] @ params["lm_head.weight"]


@torch.no_grad()
def decode_step(params: Params, cache: Cache, token, pos: int, geom):
    """One cached decode step: token [B] at scalar position pos. Updates
    `cache` in place and returns (logits [B, V], cache)."""
    dev = params["wte.weight"].device
    token = torch.as_tensor(token, device=dev).long()
    pos = int(pos)
    positions = torch.full_like(token, pos)
    x = _token_embed(params, token, positions)
    for i, (kc, vc) in enumerate(cache):
        qkv = _decode_qkv(params, i, x, geom)
        _cache_write(kc, vc, qkv[1], qkv[2], pos)
        x = _decode_attn(params, i, x, qkv[0], kc, vc, positions, geom)
    return _decode_head(params, x), cache


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """Greedy decoding over the dense KV cache. Once a row emits eos it
    emits eos for every later position (the JAX scan's frozen rows).
    input_ids: [B, T] array-like; returns np.ndarray [B, T + max_new].
    Greedy is the reference's temperature <= 0, where top_k, top_p and
    seed have no effect; sampling (temperature > 0) is not ported yet."""
    if temperature > 0.0:
        raise NotImplementedError(
            f"generate: temperature={temperature!r} (sampling) is not "
            f"ported yet; only greedy (temperature <= 0) is")
    cfg = model.cfg
    geom = cfg.geom
    params = extract_params(model)
    ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                     else input_ids)
    B, T = ids.shape
    if T + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt {T} + new {max_new_tokens} exceeds max_seq_len "
            f"{cfg.max_seq_len}")
    logits, cache = prefill(params, torch.as_tensor(ids, dtype=torch.int32),
                            geom)
    dev = logits.device
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    toks = []
    for step in range(max_new_tokens):
        tok = torch.argmax(logits, dim=-1)
        if eos_token_id is not None:
            tok = torch.where(finished, torch.full_like(tok, eos_token_id),
                              tok)
            finished = finished | (tok == eos_token_id)
        toks.append(tok)
        if step + 1 < max_new_tokens:
            logits, cache = decode_step(params, cache, tok, T + step, geom)
    new = torch.stack(toks, dim=1).cpu().numpy() if toks \
        else np.zeros((B, 0), np.int64)
    return np.concatenate([ids.astype(np.int64), new], axis=1)
