"""Autoregressive generation with a KV cache for models.gpt.GPT.

Port of paddle_tpu/models/generation.py. The JAX package composes its
decode from jitted sub-programs over a flat parameter dict; the port
keeps the same functional decomposition (the serving path in
inference/serving/attention.py reuses `_token_embed`, `_decode_qkv`,
`_attn_merge`, `_decode_attn` and `_decode_head` verbatim) and runs it
eagerly. Matrix products stay `torch.matmul`, as XLA owned them in JAX.

Differences from the JAX package, all deliberate:
- the dense cache is updated IN PLACE (`_cache_write` writes the new
  token's K/V into the [B, H, S, D] buffers at a 0-d position tensor
  with index_copy_; JAX returned new buffers);
- `geom` is the same static (num_layers, num_heads, head_dim,
  max_seq_len) tuple, and every tensor lives on the parameters' device.

- sampling draws Gumbel noise from a counter-based integer hash of
  (seed, row, step, vocab index) where JAX used jax.random.categorical
  with threefry keys: the same call samples the same tokens on the CPU
  and the GPU, but not the JAX package's tokens. The filter before the
  draw (temperature, top-k, top-p) is the reference's
  (`_sample_filter`); the serving chunk samples through the same
  `_sample_rows`.

export_decoder writes the decode pair as torch.export programs
(`<prefix>.prefill.pdmodel` at prompt length S // 2, batch symbolic;
`<prefix>.decode.pdmodel`, decode_step over the dense f32 cache
[b, H, S, D], a token [b] and a 0-d position, its in-place cache write
recorded as an input mutation), the parameters once in
`<prefix>.pdiparams` (torch.save, read back with weights_only) and the
geometry in `<prefix>.pdmeta` (JSON), where the JAX package bakes the
parameters into both StableHLO programs. DecoderPredictor serves them
without the model class: greedy tokens stay on the device (argmax fed
to the next decode) and are fetched once at the end.

Left out: nothing of the JAX module.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.tensor import plain

__all__ = ["extract_params", "prefill", "decode_step", "generate",
           "beam_search_generate", "export_decoder", "DecoderPredictor"]

NEG_INF = -1e30

Params = Dict[str, torch.Tensor]
Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def extract_params(model) -> Params:
    """GPT module -> flat {name: tensor} dict for the decode functions
    (detached views of the live parameters, same names as the JAX
    package's extract_params)."""
    return {k: plain(p).detach() for k, p in model.named_parameters()}


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


def _cache_write(kc, vc, k_new, v_new, pos) -> None:
    """Write the new token's K/V [B, H, 1, D] at position pos (a 0-d
    int64 tensor on the cache's device) of the dense [B, H, S, D] cache,
    in place (no host read of pos: an exported decode records it as an
    input mutation)."""
    kc.index_copy_(2, pos.reshape(1), k_new)
    vc.index_copy_(2, pos.reshape(1), v_new)


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
def decode_step(params: Params, cache: Cache, token, pos, geom):
    """One cached decode step: token [B] at scalar position pos (an int
    or a 0-d tensor). Updates `cache` in place and returns (logits
    [B, V], cache)."""
    dev = params["wte.weight"].device
    token = torch.as_tensor(token, device=dev).long()
    if not torch.is_tensor(pos):   # a fill on the device, no host copy
        pos = torch.full((), int(pos), dtype=torch.long, device=dev)
    pos = pos.to(device=dev, dtype=torch.long)
    positions = pos.expand(token.shape)
    x = _token_embed(params, token, positions)
    for i, (kc, vc) in enumerate(cache):
        qkv = _decode_qkv(params, i, x, geom)
        _cache_write(kc, vc, qkv[1], qkv[2], pos)
        x = _decode_attn(params, i, x, qkv[0], kc, vc, positions, geom)
    return _decode_head(params, x), cache


_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 tensors a in [0, 2**32) and a 32-bit
    constant c, without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x):
    """murmur3's 32-bit finalizer on int64 tensors in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _uniform(seeds, counts, vocab: int):
    """Counter-based uniforms in (0, 1), [N, vocab]: a pure function of
    (seed, tokens generated, vocab index), identical on every device."""
    row = _fmix32(_mul32(seeds.long() & _M32, 0x9E3779B1)
                  ^ (counts.long() & _M32))
    v = torch.arange(vocab, device=seeds.device, dtype=torch.long)
    x = _fmix32(row[:, None] ^ _mul32(v + 1, 0x27D4EB2F)[None])
    return ((x >> 8).to(torch.float32) + 0.5) * (1.0 / 16777216.0)


def _row_keys(seed: int, rows: int, device):
    """Per-row draw keys of one generate() call: a hash of (seed, row)."""
    r = torch.arange(rows, device=device, dtype=torch.long)
    return _fmix32(_mul32(r + 1, 0x85EBCA77) ^ (int(seed) & _M32))


def _sample_filter(logits, temps, top_ks, top_ps):
    """The reference's sampling filter (`_sampling_rollout`'s sample),
    per row: logits / temperature in f32 (temps <= 0 rows divide by 1),
    then every logit under the row's top_k-th largest (top_k 0: none)
    and, for 0 < top_p < 1, under the smallest rank prefix whose
    exclusive cumulative mass stays below top_p (rank 0 always kept,
    ties kept) set to -1e30; top_p >= 1 skips the nucleus step. [N, V]
    -> [N, V] f32."""
    vocab = logits.shape[-1]
    lg = logits.float() / torch.where(temps > 0, temps,
                                      torch.ones_like(temps))[:, None]
    srt = torch.sort(lg, dim=-1, descending=True).values
    kth = srt.gather(1, (top_ks.long() - 1).clamp(0, vocab - 1)[:, None])
    lg = lg.masked_fill((top_ks[:, None] > 0) & (lg < kth), NEG_INF)
    srt = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    excl = torch.cumsum(probs, dim=-1) - probs
    n_keep = (excl < top_ps[:, None]).sum(dim=-1)
    pth = srt.gather(1, (n_keep - 1).clamp(0, vocab - 1)[:, None])
    use_p = (top_ps > 0.0) & (top_ps < 1.0)
    return lg.masked_fill(use_p[:, None] & (lg < pth), NEG_INF)


def _sample_rows(logits, seeds, counts, temps, top_ks, top_ps):
    """Branchless per-row sampling over [N, V] logits: greedy argmax when
    temp <= 0, else a Gumbel-max draw over `_sample_filter`'s logits with
    `_uniform` noise keyed by (seed, count). Returns int32 [N]. The
    serving chunk and generate() both sample here."""
    greedy = torch.argmax(logits, dim=-1)
    lg = _sample_filter(logits, temps, top_ks, top_ps)
    gumbel = -torch.log(-torch.log(_uniform(seeds, counts,
                                            logits.shape[-1])))
    sampled = torch.argmax(lg + gumbel, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """Autoregressive decoding over the dense KV cache: greedy at
    temperature <= 0 (top_k, top_p and seed then have no effect), else
    temperature sampling with the reference's top-k / top-p filter
    (`_sample_filter`; top_p=None or 1.0 drops the nucleus step) and
    the port's counter-based draws (module docstring). Once a row emits
    eos it emits eos for every later position. input_ids: [B, T]
    array-like; returns np.ndarray [B, T + max_new_tokens]."""
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
    keys = _row_keys(seed, B, dev)

    def per_row(value, dtype):
        return torch.full((B,), value, dtype=dtype, device=dev)

    knobs = (per_row(temperature, torch.float32),
             per_row(int(top_k) if top_k else 0, torch.int32),
             per_row(1.0 if top_p is None else top_p, torch.float32))
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    toks = []
    for step in range(max_new_tokens):
        tok = _sample_rows(logits, keys, per_row(step, torch.long),
                           *knobs).long()
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


@torch.no_grad()
def beam_search_generate(model, input_ids, beam_size: int,
                         max_new_tokens: int, length_penalty: float = 0.0,
                         eos_token_id: Optional[int] = None):
    """Beam search over the KV cache, the reference's `_beam_rollout`:
    the beams live as an expanded batch [B*K], each step scores every
    (beam, token) by cumulative log-probability, keeps the top K per
    row (ties to the lower flat index, as lax.top_k), re-gathers the
    cache to the surviving parents and backtracks the (parent, token)
    lattice at the end. Finished beams (eos emitted) may only extend by
    eos at zero cost and stop accruing length; length_penalty divides
    each hypothesis' score by its own length ** length_penalty.
    Returns (sequences [B, T + max_new_tokens], scores [B]) for the best
    beam per row."""
    cfg = model.cfg
    geom = cfg.geom
    params = extract_params(model)
    ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                     else input_ids)
    B, T = ids.shape
    K, V = int(beam_size), cfg.vocab_size
    if T + max_new_tokens > cfg.max_seq_len:
        raise ValueError("beam search exceeds max_seq_len")
    eos = -1 if eos_token_id is None else int(eos_token_id)
    expanded = np.repeat(ids, K, axis=0)              # [B*K, T]
    logits, cache = prefill(params, torch.as_tensor(expanded,
                                                    dtype=torch.int32), geom)
    dev = logits.device
    # only beam 0 is live at step 0 (all beams hold the same prompt)
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.full((B, K), float(T), dtype=torch.float32, device=dev)
    brow = torch.arange(B, device=dev)[:, None]
    only_eos = None
    if eos >= 0:
        only_eos = torch.full((V,), float("-inf"), device=dev)
        only_eos[eos] = 0.0
    parents, tokens = [], []
    for step in range(max_new_tokens):
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        if only_eos is not None:
            logp = torch.where(finished[..., None], only_eos, logp)
        flat = (scores[..., None] + logp).reshape(B, K * V)
        top_scores, top_idx = _top_k(flat, K)
        parent = top_idx // V
        token = top_idx % V
        was_finished = finished[brow, parent]
        lengths = lengths[brow, parent] + (~was_finished).float()
        finished = was_finished | (token == eos) if eos >= 0 \
            else was_finished
        gidx = (brow * K + parent).reshape(-1)
        cache = [(k[gidx], v[gidx]) for k, v in cache]
        scores = top_scores
        parents.append(parent)
        tokens.append(token)
        if step + 1 < max_new_tokens:
            logits, cache = decode_step(params, cache, token.reshape(-1),
                                        T + step, geom)
    scores = scores.cpu().numpy()
    lengths = lengths.cpu().numpy()
    parents = torch.stack(parents).cpu().numpy()      # [steps, B, K]
    tokens = torch.stack(tokens).cpu().numpy()
    if length_penalty:
        scores = scores / (lengths ** length_penalty)
    best = scores.argmax(axis=1)
    out = np.zeros((B, max_new_tokens), np.int64)
    for b in range(B):
        k = best[b]
        for s in range(max_new_tokens - 1, -1, -1):
            out[b, s] = tokens[s, b, k]
            k = parents[s, b, k]
    return (np.concatenate([ids.astype(np.int64), out], axis=1),
            scores[np.arange(B), best])


class _PrefillCall(torch.nn.Module):
    """prefill over (params, ids): what export_decoder exports."""

    def __init__(self, geom):
        super().__init__()
        self.geom = geom

    def forward(self, params, ids):
        return prefill(params, ids, self.geom)


class _DecodeCall(torch.nn.Module):
    """decode_step over (params, cache, token, pos) -> logits, the cache
    written in place."""

    def __init__(self, geom):
        super().__init__()
        self.geom = geom

    def forward(self, params, cache, token, pos):
        return decode_step(params, cache, token, pos, self.geom)[0]


def export_decoder(model, path_prefix: str):
    """Serialize the decode pair (module docstring) so a server can run
    greedy generation without the model class: the analogue of
    save_inference_model for LLM serving (paddle_tpu/models/
    generation.py:409-460). Writes <prefix>.prefill.pdmodel,
    <prefix>.decode.pdmodel, <prefix>.pdiparams and <prefix>.pdmeta."""
    import json
    import os
    cfg = model.cfg
    geom = (cfg.num_layers, cfg.num_heads,
            cfg.hidden_size // cfg.num_heads, cfg.max_seq_len)
    L, H, D, S = geom
    params = extract_params(model)
    dev = params["wte.weight"].device
    # symbolic batch, one prompt length (S // 2 by convention) for the
    # prefill; the decode does not depend on the length. Example batch 2:
    # torch.export specialises a dim whose example is 0 or 1
    Tp = S // 2
    b = torch.export.Dim("b", min=1)
    pspec = {k: None for k in params}
    ids = torch.zeros(2, Tp, dtype=torch.int32, device=dev)
    cache = [tuple(torch.zeros(2, H, S, D, device=dev) for _ in range(2))
             for _ in range(L)]
    tok = torch.zeros(2, dtype=torch.int32, device=dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.no_grad():
        ex_prefill = torch.export.export(
            _PrefillCall(geom), (params, ids),
            dynamic_shapes=(pspec, {0: b}), strict=False)
        ex_decode = torch.export.export(
            _DecodeCall(geom), (params, cache, tok, pos),
            dynamic_shapes=(pspec, [({0: b}, {0: b})] * L, {0: b}, None),
            strict=False)
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    for ex, name in ((ex_prefill, "prefill"), (ex_decode, "decode")):
        ex.example_inputs = None  # the weights go to .pdiparams once
        with open(f"{path_prefix}.{name}.pdmodel", "wb") as f:
            torch.export.save(ex, f)
    torch.save({k: v.cpu() for k, v in params.items()},
               path_prefix + ".pdiparams")
    with open(path_prefix + ".pdmeta", "w") as f:
        # JSON, not pickle: serving artifacts may come from third parties
        # and must not be able to execute code at load
        json.dump({"geom": list(geom), "prefill_len": Tp,
                   "vocab_size": cfg.vocab_size, "device": str(dev)}, f)


class DecoderPredictor:
    """Serves an export_decoder artifact: greedy generation from the
    exported programs only (no model class), on the device they were
    exported on. Each step's argmax stays on the device and feeds the
    next decode; the tokens are fetched once at the end
    (paddle_tpu/models/generation.py:463-532)."""

    def __init__(self, path_prefix: str):
        import json
        from ..core import place as _place
        with open(path_prefix + ".prefill.pdmodel", "rb") as f:
            self._prefill = torch.export.load(f).module()
        with open(path_prefix + ".decode.pdmodel", "rb") as f:
            self._decode = torch.export.load(f).module()
        with open(path_prefix + ".pdmeta") as f:
            meta = json.load(f)  # JSON: no code execution at load
        self.geom = tuple(meta["geom"])
        self.prefill_len = int(meta["prefill_len"])
        self.vocab_size = int(meta["vocab_size"])
        self.device = _place.resolve_device(meta["device"])
        self._params = torch.load(path_prefix + ".pdiparams",
                                  map_location=self.device,
                                  weights_only=True)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int):
        """Greedy decode. Prompts must be EXACTLY the exported prefill
        length: the fixed-shape prefill has no pad masking, so a shorter
        prompt would attend pad tokens at shifted positions and diverge
        from generate() (serve several lengths with an artifact each)."""
        ids = np.asarray(input_ids)
        B, T = ids.shape
        Tp = self.prefill_len
        if T != Tp:
            raise ValueError(
                f"prompt length {T} != exported prefill length {Tp}; the "
                "fixed-shape prefill has no pad masking — export an "
                "artifact per prompt-length bucket")
        S = self.geom[3]
        if Tp + max_new_tokens > S:
            raise ValueError("generation exceeds max_seq_len")
        logits, cache = self._prefill(self._params, torch.as_tensor(
            ids, dtype=torch.int32).to(self.device))
        pos = torch.full((), Tp, dtype=torch.int32, device=self.device)
        toks = []
        for step in range(max_new_tokens):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
            if step + 1 < max_new_tokens:
                logits = self._decode(self._params, cache, tok, pos)
                pos = pos + 1
        new = torch.stack(toks, dim=1).cpu().numpy() if toks \
            else np.zeros((B, 0), np.int64)
        # one fetch for the whole generation
        return np.concatenate([ids.astype(np.int64), new.astype(np.int64)],
                              axis=1)


def _top_k(x, k: int):
    """The k largest of each row of x [B, N], descending, ties to the
    lower index (lax.top_k's order; torch.topk leaves ties unordered)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True)
    return order.values[:, :k], order.indices[:, :k]
