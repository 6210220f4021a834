"""Transformer-base and the medium LSTM language model, built from nn
layers only and trained through the Paddle eager surface on the GPU.

    python -m paddle_tpu_torch.tools.seq2seq_bench
        [--model transformer|lstm] [--steps N] [--warmup N] [--seed N]
        [--profile]

transformer: Vaswani et al. 2017, "Attention Is All You Need", Table 3,
row "base": 6 + 6 layers, d_model 512, d_ff 2048, 8 heads of 64,
dropout 0.1 on the residual and feed-forward paths (attn_dropout 0),
post-norm, a shared vocabulary of 37000 (the paper's WMT'14 en-de BPE).
One Embedding, scaled by sqrt(512) and added to sinusoidal positions,
feeds both stacks of nn.Transformer, and the output projection is tied
to it. The loss is cross_entropy(soft_label=True) against
label_smooth(one_hot(y, 37000), epsilon=0.1); Adam(beta1 0.9, beta2
0.98, epsilon 1e-9) over NoamDecay(d_model=512, warmup_steps=4000) with
ClipGradByGlobalNorm(1.0); float32 parameters, auto_cast(level="O1")
bf16 around the loss, then loss.backward(), opt.step(),
opt.clear_grad(), sched.step(). The traffic is one batch of 32 packed
pairs of 512 source and 512 target tokens drawn from --seed (no
padding, so no source mask; the decoder's causal mask from
generate_square_subsequent_mask), the same batch every step. Cuts: the
paper's batches held about 25k source plus 25k target tokens over 8
GPUs, this one 16384 a side on one card; the schedule starts at step
4000 (its peak, 6.99e-4), as a run past warm-up would, because from
step 0 (learning rate 0, then 1.7e-7 a step) a few steps move the loss
less than dropout's noise does; the corpus is synthetic ids (no WMT
data in the repository). The encoder's self-attention and the
decoder's cross-attention (no mask, T 512, head dim 64) take flash
kernel K1 non-causal; the decoder's masked self-attention takes
composed attention.

lstm: Zaremba et al. 2014, "Recurrent Neural Network Regularization",
section 4, the "medium" network: 2 LSTM layers of 650, vocabulary 10000
(PTB), 35 unrolled steps, batch 20, dropout 0.5 on the non-recurrent
connections, every weight U(-0.05, 0.05), SGD(1.0) with
ClipGradByGlobalNorm(5.0) on the loss summed over the 35 steps and
averaged over the batch. Synthetic tokens from --seed stand in for PTB
(not in the repository); every step starts from zero states. Then
BeamSearchDecoder(cell, start, end, beam_size=4) over the trained
LSTMCells stacked, with the model's embedding and output layer, under
dynamic_decode(max_step_num=20), from the states the LSTM reaches over
8 of the batch's rows.

Both print one JSON line: losses, step times (host clock around each
step, which ends in the loss's fetch), tokens/s over the timed steps,
MFU (transformer: `transformer_flops` over the H100 SXM dense bf16
peak, 989 TFLOP/s) and peak device memory; lstm also the beam's ids.
transformer --profile adds a torch.profiler breakdown of 3 more steps
(train_bench.profile_steps).
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.core.place import default_device
from paddle_tpu_torch.nn import functional as F

__all__ = ["TRANSFORMER", "TRANSFORMER_BATCH", "LSTM_LM",
           "sinusoid_table", "TransformerBase", "transformer_flops",
           "transformer_loss", "build_transformer", "transformer_step",
           "run_transformer", "greedy_decode", "LSTMLM", "StackedCells",
           "lstm_loss", "build_lstm", "lstm_step", "run_lstm",
           "beam_search"]

BF16_PEAK = 989e12
# Vaswani et al. 2017, Table 3 "base"
TRANSFORMER = dict(vocab=37000, d_model=512, nhead=8, layers=6, d_ff=2048,
                   dropout=0.1, label_smooth=0.1, warmup=4000)
# batch rows, tokens a row (source and target alike)
TRANSFORMER_BATCH = (32, 512)
# Zaremba et al. 2014, section 4 "medium"
LSTM_LM = dict(vocab=10000, hidden=650, layers=2, num_steps=35, batch=20,
               dropout=0.5, init_scale=0.05, lr=1.0, clip=5.0)
# token ids under this are kept out of the synthetic corpora (0 padding,
# 1 start, 2 end)
FIRST_ID = 3


def sinusoid_table(n: int, d: int) -> np.ndarray:
    """[n, d] float32: sin at the even lanes and cos at the odd ones of
    pos / 10000^(2i/d)."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(0, d, 2, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, i / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


class TransformerBase(nn.Layer):
    """Shared embedding (scaled by sqrt(d_model)) plus sinusoidal
    positions into nn.Transformer, logits through the embedding's
    transpose; built on the default device."""

    def __init__(self, vocab=37000, d_model=512, nhead=8, num_layers=6,
                 d_ff=2048, dropout=0.1, max_len=1024):
        super().__init__()
        self.d_model = d_model
        self.embedding = nn.Embedding(
            vocab, d_model, weight_attr=nn.ParamAttr(
                initializer=nn.initializer.Normal(0.0, d_model ** -0.5)))
        self.transformer = nn.Transformer(
            d_model, nhead, num_layers, num_layers, d_ff, dropout,
            attn_dropout=0.0, normalize_before=False)
        self.dropout = nn.Dropout(dropout)
        self.register_buffer(
            "pos", torch.from_numpy(sinusoid_table(max_len, d_model)).to(
                self.embedding.weight.device), persistent=False)

    def embed(self, ids, start: int = 0):
        x = self.embedding(ids) * math.sqrt(self.d_model)
        return self.dropout(x + self.pos[start:start + ids.shape[1]])

    def encode(self, src):
        return self.transformer.encoder(self.embed(src))

    def decode(self, tgt, memory, tgt_mask=None, cache=None, start: int = 0):
        return self.transformer.decoder(self.embed(tgt, start), memory,
                                        tgt_mask, None, cache)

    def logits(self, h):
        return paddle.matmul(h, self.embedding.weight, transpose_y=True)

    def forward(self, src, tgt, tgt_mask=None):
        return self.logits(self.decode(tgt, self.encode(src), tgt_mask))


def transformer_flops(cfg: dict, batch: int, src_len: int,
                      tgt_len: int) -> float:
    """Matmul FLOPs of one training step (forward, and backward at twice
    the forward), per batch row:
      encoder layer, per source token: 2 (4 d^2 + 2 d f) + 4 S d
      decoder layer, per target token: 2 (6 d^2 + 2 d f) + 4 T d + 4 S d,
        and per source token 2 (2 d^2) (the cross-attention's keys and
        values of the memory)
      output projection, per target token: 2 d V
    (d = d_model, f = d_ff, S / T = source / target length; the causal
    self-attention counted over all T keys, the work composed attention
    does)."""
    d, f, V, L = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["layers"]
    S, T = src_len, tgt_len
    enc = S * (2 * (4 * d * d + 2 * d * f) + 4 * S * d)
    dec = T * (2 * (6 * d * d + 2 * d * f) + 4 * T * d + 4 * S * d) \
        + S * 2 * (2 * d * d)
    return 3.0 * batch * (L * (enc + dec) + T * 2 * d * V)


def transformer_loss(model, src, tgt_in, tgt_out, tgt_mask,
                     epsilon: float = 0.1):
    """Label-smoothed cross-entropy of the model's logits, averaged over
    the target tokens."""
    logits = model(src, tgt_in, tgt_mask)
    label = F.label_smooth(F.one_hot(tgt_out, logits.shape[-1]),
                           epsilon=epsilon)
    return F.cross_entropy(logits, label, soft_label=True)


def build_transformer(seed: int = 0, device=None, cfg: dict = None,
                      batch=None) -> dict:
    """The model (random weights from `seed`), its optimizer and
    scheduler, and the batch: {"model", "opt", "sched", "src", "tgt_in",
    "tgt_out", "tgt_mask", "cfg"}."""
    cfg = dict(TRANSFORMER, **(cfg or {}))
    B, T = batch or TRANSFORMER_BATCH
    paddle.seed(seed)
    with default_device(device):
        model = TransformerBase(cfg["vocab"], cfg["d_model"], cfg["nhead"],
                                cfg["layers"], cfg["d_ff"], cfg["dropout"],
                                max(T, 1024))
        sched = paddle.optimizer.lr.NoamDecay(
            d_model=cfg["d_model"], warmup_steps=cfg["warmup"],
            last_epoch=cfg["warmup"] - 1)
        opt = paddle.optimizer.Adam(
            learning_rate=sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
            parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        rng = np.random.RandomState(seed)
        src = paddle.to_tensor(rng.randint(FIRST_ID, cfg["vocab"], (B, T)))
        tgt = rng.randint(FIRST_ID, cfg["vocab"], (B, T + 1))
        tgt_in = paddle.to_tensor(tgt[:, :-1])
        tgt_out = paddle.to_tensor(tgt[:, 1:])
        tgt_mask = model.transformer.generate_square_subsequent_mask(T)
    return dict(model=model, opt=opt, sched=sched, src=src, tgt_in=tgt_in,
                tgt_out=tgt_out, tgt_mask=tgt_mask, cfg=cfg)


def transformer_forward(st: dict):
    """The training loss under auto_cast O1 (no backward)."""
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        return transformer_loss(st["model"], st["src"], st["tgt_in"],
                                st["tgt_out"], st["tgt_mask"],
                                st["cfg"]["label_smooth"])


def _train_step(st: dict):
    loss = transformer_forward(st)
    loss.backward()
    with torch.profiler.record_function("optimizer"):
        st["opt"].step()
    st["opt"].clear_grad()
    st["sched"].step()
    return loss


def transformer_step(st: dict) -> float:
    """One eager training step (the update inside an `optimizer`
    profiler range); returns its loss (a host read)."""
    return float(_train_step(st).item())


def _timed(step, st, warmup: int, steps: int, device) -> dict:
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(st))
        if i >= warmup:
            step_s.append(time.perf_counter() - t0)
    return {"losses": losses, "step_s": step_s,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if cuda else 0.0)}


# kernel groups of the profile: K1, the GEMMs (cuBLAS), the softmax
# kernels (composed attention's and the loss's log_softmax)
PROFILE_GROUPS = (("flash (K1)", ("fa_fwd", "fa_bwd", "fa_delta")),
                  ("gemm", ("nvjet", "gemm", "Gemm", "cutlass", "xmma")),
                  ("softmax", ("softmax", "SoftMax")))


def run_transformer(warmup: int = 2, steps: int = 5, seed: int = 0,
                    device=None, built: Optional[dict] = None,
                    profile: bool = False) -> dict:
    """Train; returns losses, step times, tokens/s (source + target),
    MFU, peak memory, the attention route and its q dtype; with profile,
    train_bench.profile_steps over 3 more steps (device busy time, idle
    share, time by PROFILE_GROUPS and the `optimizer` range, the top
    kernels)."""
    from paddle_tpu_torch.nn.functional import attention as A
    st = built or build_transformer(seed, device)
    st["model"].train()
    res = _timed(transformer_step, st, warmup, steps,
                 st["src"].place.get_device())
    B, T = st["src"].shape
    t = sum(res["step_s"])
    flops = transformer_flops(st["cfg"], B, T, st["tgt_in"].shape[1])
    res.update(tokens_per_sec=B * (T + st["tgt_in"].shape[1]) * steps / t,
               mfu=flops * steps / t / BF16_PEAK,
               flops_per_step=flops, last_path=A.LAST_PATH,
               last_dtype=str(A.LAST_DTYPE).replace("torch.", ""))
    if profile:
        from .train_bench import profile_steps
        res["profile"] = profile_steps(_train_step, (st,), 3,
                                       PROFILE_GROUPS, ("optimizer",))
    return res


def greedy_decode(model, src, steps: int, start_token: int = 1,
                  cached: bool = True):
    """Greedy target ids [B, steps] for sources src, in eval mode: with
    cached=True one token a step through TransformerDecoder.gen_cache
    (MultiHeadAttention.Cache for self-attention, StaticCache for the
    memory); otherwise the whole prefix a step under the causal mask.
    Returns (ids, the top-2 logit margin of each step's choice)."""
    model.eval()
    with paddle.no_grad():
        memory = model.encode(src)
        B = src.shape[0]
        seq = paddle.full([B, 1], start_token, dtype="int64")
        cache = model.transformer.decoder.gen_cache(memory) if cached \
            else None
        margins = []
        for t in range(steps):
            if cached:
                h, cache = model.decode(seq[:, -1:], memory, None, cache,
                                        start=t)
            else:
                mask = model.transformer.generate_square_subsequent_mask(
                    t + 1)
                h = model.decode(seq, memory, mask)
            logits = model.logits(h[:, -1]).float()
            top2 = torch.topk(logits, 2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).min().item())
            seq = paddle.concat([seq, logits.argmax(-1, keepdim=True)], 1)
    model.train()
    return seq[:, 1:], margins


# ----------------------------------------------------------------- LSTM LM
class LSTMLM(nn.Layer):
    """Embedding -> dropout -> nn.LSTM (dropout between layers) ->
    dropout -> Linear to the vocabulary; every weight U(-init_scale,
    init_scale); built on the default device."""

    def __init__(self, vocab=10000, hidden=650, layers=2, dropout=0.5,
                 init_scale=0.05):
        super().__init__()

        def u():
            return nn.ParamAttr(initializer=nn.initializer.Uniform(
                -init_scale, init_scale))
        self.embedding = nn.Embedding(vocab, hidden, weight_attr=u())
        self.lstm = nn.LSTM(hidden, hidden, layers, dropout=dropout,
                            weight_ih_attr=u(), weight_hh_attr=u(),
                            bias_ih_attr=u(), bias_hh_attr=u())
        self.dropout = nn.Dropout(dropout)
        self.output = nn.Linear(hidden, vocab, weight_attr=u(),
                                bias_attr=u())

    def forward(self, x, initial_states=None):
        h, states = self.lstm(self.dropout(self.embedding(x)),
                              initial_states)
        return self.output(self.dropout(h)), states

    def cells(self):
        return [rnn.cell for rnn in self.lstm._layers]


class StackedCells(nn.Layer):
    """LSTMCells run in sequence for one step; states a list of (h, c)."""

    def __init__(self, cells):
        super().__init__()
        self.cells = nn.LayerList(cells)

    def forward(self, x, states):
        new = []
        for cell, s in zip(self.cells, states):
            x, s = cell(x, s)
            new.append(s)
        return x, new


def lstm_loss(model, x, y):
    """Cross-entropy summed over the unrolled steps, averaged over the
    batch."""
    logits, _ = model(x)
    per_token = F.cross_entropy(logits, y, reduction="none")
    return per_token.mean(0).sum()


def build_lstm(seed: int = 0, device=None, cfg: dict = None) -> dict:
    """{"model", "opt", "x", "y", "cfg"}: random weights and tokens from
    `seed`."""
    cfg = dict(LSTM_LM, **(cfg or {}))
    paddle.seed(seed)
    with default_device(device):
        model = LSTMLM(cfg["vocab"], cfg["hidden"], cfg["layers"],
                       cfg["dropout"], cfg["init_scale"])
        opt = paddle.optimizer.SGD(
            learning_rate=cfg["lr"], parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(cfg["clip"]))
        rng = np.random.RandomState(seed)
        toks = rng.randint(FIRST_ID, cfg["vocab"],
                           (cfg["batch"], cfg["num_steps"] + 1))
        x = paddle.to_tensor(toks[:, :-1])
        y = paddle.to_tensor(toks[:, 1:])
    return dict(model=model, opt=opt, x=x, y=y, cfg=cfg)


def lstm_step(st: dict) -> float:
    loss = lstm_loss(st["model"], st["x"], st["y"])
    loss.backward()
    st["opt"].step()
    st["opt"].clear_grad()
    return float(loss.item())


def run_lstm(warmup: int = 2, steps: int = 8, seed: int = 0, device=None,
             built: Optional[dict] = None) -> dict:
    """Train; returns losses, step times, tokens/s and peak memory."""
    st = built or build_lstm(seed, device)
    st["model"].train()
    res = _timed(lstm_step, st, warmup, steps, st["x"].place.get_device())
    B, T = st["x"].shape
    res["tokens_per_sec"] = B * T * steps / sum(res["step_s"])
    return res


def beam_search(model, prefixes, beam_size: int = 4, max_step_num: int = 20,
                start_token: int = 1, end_token: int = 2) -> dict:
    """BeamSearchDecoder over the model's LSTMCells stacked, from the
    states the LSTM reaches over `prefixes` [N, L], under dynamic_decode;
    returns its outputs ({"predicted_ids", "parent_ids", "scores"},
    [N, steps, beam]) in eval mode."""
    model.eval()
    with paddle.no_grad():
        _, (h, c) = model.lstm(model.embedding(prefixes))
        states = [(h[i], c[i]) for i in range(h.shape[0])]
        decoder = nn.BeamSearchDecoder(
            StackedCells(model.cells()), start_token, end_token, beam_size,
            embedding_fn=model.embedding, output_fn=model.output)
        outputs, _ = nn.dynamic_decode(decoder, inits=states,
                                       max_step_num=max_step_num)
    model.train()
    return outputs


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("transformer", "lstm"),
                    default="transformer")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="transformer: profile 3 more steps")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.model == "transformer":
        res = run_transformer(args.warmup, args.steps, args.seed, "cuda",
                              profile=args.profile)
    else:
        st = build_lstm(args.seed, "cuda")
        res = run_lstm(args.warmup, args.steps, args.seed, built=st)
        out = beam_search(st["model"], st["x"][:8])
        res["beam_ids"] = out["predicted_ids"].numpy().tolist()
    print(json.dumps({"model": args.model, **res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
