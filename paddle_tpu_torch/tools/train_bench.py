"""The GPT, ResNet-50, BERT-base, ERNIE-large and LeNet train steps at
the geometries of bench.py's `bench_gpt`, `bench_resnet`, `bench_bert`,
`bench_ernie`, `bench_lenet` and `bench_lenet_multistep`, and
MobileNetV1/V2 and VGG-16 at their papers' recipes, on the GPU.

    python -m paddle_tpu_torch.tools.train_bench
        [--model gpt|resnet50|bert|ernie|lenet|mobilenet_v2|mobilenet_v1|
                 vgg16] [--data-format NCHW|NHWC] [--heads 6|12]
        [--eager] [--multistep K] [--steps N] [--warmup N] [--seed N]
        [--profile]

gpt (default): GPT(vocab 32768, hidden 768, 12 layers, max_seq_len 1024)
with random weights from --seed, cast with amp.decorate(level="O2",
dtype="bfloat16") (bf16 parameters, f32 master weights), trained with
AdamW(1e-4, grad_clip=ClipGradByGlobalNorm(1.0)) through jit.TrainStep on
one random batch of 32 x 1024 tokens (the same batch every step, as
bench_gpt does). With 6 heads of 128 attention runs through kernel K1,
with 12 heads of 64 through K2. MFU counts bench.py's FLOPs per token
(6 x matmul parameters + 12 L h T, copied below).

gpt --eager: the Paddle eager loop at the same geometry (random weights
from --seed, float32 parameters): `paddle.set_device`, AdamW over
LinearWarmup(CosineAnnealingDecay(1e-4, T_max=1000), warmup_steps=4,
start_lr=0, end_lr=1e-4) with ClipGradByGlobalNorm(1.0), GradScaler(2^15),
and per step `auto_cast(level="O1", dtype="bfloat16")` around the loss,
`scaler.scale(loss).backward()`, `scaler.minimize`, `opt.clear_grad()`,
`sched.step()`, on one batch x = tokens[:, :-1], y = tokens[:, 1:] of
32 x 1025 random tokens. Under O1 the linears hand bf16 q/k/v to
attention, so K1 runs in bf16 (6 heads). It also prints each step's
learning rate, GradScaler's scale, skipped steps and found-inf host
reads, and the same readings for jit.TrainStep with the O1 context
inside its loss function on the same weights and batch (`o1_trainstep`);
with --profile, both routes' profiles (GradScaler's unscale, check and
update in the eager loop's `optimizer` range).

resnet50: resnet50(num_classes=1000) with random weights from --seed,
amp.decorate O2 bf16, Momentum(0.1), jit.TrainStep over the hard-label
cross-entropy, on one random batch of 128 images of 3 x 224 x 224 (cast
to bf16 once) with labels [128, 1] in [0, 1000) (bench_resnet, which
times 40 steps). MFU counts bench.py's 3 x 4.1e9 FLOP per image.
--data-format NHWC runs the model channel-last on the batch permuted to
[128, 224, 224, 3].

mobilenet_v2: mobilenet_v2(scale=1.0, num_classes=1000) with random
weights from --seed at the recipe of Sandler et al. 2018 (MobileNetV2,
section 6.1): batch 96 of 3 x 224 x 224 images (cast to bf16 once),
RMSProp(rho=0.9, momentum=0.9) at learning rate 0.045 under
ExponentialDecay(gamma=0.98) (a decay per epoch: a run shorter than an
epoch reads 0.045 throughout), L2Decay(4e-5), AMP O2 bf16 through
jit.TrainStep, and an ExponentialMovingAverage(0.9999) of the weights
updated after every step (inside an `ema` profiler range). MFU counts 3
x the paper's 300 M multiply-adds x 2 FLOP per image. mobilenet_v1: the
same recipe on mobilenet_v1() (569 M multiply-adds, Howard et al. 2017
Table 8). vgg16: vgg16(batch_norm=True) at configuration D of Simonyan
& Zisserman 2015, batch 256 over 4 GPUs there, so 64 on one card,
Momentum(0.01, 0.9), L2Decay(5e-4), O2; MFU counts 3 x its multiply-adds
x 2 (`vgg_macs`, 15.5 G).

bert, ernie: BertForPretraining at BertConfig() (BERT-base, batch 128 x
seq 128) or ernie_large() (32 x 512) with random weights from --seed,
amp.decorate O2 bf16, AdamW(1e-4) with no clip, jit.TrainStep over
bert_pretrain_loss_fn on one make_bert_pretrain_batch(RandomState(seed))
(15 % of the positions masked and gathered before the MLM head), the
same batch every step (bench.py `_bench_mlm_pretrain`). ERNIE-large's 16
heads of 64 at T 512 go to K2 non-causal as packed pairs; BERT-base at
T 128, under flash_attention_min_seq, takes composed attention. MFU
counts bench.py's FLOPs per sample (`flops_per_sample`, copied below).

lenet: LeNet(10), Adam(1e-3), jit.TrainStep over the hard-label
cross-entropy on one batch of 64 N(0, 1) images of 1 x 28 x 28 with
labels [64, 1] in [0, 10), 2 warm-up + 100 timed steps (bench_lenet);
with --multistep K, jit.MultiStepTrainStep over K such batches stacked
[K, 64, ...], 2 warm-up calls and 100 // K timed calls
(bench_lenet_multistep, which bench.py runs at K 50). Timed as bench.py
does: one synchronise after the timed window, no fetch between steps.

All print one JSON line: losses, step times (gpt, resnet50, bert, ernie:
host clock around each step, which ends in the loss's fetch),
throughput and MFU over the timed steps against the H100 SXM dense bf16
peak, 989 TFLOP/s (NVIDIA data sheet), and peak device memory; gpt,
bert and ernie also the flash kernels' launches and the attention
route. --profile records 3 more steps with torch.profiler and prints
the device busy time, the idle share and the device time by group: for
gpt, bert and ernie the flash kernels, GEMMs, cross-entropy, the
optimizer range and the rest; for resnet50 the convolutions (cuDNN),
batch norm (its range), the cross-entropy, the optimizer range and the
rest (ReLU, residual adds, pooling, casts); for mobilenet_v2,
mobilenet_v1, vgg16 and resnet50 the depthwise convolutions, the layout
transforms (NCHW <-> NHWC), the other convolutions, pooling, batch norm,
the cross-entropy, the optimizer range, the EMA range and the rest.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np

__all__ = ["bench_config", "flops_per_token", "build", "run",
           "eager_schedule", "eager_batch", "build_eager", "run_eager",
           "build_o1_trainstep", "run_o1_trainstep",
           "build_resnet", "run_resnet", "resnet_batch", "ce_loss_fn",
           "mlm_config", "flops_per_sample", "build_mlm", "run_mlm",
           "build_lenet", "run_lenet", "build_vision", "run_vision",
           "vgg_macs", "vision_batch", "H100_BF16_FLOPS",
           "RESNET_FLOPS_PER_IMG"]

H100_BF16_FLOPS = 989e12
BATCH, SEQ = 32, 1024
# bench_resnet's batch and image side, and its FLOPs per image (forward
# 4.1 GFLOP at 224, fwd + bwd taken as 3x: bench.py:718-723)
RESNET_BATCH, RESNET_SIDE = 128, 224
RESNET_FLOPS_PER_IMG = 3 * 4.1e9
# (batch, seq) of bench_bert and bench_ernie
MLM_GEOMETRY = {"bert": (128, 128), "ernie": (32, 512)}
# bench_lenet's batch, timed steps and bench_lenet_multistep's K
LENET_BATCH, LENET_STEPS, LENET_K = 64, 100, 50
# the vision recipes on one card: MobileNetV2's batch 96 per worker
# (Sandler et al. 2018, 6.1), VGG's 256 over 4 GPUs (Simonyan &
# Zisserman 2015, 3.1 and 4), and the papers' multiply-adds per image
VISION_BATCH = {"mobilenet_v2": 96, "mobilenet_v1": 96, "vgg16": 64}
VISION_SIDE = 224
MOBILENET_MADDS = {"mobilenet_v2": 300e6, "mobilenet_v1": 569e6}


def bench_config(num_heads: int = 6):
    from ..models.gpt import GPTConfig
    return GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                     num_heads=num_heads, max_seq_len=SEQ)


def flops_per_token(cfg) -> float:
    """fwd+bwd FLOPs/token: 6 * N_matmul + attention 12 * L * hidden *
    seq (bench.py `_gpt_flops_per_token`)."""
    h, L, V, T = (cfg.hidden_size, cfg.num_layers, cfg.vocab_size,
                  cfg.max_seq_len)
    per_layer = 4 * h * h + 2 * cfg.ffn_mult * h * h
    n_matmul = L * per_layer + V * h
    return 6 * n_matmul + 12 * L * h * T


def flash_launches() -> Dict[str, int]:
    from ..ops.kernels import flash_attention as k1
    from ..ops.kernels import packed_flash as k2
    return {"flash_attention_fwd": k1.flash_attention_fwd.launches,
            "flash_attention_bwd": k1.flash_attention_bwd.launches,
            "packed_flash_fwd": k2.packed_flash_fwd.launches,
            "packed_flash_bwd": k2.packed_flash_bwd.launches}


def build(num_heads: int = 6, seed: int = 0, device=None):
    """(model, TrainStep, x, y) at the bench_gpt geometry."""
    import torch
    from .. import amp, jit
    from ..models.gpt import GPT, gpt_loss_fn
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    cfg = bench_config(num_heads)
    model = GPT(cfg, device=device, seed=seed)
    optim = AdamW(1e-4, parameters=model.parameters(),
                  grad_clip=ClipGradByGlobalNorm(1.0))
    model, optim = amp.decorate(model, optim, level="O2", dtype="bfloat16")
    step = jit.TrainStep(model, gpt_loss_fn, optim)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    return model, step, x.to(model.device), y.to(model.device)


def ce_loss_fn(model, x, y):
    """loss_fn signature for jit.TrainStep: hard-label cross-entropy of
    the image classifiers (ResNet-50, LeNet)."""
    from ..nn.functional import cross_entropy
    return cross_entropy(model(x), y)


def resnet_batch(seed: int, device):
    """bench_resnet's batch from `seed`: images [128, 3, 224, 224] ~ N(0, 1)
    cast to bf16 once, labels [128, 1] int64 in [0, 1000)."""
    import torch
    rng = np.random.RandomState(seed)
    x = rng.randn(RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE).astype(
        np.float32)
    y = rng.randint(0, 1000, (RESNET_BATCH, 1)).astype(np.int64)
    return (torch.from_numpy(x).to(device, torch.bfloat16),
            torch.from_numpy(y).to(device))


def build_resnet(seed: int = 0, device=None, data_format: str = "NCHW"):
    """(model, TrainStep, x, y) at the bench_resnet geometry; NHWC takes
    the batch permuted channel-last (contiguous)."""
    from .. import amp, jit
    from ..optimizer import Momentum
    from ..vision.models import resnet50
    model = resnet50(num_classes=1000, device=device, seed=seed,
                     data_format=data_format)
    optim = Momentum(0.1, parameters=model.parameters())
    model, optim = amp.decorate(model, optim, level="O2", dtype="bfloat16")
    step = jit.TrainStep(model, ce_loss_fn, optim)
    x, y = resnet_batch(seed, model.device)
    if data_format == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    return model, step, x, y


def vgg_macs(cfg) -> float:
    """Multiply-adds per image of VGG over `cfg` (vgg.cfgs[...]) at
    VISION_SIDE: the 3x3 convolutions, then the 7x7-pooled classifier
    into 1000 classes."""
    macs, c, s = 0, 3, VISION_SIDE
    for v in cfg:
        if v == "M":
            s //= 2
        else:
            macs += s * s * 9 * c * v
            c = v
    return float(macs + 512 * 7 * 7 * 4096 + 4096 * 4096
                 + 4096 * 1000)


def vision_batch(name: str, seed: int, device):
    """`name`'s batch from `seed`: images [VISION_BATCH[name], 3,
    VISION_SIDE, VISION_SIDE] ~ N(0, 1) cast to bf16 once, labels
    [VISION_BATCH[name], 1] int64 in [0, 1000)."""
    import torch
    batch = VISION_BATCH[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 3, VISION_SIDE, VISION_SIDE).astype(np.float32)
    y = rng.randint(0, 1000, (batch, 1)).astype(np.int64)
    return (torch.from_numpy(x).to(device, torch.bfloat16),
            torch.from_numpy(y).to(device))


class _EMAStep:
    """step(x, y), then the EMA's update inside an `ema` profiler range."""

    def __init__(self, step, ema):
        self.step, self.ema = step, ema

    def __call__(self, *args):
        import torch
        loss = self.step(*args)
        with torch.profiler.record_function("ema"):
            self.ema.update()
        return loss


def build_vision(name: str = "mobilenet_v2", seed: int = 0,
                 device=None) -> dict:
    """The model, its optimizer, TrainStep (wrapped with the EMA update
    for the MobileNets), LR scheduler, EMA and batch at the recipe of
    `name` (see the module docstring)."""
    from .. import amp, jit
    from ..optimizer import RMSProp, Momentum, ExponentialMovingAverage
    from ..optimizer.lr import ExponentialDecay
    from ..regularizer import L2Decay
    from ..vision import models
    from ..vision.models.vgg import cfgs
    model = getattr(models, name)(num_classes=1000, device=device,
                                  seed=seed, **(
                                      {"batch_norm": True}
                                      if name == "vgg16" else {}))
    sched = ema = None
    if name.startswith("mobilenet"):
        sched = ExponentialDecay(0.045, gamma=0.98)
        optim = RMSProp(sched, rho=0.9, momentum=0.9,
                        parameters=model.parameters(),
                        weight_decay=L2Decay(4e-5))
        macs = MOBILENET_MADDS[name]
    else:
        optim = Momentum(0.01, 0.9, parameters=model.parameters(),
                         weight_decay=L2Decay(5e-4))
        macs = vgg_macs(cfgs["D"])
    model, optim = amp.decorate(model, optim, level="O2", dtype="bfloat16")
    step = jit.TrainStep(model, ce_loss_fn, optim)
    if name.startswith("mobilenet"):
        ema = ExponentialMovingAverage(0.9999,
                                       parameters=model.parameters())
        step = _EMAStep(step, ema)
    x, y = vision_batch(name, seed, model.device)
    return {"name": name, "model": model, "optim": optim, "step": step,
            "sched": sched, "ema": ema, "x": x, "y": y,
            "flops_per_img": 3 * 2 * macs}


def _time_steps(step, args, warmup: int, steps: int, dev) -> dict:
    """Warm-up and timed steps of step(*args): losses, host-clock step
    times (each ends in the loss's fetch) and peak device memory over the
    timed steps."""
    import torch
    cuda = dev.type == "cuda"
    losses, times = [], []

    def one():
        t0 = time.perf_counter()
        loss = step(*args).item()
        times.append(time.perf_counter() - t0)
        losses.append(loss)

    for _ in range(warmup):
        one()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        one()
    timed = times[warmup:]
    return {"losses": losses, "step_s": times,
            "timed_s": sum(timed) if timed else None,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if cuda else None)}


def run(num_heads: int = 6, warmup: int = 2, steps: int = 10,
        seed: int = 0, built=None, profile: bool = False) -> dict:
    """The GPT step: losses, step times, tokens/s and MFU over the timed
    steps, peak device memory and the flash kernels' launches during the
    timed steps."""
    from ..nn.functional import attention as A
    model, step, x, y = built or build(num_heads, seed)
    dev = model.device
    t = _time_steps(step, (x, y), warmup, 0, dev)
    before = flash_launches()
    t2 = _time_steps(step, (x, y), 0, steps, dev)
    launches = {k: v - before[k] for k, v in flash_launches().items()}
    tps = int(np.prod(x.shape)) * steps / t2["timed_s"] if steps else None
    out = {"num_heads": num_heads, "num_layers": model.cfg.num_layers,
           "batch": int(x.shape[0]), "seq": int(x.shape[1]),
           "losses": t["losses"] + t2["losses"],
           "step_s": t["step_s"] + t2["step_s"], "tokens_per_sec": tps,
           "mfu": (tps * flops_per_token(model.cfg) / H100_BF16_FLOPS
                   if tps and dev.type == "cuda" else None),
           "peak_mem_gb": t2["peak_mem_gb"],
           "last_path": A.LAST_PATH, "launches": launches}
    if profile:
        out["profile"] = profile_steps(step, (x, y), 3, _GPT_GROUPS,
                                       ("cross_entropy", "optimizer"))
    return out


def eager_schedule():
    """The eager loop's scheduler: 4 linear warm-up steps from 0 into a
    cosine decay from 1e-4 over 1000 steps."""
    from ..optimizer import lr
    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=1000),
                           warmup_steps=4, start_lr=0.0, end_lr=1e-4)


def eager_batch(cfg, seed: int, batch: int = BATCH, seq: int = SEQ):
    """tokens [batch, seq + 1] from `seed`: (tokens[:, :-1],
    tokens[:, 1:]) as numpy int64."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (batch, seq + 1))
    return tokens[:, :-1], tokens[:, 1:]


def build_eager(cfg=None, seed: int = 0, device=None, dtype="bfloat16",
                batch: int = BATCH):
    """The eager loop's state: {model, sched, opt, scaler, x, y, dtype}.
    x and y are Tensors on the model's device."""
    import paddle_tpu_torch as paddle
    from ..models.gpt import GPT
    cfg = cfg or bench_config(6)
    model = GPT(cfg, device=device, seed=seed)
    sched = eager_schedule()
    opt = paddle.optimizer.AdamW(
        sched, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 15)
    x, y = eager_batch(cfg, seed, batch, cfg.max_seq_len)
    place = paddle.CPUPlace() if model.device.type == "cpu" else \
        paddle.CUDAPlace(model.device.index or 0)
    return {"model": model, "sched": sched, "opt": opt, "scaler": scaler,
            "x": paddle.to_tensor(x, place=place),
            "y": paddle.to_tensor(y, place=place), "dtype": dtype}


def eager_step(st):
    """One step of the reference-style loop; returns the (unscaled)
    loss. GradScaler's unscale, check and update run inside an
    `optimizer` profiler range, as TrainStep's clip and update do."""
    import torch
    import paddle_tpu_torch as paddle
    from ..models.gpt import gpt_loss_fn
    with paddle.amp.auto_cast(level="O1", dtype=st["dtype"]):
        loss = gpt_loss_fn(st["model"], st["x"], st["y"])
    scaled = st["scaler"].scale(loss)
    scaled.backward()
    with torch.profiler.record_function("optimizer"):
        st["scaler"].minimize(st["opt"], scaled)
    st["opt"].clear_grad()
    st["sched"].step()
    return loss


def run_eager(warmup: int = 2, steps: int = 10, seed: int = 0,
              built=None, profile: bool = False) -> dict:
    """The eager loop: losses, step times (each ends in the loss's
    fetch), tokens/s and MFU over the timed steps, peak device memory,
    the learning rate each step used, GradScaler's scale, skipped steps
    and found-inf host reads, and the flash kernels' launches."""
    from ..nn.functional import attention as A
    st = built or build_eager(seed=seed)
    model, dev = st["model"], st["model"].device
    lrs = []

    def step():
        lrs.append(st["opt"].get_lr())
        return eager_step(st)

    before = flash_launches()
    t = _time_steps(step, (), warmup, steps, dev)
    launches = {k: v - before[k] for k, v in flash_launches().items()}
    tokens = int(np.prod(st["x"].shape))
    tps = tokens * steps / t["timed_s"] if steps else None
    sc = st["scaler"]
    out = {"route": "eager", "num_heads": model.cfg.num_heads,
            "num_layers": model.cfg.num_layers,
            "batch": int(st["x"].shape[0]), "seq": int(st["x"].shape[1]),
            "losses": t["losses"], "step_s": t["step_s"],
            "tokens_per_sec": tps,
            "mfu": (tps * flops_per_token(model.cfg) / H100_BF16_FLOPS
                    if tps and dev.type == "cuda" else None),
            "peak_mem_gb": t["peak_mem_gb"], "lrs": lrs,
            "loss_scale": sc.get_init_loss_scaling(),
            "skipped_steps": sc.skipped_steps,
            "found_inf_syncs": sc.host_syncs,
            "last_path": A.LAST_PATH,
            "last_dtype": str(A.LAST_DTYPE).replace("torch.", ""),
            "launches": launches}
    if profile:
        out["profile"] = profile_steps(lambda: eager_step(st), (), 3,
                                       _GPT_GROUPS,
                                       ("cross_entropy", "optimizer"))
    return out


def build_o1_trainstep(seed: int = 0, device=None, x=None, y=None):
    """(model, step, x, y): jit.TrainStep over the eager loop's model,
    optimizer and batch, with auto_cast O1 inside the loss function;
    step(x, y) runs it and then steps the scheduler, as the eager loop
    does."""
    import paddle_tpu_torch as paddle
    from ..models.gpt import GPT, gpt_loss_fn
    cfg = bench_config(6)
    model = GPT(cfg, device=device, seed=seed)
    sched = eager_schedule()
    opt = paddle.optimizer.AdamW(
        sched, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))

    def o1_loss(m, a, b):
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            return gpt_loss_fn(m, a, b)

    train = paddle.jit.TrainStep(model, o1_loss, opt)

    def step(a, b):
        loss = train(a, b)
        sched.step()
        return loss
    if x is None:
        x, y = eager_batch(cfg, seed)
    return (model, step, paddle.to_tensor(x, place=model.device.type),
            paddle.to_tensor(y, place=model.device.type))


def run_o1_trainstep(warmup: int = 2, steps: int = 10, seed: int = 0,
                     built=None, profile: bool = False) -> dict:
    """jit.TrainStep with O1 in its loss function: the readings of
    run_eager's for the same loop without GradScaler."""
    from ..nn.functional import attention as A
    model, step, x, y = built or build_o1_trainstep(seed)
    dev = model.device
    before = flash_launches()
    t = _time_steps(step, (x, y), warmup, steps, dev)
    launches = {k: v - before[k] for k, v in flash_launches().items()}
    tps = int(np.prod(x.shape)) * steps / t["timed_s"] if steps else None
    out = {"route": "o1_trainstep", "losses": t["losses"],
           "step_s": t["step_s"], "tokens_per_sec": tps,
           "mfu": (tps * flops_per_token(model.cfg) / H100_BF16_FLOPS
                   if tps and dev.type == "cuda" else None),
           "peak_mem_gb": t["peak_mem_gb"], "last_path": A.LAST_PATH,
           "launches": launches}
    if profile:
        out["profile"] = profile_steps(step, (x, y), 3, _GPT_GROUPS,
                                       ("cross_entropy", "optimizer"))
    return out


def run_resnet(warmup: int = 2, steps: int = 10, seed: int = 0,
               built=None, profile: bool = False,
               data_format: str = "NCHW") -> dict:
    """The ResNet-50 step: losses, step times, imgs/s and MFU over the
    timed steps, peak device memory."""
    model, step, x, y = built or build_resnet(seed, data_format=data_format)
    dev = model.device
    t = _time_steps(step, (x, y), warmup, steps, dev)
    ips = x.shape[0] * steps / t["timed_s"] if steps else None
    out = {"model": "resnet50", "data_format": model.data_format,
           "batch": int(x.shape[0]),
           "image": list(x.shape[1:]), "losses": t["losses"],
           "step_s": t["step_s"], "imgs_per_sec": ips,
           "mfu": (ips * RESNET_FLOPS_PER_IMG / H100_BF16_FLOPS
                   if ips and dev.type == "cuda" else None),
           "peak_mem_gb": t["peak_mem_gb"]}
    if profile:
        out["profile"] = profile_steps(step, (x, y), 3, _VISION_GROUPS,
                                       _VISION_RANGES)
    return out


def run_vision(name: str = "mobilenet_v2", warmup: int = 2,
               steps: int = 10, seed: int = 0, built=None,
               profile: bool = False) -> dict:
    """A vision model's step at its recipe: losses, step times, imgs/s and
    MFU over the timed steps, peak device memory, the learning rate the
    steps read."""
    b = built or build_vision(name, seed)
    dev = b["model"].device
    x, y = b["x"], b["y"]
    t = _time_steps(b["step"], (x, y), warmup, steps, dev)
    ips = x.shape[0] * steps / t["timed_s"] if steps else None
    out = {"model": name, "batch": int(x.shape[0]),
           "image": list(x.shape[1:]), "losses": t["losses"],
           "step_s": t["step_s"], "imgs_per_sec": ips,
           "lr": b["optim"].get_lr(),
           "mfu": (ips * b["flops_per_img"] / H100_BF16_FLOPS
                   if ips and dev.type == "cuda" else None),
           "peak_mem_gb": t["peak_mem_gb"]}
    if profile:
        out["profile"] = profile_steps(b["step"], (x, y), 3, _VISION_GROUPS,
                                       _VISION_RANGES)
    return out


def mlm_config(model: str):
    """BertConfig of bench_bert ("bert": BERT-base) or bench_ernie
    ("ernie": ERNIE-large)."""
    from ..models.bert import bert_base, ernie_large
    return {"bert": bert_base, "ernie": ernie_large}[model]()


def flops_per_sample(cfg, seq: int, P: int) -> float:
    """fwd+bwd FLOPs per sample of the MLM + NSP step (bench.py
    `_bench_mlm_pretrain`): the trunk's matmuls on all `seq` tokens, the
    MLM transform and tied unembedding on the P gathered positions, and
    attention 12 * L * hidden * seq^2."""
    h, L, V, T = cfg.hidden_size, cfg.num_layers, cfg.vocab_size, seq
    per_layer = 4 * h * h + 2 * cfg.ffn_mult * h * h
    return (6 * (L * per_layer * T + (h * h + V * h) * P)
            + 12 * L * h * T * T)


def build_mlm(model: str = "ernie", seed: int = 0, device=None):
    """(model, TrainStep, args) at bench_bert's or bench_ernie's geometry;
    args are the five batch tensors on the model's device."""
    import torch
    from .. import amp, jit
    from ..models.bert import (BertForPretraining, bert_pretrain_loss_fn,
                               make_bert_pretrain_batch)
    from ..optimizer import AdamW
    cfg = mlm_config(model)
    bs, seq = MLM_GEOMETRY[model]
    net = BertForPretraining(cfg, device=device, seed=seed)
    optim = AdamW(1e-4, parameters=net.parameters())
    net, optim = amp.decorate(net, optim, level="O2", dtype="bfloat16")
    step = jit.TrainStep(net, bert_pretrain_loss_fn, optim)
    batch = make_bert_pretrain_batch(np.random.RandomState(seed),
                                     cfg.vocab_size, bs, seq)
    return net, step, tuple(torch.from_numpy(a).to(net.device)
                            for a in batch)


def run_mlm(model: str = "ernie", warmup: int = 2, steps: int = 10,
            seed: int = 0, built=None, profile: bool = False) -> dict:
    """The MLM + NSP step: losses, step times, samples/s and MFU over the
    timed steps, peak device memory, the attention route and the flash
    kernels' launches during the timed steps."""
    from ..nn.functional import attention as A
    net, step, args = built or build_mlm(model, seed)
    dev = net.device
    t = _time_steps(step, args, warmup, 0, dev)
    before = flash_launches()
    t2 = _time_steps(step, args, 0, steps, dev)
    launches = {k: v - before[k] for k, v in flash_launches().items()}
    bs, seq = args[0].shape
    P = args[4].shape[1]
    sps = bs * steps / t2["timed_s"] if steps else None
    out = {"model": model, "num_layers": net.cfg.num_layers,
           "hidden": net.cfg.hidden_size, "batch": int(bs),
           "seq": int(seq), "masked": int(P),
           "losses": t["losses"] + t2["losses"],
           "step_s": t["step_s"] + t2["step_s"], "samples_per_sec": sps,
           "mfu": (sps * flops_per_sample(net.cfg, seq, P) / H100_BF16_FLOPS
                   if sps and dev.type == "cuda" else None),
           "peak_mem_gb": t2["peak_mem_gb"], "last_path": A.LAST_PATH,
           "launches": launches}
    if profile:
        out["profile"] = profile_steps(step, args, 3, _GPT_GROUPS,
                                       ("cross_entropy", "optimizer"))
    return out


def build_lenet(seed: int = 0, multistep: Optional[int] = None,
                device=None):
    """(model, step, args) at bench_lenet's recipe: TrainStep on one
    batch, or (bench_lenet_multistep) MultiStepTrainStep(k=multistep) on
    k batches stacked [k, ...], the same k every call."""
    import torch
    from .. import jit
    from ..optimizer import Adam
    from ..vision.models import LeNet
    net = LeNet(device=device, seed=seed)
    optim = Adam(1e-3, parameters=net.parameters())
    lead = (multistep,) if multistep else ()
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, LENET_BATCH, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (*lead, LENET_BATCH, 1)).astype(np.int64)
    if multistep:
        step = jit.MultiStepTrainStep(net, ce_loss_fn, optim, multistep)
    else:
        step = jit.TrainStep(net, ce_loss_fn, optim)
    return net, step, tuple(torch.from_numpy(a).to(net.device)
                            for a in (x, y))


def run_lenet(multistep: Optional[int] = None, warmup: int = 2,
              steps: int = LENET_STEPS, seed: int = 0, built=None) -> dict:
    """The LeNet step: `warmup` calls, then `steps` optimizer steps (one
    a call, or `steps // multistep` calls of multistep) timed on the host
    clock up to one synchronise; losses, samples/s."""
    import torch
    net, step, args = built or build_lenet(seed, multistep)
    dev = net.device
    k = multistep or 1
    calls = max(1, steps // k)
    losses = [step(*args) for _ in range(warmup)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    losses += [step(*args) for _ in range(calls)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return {"model": "lenet", "multistep": multistep,
            "batch": LENET_BATCH, "timed_steps": calls * k,
            "losses": torch.cat([v.reshape(-1) for v in losses]).tolist(),
            "timed_s": wall,
            "samples_per_sec": calls * k * LENET_BATCH / wall}


# device kernels by name: the flash kernels and cuBLAS's GEMMs (GPT, BERT)
_GPT_GROUPS = (("flash (K1/K2)", ("fa_fwd", "fa_bwd", "fa_delta")),
               ("gemm", ("nvjet", "gemm", "Gemm", "cutlass", "xmma")))
_CONV_KEYS = ("fprop", "dgrad", "wgrad", "implicit", "convolve", "conv2d",
              "cudnn", "conv_")
LAYOUT_KEYS = ("nchwToNhwc", "nhwcToNchw", "nchw_to_nhwc", "nhwc_to_nchw",
               "transpose")
# PyTorch's copy kernels (copy_, .contiguous(), dtype casts)
COPY_KEYS = ("copy_kernel",)
# the vision models' groups: depthwise convolutions first (their kernels'
# names), cuDNN's layout transforms on their own, copies and casts, the
# other convolutions, the classifiers' GEMMs and pooling; the ranges are
# the port's batch norm, fused CE, optimizer and EMA ranges
_VISION_GROUPS = (("depthwise conv", ("depthwise", "DepthWise", "dwconv")),
                  ("layout transform", LAYOUT_KEYS),
                  ("copy / cast", COPY_KEYS),
                  ("conv (cuDNN)", _CONV_KEYS),
                  ("gemm", ("nvjet", "gemm", "Gemm")),
                  ("pooling", ("pool", "Pool")))
_VISION_RANGES = ("batch_norm", "cross_entropy", "optimizer", "ema")


def profile_steps(step, args, n: int, kernel_groups, ranges) -> dict:
    """torch.profiler over n calls of step(*args): wall, device busy
    time, idle share, and device time by group: kernels by name
    (`kernel_groups`), the profiler ranges the port opens (`ranges`: the
    fused CE's, the batch norms', and jit.TrainStep's clip + update
    loop), and the rest; each kernel group's launches; each range's span
    on the device timeline (its kernels plus the idle gaps between
    them); the 15 kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(*args).item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows, without the ranges' own device-side spans (a range
    # shows on the device timeline as one row spanning its kernels and
    # the gaps between them)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    spans = {r: sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.key == r) / 1e6
             for r in ranges}
    groups = {g: 0.0 for g, _ in kernel_groups}
    launches = {g: 0 for g, _ in kernel_groups}
    for e in rows:
        for g, keys in kernel_groups:
            if any(k in e.key for k in keys):
                groups[g] += e.self_device_time_total / 1e6
                launches[g] += e.count
                break
    for r in ranges:
        groups[r] = sum(e.device_time_total for e in prof.events()
                        if e.name == r and e.device_type == DeviceType.CPU
                        ) / 1e6
    groups["other"] = busy - sum(groups.values())
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:15]
    return {"steps": n, "wall_s": wall, "busy_s": busy,
            "idle_share": 1 - busy / wall if wall else None,
            "groups_s": groups, "groups_n": launches,
            "range_spans_s": spans,
            "top": [(e.key[:90], e.count, e.self_device_time_total / 1e6)
                    for e in top]}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("gpt", "resnet50", "bert", "ernie",
                                        "lenet", "mobilenet_v2",
                                        "mobilenet_v1", "vgg16"),
                    default="gpt")
    ap.add_argument("--data-format", choices=("NCHW", "NHWC"),
                    default="NCHW", help="resnet50's layout")
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--eager", action="store_true",
                    help="gpt: the eager loop and TrainStep O1 beside it")
    ap.add_argument("--multistep", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=None,
                    help="timed steps (lenet 100, the others 10)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    steps = args.steps if args.steps is not None else (
        LENET_STEPS if args.model == "lenet" else 10)
    if args.model == "gpt" and args.eager:
        import paddle_tpu_torch as paddle
        paddle.set_device("gpu")
        res = run_eager(args.warmup, steps, args.seed,
                        profile=args.profile)
        torch.cuda.empty_cache()
        res["o1_trainstep"] = run_o1_trainstep(args.warmup, steps,
                                               args.seed,
                                               profile=args.profile)
    elif args.model == "gpt":
        res = run(args.heads, args.warmup, steps, args.seed,
                  profile=args.profile)
    elif args.model == "resnet50":
        res = run_resnet(args.warmup, steps, args.seed,
                         profile=args.profile, data_format=args.data_format)
    elif args.model in VISION_BATCH:
        res = run_vision(args.model, args.warmup, steps, args.seed,
                         profile=args.profile)
    elif args.model == "lenet":
        res = run_lenet(args.multistep, args.warmup, steps, args.seed)
    else:
        res = run_mlm(args.model, args.warmup, steps, args.seed,
                      profile=args.profile)
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
