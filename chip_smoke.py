#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a GPU and the CUDA
toolkit. Phases, each of which fails the run (non-zero exit) on error:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from this checkout's sources (K3 of the
   serving path, K1/K2 of the GPT train step, K4 of the ResNet block
   boundary; one nvcc per source, started together) and print what
   `ptxas -v` reports (for the flash kernels: registers and spills of
   each), and the count of wgmma (HGMMA) and TMA / cp.async loads
   (UTMALDG / LDGSTS) in the SASS of the 16-bit (bf16 and f16) flash
   kernels, which must have both; for K3 each instance's registers, spills and shared
   memory; for K4 each instance's registers and spills, its ring's
   depth and dynamic shared memory at the five block-boundary
   geometries, and its HGMMA and UTMALDG counts, both of which must be
   non-zero;
3. hold K3 against both plain PyTorch versions (the one-pass stream
   and the kernel's split-and-merge order) on the card at the shapes the
   serving path gives it (f32 within 1e-5, bf16 within 1e-2; the dead
   row exact zeros);
4. time K3, its plain version and the one-call PyTorch yardstick
   with CUDA events, cold L2, beside the bytes/operations bound, at the
   mixed lengths of phase 3 and at full context (8 rows of 1024);
5. one full-width paged_decode_step through the kernel against the dense
   decode_step, logits within 1e-4 * max|logit|;
6. the serving engine at the full width of the serving bench (GPT 768
   hidden, 12 layers, 6 heads of 128, vocab 32768, 1024 positions; 16
   greedy requests, prompts 64-256, outputs 64-256, staggered arrivals,
   random weights from --seed): every request finishes, the cache audits
   clean, the kernel launched layers x k x chunks times (chunks: the
   decode host syncs), the tokens equal the port's dense generate()
   except where the reference's top-2 logit margin is under 1e-3, and
   the obs registry's TTFT p50 for the engine's label equals
   np.percentile of the requests' TTFTs; then the same traffic with
   request tracing off (obs.reqtrace.disable()), both decode tokens/s
   printed (not gated: the trip is host-bound, so a host cost of tracing
   shows here first);
6a. the same model and engine with the prefix cache on shared-prefix
   traffic (serving_traffic.prefix_traffic: 4 templates of 512 tokens,
   4 leaders then 28 followers in bursts of 7, suffixes 16-64 tokens,
   64-128 new tokens): tokens by phase 6's rule, the audit clean, a
   prefix-cache hit, K3 launched layers x k x chunks times; then the
   same traffic with the cache off (tokens by the same rule; both TTFT
   p50s printed, their ratio not gated);
6b. the same traffic with int8 KV blocks: pools stored as int8, pass
   6a's live f32 KV through the codec within KV_INT8_REL_ERR plus its
   float32 rounding (KV_INT8_ROUNDING), the int8 and f32 pools within
   4 x KV_INT8_REL_ERR of each other on the blocks the two tries share,
   and tokens equal pass 6a's except where 6a's top-2 margin is under
   twice the measured int8 logit divergence (int8_logit_divergence:
   the dense prefill with every layer's K and V through the codec
   against the plain one, over the pass's prompts); decode tokens/s,
   time per chunk and peak memory printed beside 6a's;
6c. the host tier: 192 device blocks, 256 host blocks, 8 templates of
   512 tokens visited in triples and then revisited in one burst
   (serving_traffic.tiered_traffic): demotions and promotion hits,
   the audit clean, tokens by phase 6's rule, promotion latency printed;
6d. multi-tenant WFQ admission: the same model and engine with
   max_prefill_tokens 512, max_waiting 32, the committed prefill cost
   model ("auto"), its own obs label and a fresh TenantRegistry
   (serving_traffic.TENANTS: latency, bulk (batch class) and a burst
   tenant with a 600-token quota over 300 s) on
   serving_traffic.tenant_traffic (load_suite's multi_tenant at block
   32: 16 bulk prompts of 320-448 tokens at step 0, 10 latency prompts
   of 32-72 at steps 1, 3, ..., 19, 6 burst requests of a 192-token
   template plus 16-40 at step 2; 32-64 new tokens each, greedy): every
   admitted request finishes, tokens by phase 6's rule, the audit clean
   (per-tenant census reconciled), K3 launched layers x k x chunks
   times, at least one quota refusal, the latency tenant's TTFT p50 at
   most the bulk tenant's, the admission order read from the trace
   events equal to the scheduler-only replay's
   (serving_traffic.replay_admissions, recomputed here on the host),
   the causality checker clean on the pass's complete dump, and a JSON
   and a Prometheus snapshot written to a temp dir and read back with
   the engine's TTFT count and generated tokens; per-tenant tokens and
   TTFT p50/p99, the TTFT decomposition's medians and the refusals
   printed;
6e. the inference facade: Config().enable_llm_engine(model, the serving
   bench's engine config, max_tokens=32) -> create_predictor -> run on 4
   right-padded prompts of 64-256 tokens: an int64 [4, T_out] result
   whose rows are each prompt followed by the tokens the engine alone
   gives on the card;
7. flash kernels K1 (6 heads of 128) and K2 (12 heads of 64, packed
   pairs) against their plain versions at the GPT train step's attention
   shape (B 32, T 1024, causal), K2 at ERNIE-large's (k2_nc: B 32,
   16 heads of 64 in 8 pairs, T 512, not causal) and K1 at
   Transformer-base's (k1_d64, k1_d64_x, below): out, lse, dq, dk and
   dv in f32, in bf16 and in f16, each held to the limits of FLASH_TOL
   (relative L2 error, and per element against one bf16 ulp of the plain
   value; the bf16 limits derived from the TPU reference kernels' own
   error, the f16 ones from those by the two types' unit roundoffs);
8. their forward and backward timed with CUDA events at those shapes
   (bf16, cold L2; K1 also in f16) beside the plain versions, the
   F.scaled_dot_product_attention yardstick under the same mask
   (forward, and its backward call) and the bound at the bf16 tensor
   peak;
9. the GPT train step at the full width of bench.py's bench_gpt (vocab
   32768, hidden 768, 12 layers, 32 x 1024 tokens, AMP O2 bf16 with f32
   masters, AdamW + global-norm clip, jit.TrainStep) with 6 heads (K1;
   2 warm-up + 10 steps) and 12 heads (K2; 2 + 3): every loss finite,
   the loss falls, LAST_PATH == "flash", 12 forward and 12 backward
   launches per step, the first step's loss within 1e-4 relative of the
   same forward with use_flash_attention off (composed attention), and
   every parameter's gradient on the first GRAD_B rows of the batch
   within GRAD_TOL (relative L2) of the composed route's;
9b. the Paddle eager surface at the same width (train_bench.run_eager,
   2 warm-up + 8 timed steps: `import paddle_tpu_torch as paddle`,
   set_device("gpu"), float32 parameters, AdamW over LinearWarmup(
   CosineAnnealingDecay(1e-4, T_max=1000), 4, 0, 1e-4) with global-norm
   clip, GradScaler(2^15), auto_cast(level="O1") around the loss,
   scale(loss).backward(), scaler.minimize, clear_grad, sched.step, on
   x = tokens[:, :-1], y = tokens[:, 1:] of 32 x 1025 tokens), then
   jit.TrainStep with O1 inside its loss on the same weights and batch:
   tokens/s, MFU, peak memory and GradScaler's scale and skips printed
   for both; it fails unless the losses are finite and fall on both
   routes, every step's eager loss is within EAGER_O1_REL (1e-5)
   relative of TrainStep O1's, K1 launched 12 x 10 forward and 12 x 10
   backward and K2 never, LAST_PATH is "flash" with bf16 q, each step's
   LR equals LinearWarmup's host value, and scaler.minimize (unscale
   and found-inf check, the AdamW step, the scale update) made one
   synchronizing CUDA operation a step, GradScaler's found-inf read
   (torch's sync debug mode, with where it happened); then
   auto_cast(dtype="float16") at 2 layers and batch 4 for 2 steps:
   attention through K1's float16 instance (LAST_PATH "flash", float16
   q, 2 x 2 forward and backward launches), finite losses;
10. K4 (fused BN-apply + ReLU (+ residual) -> 1x1-conv matmul) against
   its plain version at the five ResNet-50 block-boundary geometries of
   paddle_tpu_torch/tools/fused_conv_proto.py (batch 128, its input
   recipe from --seed), to the limits of K4_TOL, bitwise equal to itself
   over a repeat, and timed (CUDA events, cold L2) beside its bound (and
   its share of it), its plain version, the composed torch path and
   torch.matmul alone, with its kernel time under torch.profiler, the
   wrapper's host time, and the tile width, grid and ring depth that
   `k4_tile` chose;
11. K4 on the port's own ResNet-50 (one training-mode bf16 forward at
   batch 128 x 224^2): at the five sites hooks launch it on the captured
   pre-BN conv output, the BN's batch-statistics fold, the identity and
   the next 1x1 conv's weight; its result within K4_MODEL_TOL (relative
   L2) of the model's own next-conv output and within K4_TOL of its
   plain version; 5 launches in the forward. Then, on the same tensors,
   K4 timed beside the model's own boundary as the train step runs it
   in NCHW: the port's BN-apply (the fold of the batch statistics),
   residual add and ReLU, then the next 1x1 convolution (cuDNN). K4's
   time leaves out the copy of its inputs into [N*H*W, C] rows;
12. the ResNet-50 train step at the geometry of bench.py's bench_resnet
   (batch 128 of 3 x 224^2 images cast to bf16 once, labels in [0,
   1000), AMP O2 with f32 masters, Momentum(0.1), jit.TrainStep; 2
   warm-up + 10 timed steps): the first step's loss and per-parameter
   gradients on ROUTE_B images with FLAGS_fuse_bn_act on and off within
   ROUTE_TOL, the running stats all moved and float32 after step 1,
   every loss finite, the loss falls; imgs/s, MFU, step times and peak
   memory printed;
13. the ERNIE-large MLM + NSP train step at the geometry of bench.py's
   bench_ernie (ernie_large(): 24 layers, hidden 1024, 16 heads of 64,
   vocab 18000; 32 x 512 tokens with 77 masked positions a row from
   make_bert_pretrain_batch, AMP O2 bf16, AdamW(1e-4), jit.TrainStep;
   2 warm-up + 15 timed steps, bench_ernie's count): attention through
   K2 non-causal, LAST_PATH == "flash", 24 forward and 24 backward K2
   launches per step and none of K1, the first step's loss within 1e-4
   relative of composed attention's and every parameter's gradient on
   GRAD_B rows within GRAD_TOL of composed attention's (each route also
   read against an f32 composed copy of the model), every loss finite,
   the loss falls; samples/s, MFU (bench.py's FLOPs per sample), step
   times and peak memory printed;
14. the BERT-base MLM + NSP train step at bench_bert's geometry (128 x
   128, 2 warm-up + 10 steps): composed attention (T 128 is under
   flash_attention_min_seq), no flash launch, losses finite and
   falling; samples/s and MFU printed;
15. LeNet at bench_lenet's recipe (batch 64 of 1 x 28^2, Adam(1e-3),
   jit.TrainStep, 100 timed steps) and bench_lenet_multistep's
   (jit.MultiStepTrainStep, K 50): losses finite and falling;
   samples/s of each printed;
16. Transformer-base (paddle_tpu_torch/tools/seq2seq_bench.py: 6 + 6
   layers, d_model 512, 8 heads of 64, d_ff 2048, vocabulary 37000,
   dropout 0.1, label smoothing 0.1, Adam over NoamDecay with global-norm
   clip, O1 bf16, eager, 32 pairs of 512 + 512 tokens; 2 warm-up + 5
   timed steps): the first step's loss within 1e-4 relative of composed
   attention's under the same dropout masks, losses finite and falling,
   K1 12 forward and 12 backward launches a step (encoder
   self-attention and decoder cross-attention, non-causal, head dim 64,
   [B, T, H, D]) and K2 none, LAST_PATH "flash" with bf16 q; then the
   eval encoder (6 K1 forward launches) and a greedy decode of 16 tokens
   for 4 sources through gen_cache equal to the uncached decode;
   tokens/s, MFU (seq2seq_bench.transformer_flops) and peak memory
   printed;
17. the medium LSTM language model (2 x 650, vocabulary 10000, 20 x 35,
   dropout 0.5, SGD(1.0) with clip 5; 2 + 8 steps): losses finite and
   falling; then BeamSearchDecoder (beam 4) under dynamic_decode (20
   steps) over the trained LSTMCells from 8 rows' states: ids and
   parents equal to a CPU run's on the same weights, scores within
   BEAM_SCORE_REL; tokens/s printed;
18. paddle.save / paddle.load of phase 16's model and Adam state into a
   new model and optimizer: the next step's loss and the loss after it
   bitwise equal to the original's; then SGD, Adamax, Adadelta,
   Adagrad, RMSProp (plain and centered), Lamb, Lars and LarsMomentum,
   5 steps each on an MLP on the card and on the CPU from the same
   weights: parameters within OPT_REL, losses falling;
19. MobileNetV2 (scale 1.0, 1000 classes, 224^2) at the recipe of
   Sandler et al. 2018 section 6.1 through tools/train_bench.py: the
   first step on the card against the CPU at batch 4 (FIRST_STEP_TOL:
   the f32 loss within 1e-5, the f32 gradients within twice the f32
   rounding the same run reads against f64, the f64 gradients within
   1e-6), then batch 96 of synthetic images, RMSProp(rho 0.9, momentum
   0.9) at 0.045 under ExponentialDecay(0.98), L2Decay(4e-5), O2 bf16
   through jit.TrainStep, ExponentialMovingAverage(0.9999) after every
   step (2 warm-up + 20 timed steps): losses finite and the last below
   the first timed one, the EMA's shadows equal to the update by hand
   (EMA_TOL), apply() / restore() around an eval forward; imgs/s, MFU
   (3 x 2 x 300 M multiply-adds an image), peak memory, idle share and
   the profile's groups printed;
20. resnet50(data_format="NHWC") on the NCHW model's weights and the
   permuted batch (8 images, check_first_step's limits), the
   space-to-depth stem against the 7x7 one (S2D_TOL), then bench_resnet's
   geometry channel-last (O2, Momentum(0.1), 2 + 10 steps): losses
   finite and their timed mean below the first; imgs/s beside phase
   12's NCHW reading; the profile's convolution and layout-transform
   time for both layouts; no NCHW <-> NHWC transform launched in a
   channel-last step;
21. vgg16(batch_norm=True) at configuration D of Simonyan & Zisserman
   2015, batch 64 (256 over 4 GPUs there), Momentum(0.01, 0.9),
   L2Decay(5e-4), O2 (2 + 40 steps): losses finite and falling; imgs/s,
   MFU, peak memory;
22. every vision functional and layer of slice 6c on the card against
   the CPU on the same inputs, f32 and (convolution, pooling, norms)
   bf16, within VISION_TOL; Momentum, Lookahead and ModelAverage over 5
   steps, card against CPU;
23. the serving fleet (run right after 6e, on phase 6's model and
   engine, chunked prefill over 128 tokens included; every fleet pass
   but 25 decodes 2 tokens a chunk, FLEET_ENGINE): replica failover
   (load_suite's replica_kill): 3 replicas, free-block balancing, 24
   greedy requests (prompts 64-256, 32-64 new tokens, one arrival every
   2 router steps), run with no fault, with kill_replica@6:1 and with
   wedge_replica@8:2 under a heartbeat of twice the no-fault pass's
   longest router step: every request 'length', one failover per
   injected fault (none in the no-fault pass), no replica FAILED, the
   failed replica back up after its warmup probe, every pool audited
   clean, the causality checker clean and each failed-over trace one
   timeline, the card's allocated memory after the restart within one
   pool of its value before the fault and, once each pass's fleet is
   dropped, back at its value at the start of the phase, re-admitted
   requests by phase 6's rule, the requests that never lived on the
   failed replica bitwise equal to the no-fault pass; router TTFT
   p50/p99 and the recovery seconds printed;
24. disaggregated serving (load_suite's disagg): 4 replicas, roles
   prefill, prefill, decode, decode, on a decode floor of 12 requests
   (64-token prompts, 128-192 new tokens, every other one sampled at
   temperature 0.8, top_k 50) and 6 prompts of 512-768 tokens (16-32
   new): every request 'length', handoffs committed, none aborted or
   rolled back, the audits and the causality checker clean, greedy
   tokens by phase 6's rule; then the controlled migration A/B
   (serving_traffic.migration_ab: 8 live requests, greedy and sampled,
   moved to an empty replica by drain(0, recompute=False), 16 router
   steps there) bitwise equal to the same steps in place, in f32 and in
   int8 pools, and a rebalance with the watermark at half the loaded
   replica's use moving at least one request without changing a stream;
   payload bytes, migration seconds p50/p99 and the decode tier's
   inter-token gap p99 printed;
25. phase 6a's traffic on 3 replicas routed by prefix affinity (hit rate
   at least 0.8 x 6a's single engine's) and phase 6c's on 3 round-robin
   replicas with peer prefix fetch (at least one committed fetch),
   tokens by phase 6's rule;
26. the Autoscaler over 4 provisioned replicas on trickle, burst,
   trickle arrivals (load_suite's autoscale_diurnal): at least one
   shrink by evacuating drain and one grow by probe rejoin, every
   request 'length'; the active count per router step printed;
27. rolling deploys (load_suite's rolling_deploy): ModelRegistry.publish
   of the serving model and of models from --seed + 1 and + 2,
   ReplicaSet.from_registry over 3 replicas sharing each revision's
   weights; a DeployController rollout under live traffic
   (canary_tolerance 3) commits with live KV migrated, every request
   that finished pinned to the old revision bitwise equal to a no-deploy
   fleet on the old weights; the second candidate under the strict
   default tolerance rolls back; nothing lost and the causality checker
   (revision pinning, invariant 8) clean on both dumps; the rollback is
   the canary gate's verdict (at least one prompt diverged), not a
   canary that raised.
In each of 23-27 (and in the A/B and rebalance fleets of 24) the router
failed over exactly the faults the pass injected (none outside 23), no
replica ended FAILED, no migration or peer fetch aborted or rolled back,
and the card's allocated memory after the phase is back at its value
before it. In each, K3 launched layers x 2 (or 8) x the decode chunks
that every engine of the phase ran (replicas, restarted incarnations,
probes, canaries, reference engines).
Phases 7-8 also hold and time K1 at head dim 64 non-causal on [B, T, H,
D] views at Transformer-base's shape (k1_d64: B 32, 8 heads, T 512) and
at a cross shape (k1_d64_x: 512 queries, 768 keys).

The last three lines are: one JSON object with each kernel's numbers
(K4's times summed over the five geometries; K2's non-causal forward and
backward as entries of their own, with their launches from phase 13;
K1 at head dim 64 likewise, with its launches from phase 16; K1's
entries also carry `eager_launches`, phase 9b's counts, and
`transformer_launches`, phase 16's; K3's carries `pass_launches`,
6a-6d's, and `fleet_launches`, 23-27's),
the card's name and power limit, and {"ok": true, "device": {...}}.
float32 matmuls and convolutions run in full float32 (TF32 off)
throughout.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

from paddle_tpu_torch.tools.engine_bench import K3_SHAPE
from paddle_tpu_torch.tools.measure import K3_MIXED_LENGTHS, card_line

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor
# FLOP/s, bf16 dense tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# the serving slice's kernel shapes, those of the engine that phase 6
# drives: max_num_seqs rows, the model's heads and head_dim, the engine's
# block size and pool, and max_seq_len / block_size table columns
N, H, D, BS, NB, MB = K3_SHAPE
LENGTHS = K3_MIXED_LENGTHS


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


# ------------------------------------------------------------ phase 2
def kernel_label(mangled: str) -> str:
    """'fa_fwd_wgmma_kernel<bf16, 128>' or 'fa_delta_kernel<f32, 64>'
    from a mangled flash kernel name."""
    m = re.search(r"(fa_(?:fwd|bwd|delta)\w*?_kernel)I(.*?)EE", mangled)
    if m is None:
        return mangled
    name, args = m.groups()
    dtype = ("bf16, " if "bfloat16" in args
             else "f16, " if "__half" in args
             else "f32, " if args.startswith("f") else "")
    return f"{name}<{dtype}{','.join(re.findall(r'Li(\d+)E', args + 'E'))}>"


def ptxas_table(report: str) -> dict:
    """{mangled entry: (registers, spill store bytes, spill load bytes,
    static shared memory bytes)} from a `ptxas -v` report."""
    out, entry, spill = {}, None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry] = (int(m.group(1)), *spill,
                          int(smem.group(1)) if smem else 0)
            entry = None
    return out


SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS")


def sass_counts(library: str) -> dict:
    """{mangled kernel: {op: count}} for SASS_OPS, from cuobjdump's
    disassembly of a built library."""
    from paddle_tpu_torch.ops.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", library],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    out[name][op] += 1
    return out


def build_kernels() -> None:
    """Build every kernel; print what ptxas reports, and for the flash
    kernels each one's registers and spills and, in the 16-bit ones
    (bf16 and f16), the count of wgmma (HGMMA) and of TMA (UTMALDG) /
    cp.async (LDGSTS) loads in their SASS. Fails if a 16-bit forward or
    backward kernel issues no wgmma or loads its tiles by neither
    route."""
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"[build] {len(reports)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f} s: {', '.join(reports)}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "ptxas" in line and (name == "ragged_paged_attention"
                                    or "Performance Loss" in line):
                print(f"[build] {name}: {line.strip()}")
    for entry, (regs, st, ld, smem) in sorted(
            ptxas_table(reports["ragged_paged_attention"]).items()):
        dtype = "bf16" if "bfloat16" in entry else "f32"
        dmax = 32 * int(re.search(r"ragged_split_kernelI\w+?Li(\d+)E",
                                  entry).group(1))
        ring = (f" + the ring's {k3_ring_bytes(4 if dtype == 'f32' else 2)}"
                f" B dynamic at D {D}, block {BS}" if dmax == D else "")
        print(f"[build] ragged_paged_attention: ragged_split_kernel<{dtype}, "
              f"D <= {dmax}>: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B, static shared memory {smem} B{ring}")
    for entry, (regs, st, ld, _) in sorted(
            ptxas_table(reports["flash_attention"]).items(),
            key=lambda kv: kernel_label(kv[0])):
        print(f"[build] flash_attention: {kernel_label(entry)}: {regs} "
              f"registers, spill stores {st} B, spill loads {ld} B")
    counts = sass_counts(str(_build.library_path("flash_attention")))
    hopper = {kernel_label(k): c for k, c in counts.items()
              if "wgmma_kernel" in k}
    for label, c in sorted(hopper.items()):
        print(f"[build] SASS {label}: " + ", ".join(
            f"{op} {n}" for op, n in c.items()))
    # forward, dq and dk/dv at D 64 and 128, in bf16 and in f16
    _require(len(hopper) == 12, f"16-bit flash kernels in the SASS: "
                                f"{sorted(hopper)}")
    for label, c in hopper.items():
        _require(c["HGMMA"] > 0 and c["UTMALDG"] + c["LDGSTS"] > 0,
                 f"{label} lacks wgmma or asynchronous loads: {c}")
    k4_build_report(reports["fused_conv"])


def k4_label(mangled: str) -> str:
    """'fused_scale_relu_matmul_kernel<256, residual>' from a mangled K4
    instance name."""
    m = re.search(r"fused_scale_relu_matmul_kernelILi(\d+)ELb([01])E",
                  mangled)
    if m is None:
        return mangled
    return (f"fused_scale_relu_matmul_kernel<{m.group(1)}, "
            f"{'residual' if m.group(2) == '1' else 'no residual'}>")


def k4_build_report(report: str) -> None:
    """K4's instances: registers and spills (ptxas), the ring at the
    five geometries on this card (k4_tile, k4_ring), HGMMA and UTMALDG
    in the SASS; fails if an instance lacks wgmma or TMA loads."""
    import torch
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.fused_conv import k4_ring, k4_tile
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import sm_count
    from paddle_tpu_torch.tools.fused_conv_proto import BATCH, GEOMETRIES
    for entry, (regs, st, ld, smem) in sorted(
            ptxas_table(report).items(), key=lambda kv: k4_label(kv[0])):
        print(f"[build] fused_conv: {k4_label(entry)}: {regs} registers, "
              f"spill stores {st} B, spill loads {ld} B, static shared "
              f"memory {smem} B")
    sms = sm_count(torch.device("cuda"))
    for name, hw, cin, cout, res in GEOMETRIES:
        bn, grid = k4_tile(BATCH * hw, cin, cout, sms, res)
        stages, nbytes = k4_ring(cin, bn, res)
        print(f"[build] fused_conv: {name}: tile 128 x {bn}, grid {grid} "
              f"of {sms} SMs, ring {stages} stages, {nbytes} B dynamic "
              f"shared memory")
    counts = {k4_label(k): c for k, c in sass_counts(
        str(_build.library_path("fused_conv"))).items()
        if "fused_scale_relu_matmul_kernel" in k}
    for label, c in sorted(counts.items()):
        print(f"[build] SASS {label}: HGMMA {c['HGMMA']}, UTMALDG "
              f"{c['UTMALDG']}")
    _require(len(counts) == 6, f"K4 instances in the SASS: {sorted(counts)}")
    for label, c in counts.items():
        _require(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
                 f"{label} lacks wgmma or TMA loads: {c}")


# ------------------------------------------------------------ phase 3-4
FULL_LENGTHS = (MB * BS,) * N


def k3_ring_bytes(elem: int) -> int:
    """K3's dynamic shared memory at the serving shape: 2 stages of K and
    V tiles (up to 16 KB each), or the 8 warps' f32 accumulators if
    larger."""
    tile = min(BS, 16384 // (D * elem))
    return max(2 * 2 * tile * D * elem, 8 * D * 4)


def k3_inputs(device, dtype, seed: int, lengths=LENGTHS):
    from paddle_tpu_torch.tools.measure import k3_inputs as inputs
    return inputs(device, dtype, seed, lengths, N, H, D, BS, NB, MB)


def check_k3(device, seed: int) -> float:
    """K3 against both plain versions in f32 and bf16; returns the f32
    max |err| (the larger of the two comparisons)."""
    import torch
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        default_blocks_per_split, ragged_attention_reference,
        ragged_attention_split_reference, ragged_decode_attention, sm_count)
    bps = default_blocks_per_split(N, H, MB, sm_count(torch.device(device)))
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        args = k3_inputs(device, dtype, seed)
        got = ragged_decode_attention(*args)
        torch.cuda.synchronize()
        for name, want in (
                ("plain", ragged_attention_reference(*args)),
                (f"split plain ({bps} blocks a split)",
                 ragged_attention_split_reference(*args, bps))):
            err = (got.float() - want.float()).abs().max().item()
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            print(f"[k3] kernel vs {name}, {str(dtype)[6:]} pools: max "
                  f"|err| {err:.3e} (tolerance {tol:g})")
            _require(err <= tol, f"K3 disagrees with its {name} version "
                                 f"in {dtype}: {err} > {tol}")
        _require(bool(torch.all(got[0] == 0)), "K3 dead row is not zero")
    return errs[torch.float32]


def k3_bound(lengths) -> tuple:
    """(bound ms, "bytes" or "operations", bytes, flops) of one K3 call:
    the live K and V once, q and out, the live table entries and the
    lengths; 4 flops per live (position, head, d)."""
    from paddle_tpu_torch.tools.measure import bound
    live = sum(lengths)
    nbytes = (live * H * D * 2 * 4 + 2 * N * H * D * 4
              + sum(-(-n // BS) for n in lengths) * 4 + N * 4)
    flops = 4 * live * H * D
    return (*bound(nbytes, flops, F32_FLOPS), nbytes, flops)


def time_k3(device, seed: int, lengths=LENGTHS, label="mixed") -> dict:
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.inference.serving import gather_block_kv
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_attention_reference, ragged_decode_attention)
    from paddle_tpu_torch.tools.measure import cold_ms
    q, kp, vp, tables, lengths_t = k3_inputs(device, torch.float32, seed,
                                             lengths)
    ms = cold_ms(lambda: ragged_decode_attention(q, kp, vp, tables,
                                                 lengths_t), 50)
    plain_ms = cold_ms(lambda: ragged_attention_reference(
        q, kp, vp, tables, lengths_t), 10)
    # yardstick only (never called by the port): SDPA over the context
    # gathered beforehand, masked by length; the gather is not timed
    kc, vc = gather_block_kv(kp, tables), gather_block_kv(vp, tables)
    mask = (torch.arange(MB * BS, device=device)[None, :]
            < lengths_t[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = cold_ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask), 50)
    bound_ms, bound_by, nbytes, flops = k3_bound(lengths)
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[k3] timing, {label} lengths (cold L2, mean): kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, SDPA yardstick {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} "
          f"MB, {flops / 1e9:.3f} GFLOP); {bound_ms / ms:.1%} of the bound")
    return out


# ------------------------------------------------------------ phase 5
def check_logits(model, device, seed: int, lens=(37, 100, 250, 513),
                 block_size=BS, num_blocks=64) -> float:
    """One batched paged_decode_step through the ragged kernel against
    each row's own dense decode_step. Returns the worst error relative
    to max|logit|."""
    import numpy as np
    import torch
    import paddle_tpu_torch.models.generation as gen
    from paddle_tpu_torch.inference.serving import (PagedKVCache,
                                                    paged_decode_step)
    geom = model.cfg.geom
    L, Hh, Dd, S = geom
    params = gen.extract_params(model)
    rng = np.random.RandomState(seed)
    cache = PagedKVCache(L, Hh, Dd, num_blocks, block_size, device=device)
    dense, toks = [], []
    for b, n in enumerate(lens):
        p = rng.randint(0, model.cfg.vocab_size, (1, n)).astype(np.int32)
        logits, dc = gen.prefill(params, torch.from_numpy(p), geom)
        cache.allocate(b, n)
        cache.write_prefill(b, dc, n)
        dense.append(dc)
        toks.append(int(logits[0].argmax()))
    slots = [cache.append_slot(b) for b in range(len(lens))]
    tables = np.zeros((len(lens), S // block_size), np.int32)
    for b in range(len(lens)):
        t = cache.block_table(b)
        tables[b, :len(t)] = t
    paged, _ = paged_decode_step(
        params, cache.pools, np.asarray(toks, np.int32),
        np.asarray(lens, np.int32), tables,
        np.asarray([s[0] for s in slots], np.int32),
        np.asarray([s[1] for s in slots], np.int32), geom, kernel="ragged")
    worst = 0.0
    for b, n in enumerate(lens):
        ref, _ = gen.decode_step(params, dense[b], [toks[b]], n, geom)
        scale = ref.abs().max().item()
        err = (paged[b] - ref[0]).abs().max().item() / scale
        worst = max(worst, err)
    print(f"[logits] paged_decode_step via K3 vs dense decode_step, rows "
          f"{list(lens)}: max |err| / max|logit| = {worst:.3e}")
    _require(worst <= 1e-4, f"paged logits disagree: {worst} > 1e-4")
    return worst


# ------------------------------------------------------------ phase 6
def check_engine_outputs(model, eng, rids, specs, refs=None) -> int:
    """Every request finished and no table holds a block (blocks the
    prefix trie retains are evictable); the cache audits clean. Greedy
    tokens equal the port's dense generate() except where the dense
    reference's top-2 margin is under 1e-3. `refs`, when given, caches
    the references by position in specs. Returns how many requests
    parted."""
    import numpy as np
    import paddle_tpu_torch.models.generation as gen
    eng.cache.check_integrity()
    _require(eng.cache.num_used() == eng.cache.num_evictable(),
             "blocks still held by a table after the drain")
    refs = {} if refs is None else refs
    parted = 0
    for i, (rid, (prompt, max_tokens)) in enumerate(zip(rids, specs)):
        req = eng.get_request(rid)
        _require(req.state in ("finished_length", "finished_stopped"),
                 f"{rid} ended {req.state}")
        got = np.asarray(req.output_ids)
        if i not in refs:
            refs[i] = gen.generate(model, prompt[None],
                                   max_tokens)[0, len(prompt):]
        ref = refs[i]
        _require(got.shape == ref.shape and np.all(got >= 0),
                 f"{rid}: {got.shape} tokens, want {ref.shape}")
        t = _first_difference(got, ref)
        if t is not None:
            margin = top2_margin(model, prompt, ref[:t])
            print(f"[engine] {rid} parts from dense generate() at token {t} "
                  f"(reference top-2 margin {margin:.3e})")
            _require(margin < 1e-3, f"{rid} parted at a clear margin")
            parted += 1
    return parted


def _first_difference(got, ref):
    import numpy as np
    diff = np.nonzero(np.asarray(got) != np.asarray(ref))[0]
    return int(diff[0]) if diff.size else None


def top2_margin(model, prompt, tokens) -> float:
    """Top-2 margin of the dense f32 next-token logits after prompt +
    tokens."""
    import numpy as np
    import torch
    import paddle_tpu_torch.models.generation as gen
    ctx = np.concatenate([prompt, tokens]).astype(np.int32)[None]
    logits, _ = gen.prefill(gen.extract_params(model), torch.from_numpy(ctx),
                            model.cfg.geom)
    top2 = torch.topk(logits[0], 2).values
    return (top2[0] - top2[1]).item()


def check_registry_ttft(eng, ttft) -> None:
    """The obs registry's TTFT histogram for the engine's label holds
    every request's TTFT: its p50 equals np.percentile of them."""
    import numpy as np
    from paddle_tpu_torch import obs
    hist = obs.REGISTRY.get("serving_ttft_seconds").get(
        engine=eng.stats.label)
    want = float(np.percentile(ttft, 50))
    got = hist.quantile(0.5)
    print(f"[engine] registry TTFT p50 for {eng.stats.label}: "
          f"{got * 1e3:.4f} ms over {hist.count} requests; np.percentile "
          f"{want * 1e3:.4f} ms")
    _require(hist.count == len(ttft) and got == want,
             "the registry's TTFT histogram disagrees with the requests")


def tracing_off(model, ecfg, specs, device, on_tps: float) -> None:
    """Phase 6's traffic again with request tracing off; both decode
    tokens/s printed, the decode host syncs still one a chunk."""
    import torch
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_decode_attention)
    from paddle_tpu_torch.tools.serving_traffic import drive_engine
    obs.reqtrace.disable()
    try:
        ragged_decode_attention.launches = 0
        eng, _ = drive_engine(model, ecfg, specs, device)
    finally:
        obs.reqtrace.enable()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    d = eng.stats.as_dict()
    chunks = eng.stats.host_syncs("decode")
    L, k = model.cfg.num_layers, ecfg.decode_chunk_size
    want = L * k * chunks if torch.device(device).type == "cuda" else 0
    _require(ragged_decode_attention.launches == want,
             f"tracing off: K3 launched {ragged_decode_attention.launches}"
             f" times, expected {want}")
    _require(not obs.reqtrace.events(prefix=f"tr-{eng.stats.label}-"),
             "tracing off: the ring recorded events")
    print(f"[engine] request tracing on / off: decode tokens/s "
          f"{on_tps:.1f} / {d['decode_tokens_per_sec']:.1f} (ratio "
          f"{on_tps / d['decode_tokens_per_sec']:.4f}; not gated), "
          f"{chunks} chunks")
    del eng
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 6a-c
# the shared-prefix passes: the serving bench's model and engine with
# the prefix cache (a), then int8 KV blocks (b), then the host tier (c)
# (traffic arguments beyond the defaults of serving_traffic's
# prefix_traffic and tiered_traffic, and the tiered pass's engine
# changes; a CPU rehearsal shrinks them)
PREFIX_TRAFFIC: dict = {}
TIERED_TRAFFIC: dict = {}
TIERED_ENGINE = dict(num_blocks=192, host_tier_blocks=256, max_num_seqs=8)
# the tenant pass's traffic arguments beyond tenant_traffic's defaults,
# and the facade's prompts (count, length range) and new tokens (a CPU
# rehearsal shrinks them)
TENANT_TRAFFIC: dict = {}
FACADE = dict(n=4, p_lo=64, p_hi=256, max_tokens=32)


def _drive_pass(name, model, ecfg, arrivals, device) -> dict:
    """One serving pass: the K3 launch count set to 0 just before it and
    read just after, wall seconds, decode tokens/s, TTFT p50/p99 and the
    pass's own peak device memory over what was allocated before it."""
    import torch
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_decode_attention)
    from paddle_tpu_torch.tools.serving_traffic import drive_arrivals
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    shared = [0]

    def note_sharing(eng):                   # blocks several tables name
        if eng.cache.prefix_index is not None:
            shared[0] = max(shared[0],
                            eng.cache.prefix_stats()["shared_blocks"])

    ragged_decode_attention.launches = 0
    t0 = time.perf_counter()
    eng, rids = drive_arrivals(model, ecfg, arrivals, device,
                               after_step=note_sharing)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_decode_attention.launches
    chunks = eng.stats.host_syncs("decode")
    L = model.cfg.num_layers
    # on the CPU K3's wrapper runs its plain version and counts nothing
    want = L * ecfg.decode_chunk_size * chunks if cuda else 0
    _require(launches == want and (launches > 0 or not cuda),
             f"pass {name}: K3 launched {launches} times, expected {want} "
             f"({L} layers x {ecfg.decode_chunk_size} trips x {chunks} "
             f"chunks)")
    d = eng.stats.as_dict()
    card = card_line() if cuda else "the CPU"
    out = {"engine": eng, "rids": rids, "launches": launches,
           "max_shared_blocks": shared[0],
           "chunks": chunks, "wall_s": wall,
           "decode_tokens_per_sec": d["decode_tokens_per_sec"],
           "chunk_ms": d["time_decode"] / max(chunks, 1) * 1e3,
           "ttft_p50_ms": eng.stats.ttft_quantile(0.5) * 1e3,
           "ttft_p99_ms": eng.stats.ttft_quantile(0.99) * 1e3,
           "peak_mb": (torch.cuda.max_memory_allocated() - base) / 2**20
           if cuda else float("nan")}
    print(f"[{name}] {len(rids)} requests, {d['generated_tokens']} tokens, "
          f"{d['steps']} steps, {chunks} chunks, {d['preemptions']} "
          f"preemptions, wall {wall:.3f} s; decode tokens/s "
          f"{out['decode_tokens_per_sec']:.1f}, {out['chunk_ms']:.2f} ms a "
          f"chunk; TTFT p50 {out['ttft_p50_ms']:.1f} ms, p99 "
          f"{out['ttft_p99_ms']:.1f} ms; peak memory over the pass's start "
          f"{out['peak_mb']:.1f} MiB; K3 launches {launches} = {L} x "
          f"{ecfg.decode_chunk_size} x {chunks}; on {card}")
    return out


def _trie_pairs(idx_a, idx_b):
    """(block in a, block in b) for every device-resident trie node whose
    token path the two tries share."""
    pairs, stack = [], [(idx_a.root, idx_b.root)]
    while stack:
        na, nb = stack.pop()
        for key, ca in na.children.items():
            cb = nb.children.get(key)
            if cb is None:
                continue
            if ca.tier == "device" and cb.tier == "device":
                pairs.append((ca.block, cb.block))
            stack.append((ca, cb))
    return pairs


def _tile_rel_err(got, want) -> float:
    """Worst per-(block, head) error of got against want ([n, bs, H, D]),
    relative to the tile's absmax in want."""
    import torch
    absmax = want.abs().amax(dim=(1, 3), keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / absmax).max())


def _prefill_kv_roundtrip(params, ids, geom, block_size):
    """The dense prefill with every layer's K and V passed through the
    int8 block codec (per block_size positions and head) before the
    attention reads them, as the int8 engine stores them; returns the
    last-position logits [B, V]."""
    import torch
    import paddle_tpu_torch.models.generation as gen
    from paddle_tpu_torch.inference.serving import kv_quant
    L, Hh, Dd, S = geom
    B, T = ids.shape
    x = gen._embed(params, ids, 0)
    ar_s = torch.arange(S, device=ids.device)
    causal = (torch.arange(T, device=ids.device)[:, None] >= ar_s[None, :]) \
        & (ar_s[None, :] < T)
    nblk = -(-T // block_size)

    def roundtrip(kv):                       # [B, H, T, D]
        blk = x.new_zeros(B, Hh, nblk * block_size, Dd)
        blk[:, :, :T] = kv
        tiles = blk.permute(0, 2, 1, 3).reshape(B * nblk, block_size, Hh, Dd)
        back = kv_quant.kv_block_roundtrip(tiles)
        return back.reshape(B, nblk * block_size, Hh, Dd).permute(0, 2, 1, 3)

    for i in range(L):
        qkv = gen._qkv_proj(params, i, x, geom)
        kc, vc = roundtrip(qkv[1]), roundtrip(qkv[2])
        kfull = x.new_zeros(B, Hh, S, Dd)
        vfull = x.new_zeros(B, Hh, S, Dd)
        kfull[:, :, :nblk * block_size] = kc
        vfull[:, :, :nblk * block_size] = vc
        x = gen._block(params, i, x, qkv[0], kfull, vfull, causal, geom)
    x = gen._ln(x, params["ln_f.weight"], params["ln_f.bias"])
    return x[:, -1] @ params["lm_head.weight"]


def int8_logit_divergence(model, prompts, block_size) -> float:
    """The largest |logit| change that int8 KV blocks make: over the given
    prompts, max over the vocabulary of the last-position logits of the
    dense f32 prefill against `_prefill_kv_roundtrip`'s."""
    import torch
    import paddle_tpu_torch.models.generation as gen
    params = gen.extract_params(model)
    dev = params["wte.weight"].device
    worst = 0.0
    for p in prompts:
        ids = torch.as_tensor(p[None], device=dev)
        ref, _ = gen.prefill(params, ids, model.cfg.geom)
        q = _prefill_kv_roundtrip(params, ids, model.cfg.geom, block_size)
        worst = max(worst, (q - ref).abs().max().item())
    return worst


def run_prefix_passes(model, ecfg, device, seed: int) -> dict:
    """Phases 6a-6c; returns K3's launches in each pass, counted from 0
    just before it."""
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import kv_quant
    from paddle_tpu_torch.tools.serving_traffic import (prefix_traffic,
                                                        tiered_traffic)
    vocab, bs = model.cfg.vocab_size, ecfg.block_size
    # (a) the prefix cache on the shared-prefix traffic, then cache off
    arrivals = prefix_traffic(vocab, seed + 2, **PREFIX_TRAFFIC)
    specs = [(p, mt) for _, p, mt in arrivals]
    a = _drive_pass("prefix", model, dataclasses.replace(
        ecfg, enable_prefix_cache=True), arrivals, device)
    eng_a = a["engine"]
    ps = eng_a.cache.prefix_stats()
    print(f"[prefix] prefix_stats: hits {ps['hits']}, misses "
          f"{ps['misses']}, cached_tokens_ratio "
          f"{ps['cached_tokens_ratio']:.4f}, shared_blocks {ps['shared_blocks']}"
          f" after the drain and {a['max_shared_blocks']} at most after a "
          f"step, cow_forks {ps['cow_forks']}, evictions {ps['evictions']}, "
          f"cached_blocks {ps['cached_blocks']}")
    _require(eng_a.stats.prefix_counter("hits") > 0,
             "pass prefix: no prefix-cache hit")
    # phase 25 holds the fleet to this hit rate and reuses the references
    READINGS.clear()
    READINGS["prefix_hit_rate"] = ps["hits"] / (ps["hits"] + ps["misses"])
    refs = READINGS["prefix_refs"] = {}
    parted = check_engine_outputs(model, eng_a, a["rids"], specs, refs)
    print(f"[prefix] greedy tokens vs dense generate(): {parted} of "
          f"{len(specs)} requests parted (each at a top-2 margin < 1e-3)")
    off = _drive_pass("prefix, cache off", model, ecfg, arrivals, device)
    parted = check_engine_outputs(model, off["engine"], off["rids"], specs,
                                  refs)
    print(f"[prefix] cache off: {parted} requests parted; TTFT p50 cache on "
          f"{a['ttft_p50_ms']:.1f} ms, off {off['ttft_p50_ms']:.1f} ms "
          f"(off / on {off['ttft_p50_ms'] / a['ttft_p50_ms']:.3f})")
    del off
    torch.cuda.empty_cache()

    # (b) int8 KV blocks on the same traffic, held against pass (a)
    b = _drive_pass("int8", model, dataclasses.replace(
        ecfg, enable_prefix_cache=True, kv_cache_dtype="int8"), arrivals,
        device)
    eng_b = b["engine"]
    stored = eng_b.cache.stored_pools()
    _require(all(q.dtype == torch.int8 for (qk, qv), _ in stored
                 for q in (qk, qv)), "pass int8: pools not stored as int8")
    eng_b.cache.check_integrity()
    pairs = _trie_pairs(eng_a.cache.prefix_index, eng_b.cache.prefix_index)
    _require(len(pairs) > 0, "pass int8: the tries share no block")
    ia = torch.as_tensor([p for p, _ in pairs], device=device)
    ib = torch.as_tensor([q for _, q in pairs], device=device)
    codec = div = 0.0
    for (ka, va), (kb, vb) in zip(eng_a.cache.pools, eng_b.cache.pools):
        for xa, xb in ((ka, kb), (va, vb)):
            codec = max(codec, _tile_rel_err(
                kv_quant.kv_block_roundtrip(xa[ia]), xa[ia]))
            div = max(div, _tile_rel_err(xb[ib], xa[ia]))
    bound = kv_quant.KV_INT8_REL_ERR
    codec_limit = bound + kv_quant.KV_INT8_ROUNDING
    print(f"[int8] pass (a)'s live f32 KV through the codec: worst tile "
          f"error {codec:.7e} of its absmax (bound {bound:.7e} + float32 "
          f"rounding {kv_quant.KV_INT8_ROUNDING:.3e}); int8 vs f32 pools on "
          f"{len(pairs)} shared trie blocks: {div:.4e} (limit 4 x bound = "
          f"{4 * bound:.4e})")
    _require(codec <= codec_limit, "codec error over its bound")
    _require(div <= 4 * bound, "int8 pools diverge past 4 x the bound")
    delta = int8_logit_divergence(model, [p for p, _ in specs], bs)
    parted = 0
    for i, (prompt, _mt) in enumerate(specs):
        got = np.asarray(eng_b.get_request(b["rids"][i]).output_ids)
        want = np.asarray(eng_a.get_request(a["rids"][i]).output_ids)
        _require(got.shape == want.shape, f"int8 request {i}: "
                                          f"{got.shape} tokens")
        t = _first_difference(got, want)
        if t is not None:
            margin = top2_margin(model, prompt, want[:t])
            print(f"[int8] request {i} parts from pass (a) at token {t} "
                  f"(top-2 margin {margin:.3e}, 2 x divergence "
                  f"{2 * delta:.3e})")
            _require(margin < 2 * delta, f"int8 request {i} parted at a "
                                         f"margin over 2 x the divergence")
            parted += 1
    print(f"[int8] tokens vs pass (a): {parted} of {len(specs)} requests "
          f"parted, each where pass (a)'s top-2 margin is under 2 x the "
          f"measured int8 logit divergence {delta:.4e}")
    print(f"[int8] beside pass (a): decode tokens/s "
          f"{b['decode_tokens_per_sec']:.1f} vs "
          f"{a['decode_tokens_per_sec']:.1f}, {b['chunk_ms']:.2f} vs "
          f"{a['chunk_ms']:.2f} ms a chunk, peak memory {b['peak_mb']:.1f} "
          f"vs {a['peak_mb']:.1f} MiB")
    launches = {"prefix": a["launches"], "int8": b["launches"]}
    del a, b, eng_a, eng_b
    torch.cuda.empty_cache()

    # (c) the host tier: more templates than the pool holds
    arrivals = tiered_traffic(vocab, seed + 3, **TIERED_TRAFFIC)
    specs = [(p, mt) for _, p, mt in arrivals]
    c = _drive_pass("tiered", model, dataclasses.replace(
        ecfg, enable_prefix_cache=True, **TIERED_ENGINE), arrivals, device)
    eng_c = c["engine"]
    demoted = eng_c.stats.tier_demotions()
    promo = {o: eng_c.stats.promotion_counter(o)
             for o in ("hit", "timeout", "integrity", "raced")}
    print(f"[tiered] demotions {demoted}, promotions {promo}; promote "
          f"latency p50 {eng_c.stats.promote_quantile(0.5) * 1e3:.2f} ms, "
          f"p99 {eng_c.stats.promote_quantile(0.99) * 1e3:.2f} ms; host "
          f"blocks now {eng_c.cache.prefix_stats()['host_blocks']}")
    _require(demoted > 0, "pass tiered: nothing demoted")
    _require(promo["hit"] > 0, "pass tiered: no promotion hit")
    parted = check_engine_outputs(model, eng_c, c["rids"], specs,
                                  READINGS.setdefault("tiered_refs", {}))
    print(f"[tiered] greedy tokens vs dense generate(): {parted} of "
          f"{len(specs)} requests parted (each at a top-2 margin < 1e-3)")
    launches["tiered"] = c["launches"]
    del c, eng_c
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 6d
def _read_back(path_json, path_prom, label):
    """(TTFT count, generated tokens) of engine `label` from a JSON
    snapshot and a Prometheus text page written to disk."""
    snap = json.loads(Path(path_json).read_text())
    fams = {m["name"]: m for m in snap["metrics"]}
    ttft = next(s for s in fams["serving_ttft_seconds"]["series"]
                if s["labels"] == {"engine": label})
    gen = next(s for s in fams["serving_events_total"]["series"]
               if s["labels"] == {"engine": label,
                                  "event": "generated_tokens"})
    lines = Path(path_prom).read_text().splitlines()
    prom_count = next(
        int(line.split()[-1]) for line in lines
        if line.startswith(f'serving_ttft_seconds_count{{engine="{label}"}}'))
    prom_gen = next(
        float(line.split()[-1]) for line in lines
        if line.startswith(f'serving_events_total{{engine="{label}",'
                           f'event="generated_tokens"}}'))
    return (ttft["count"], gen["value"]), (prom_count, prom_gen)


def run_tenant_pass(model, ecfg, device, seed: int) -> int:
    """Phase 6d; returns K3's launches in the pass, counted from 0 just
    before it."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.analysis import jaxplan
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_decode_attention)
    from paddle_tpu_torch.tools.serving_traffic import (
        TENANT_ENGINE, drive_tenants, make_tenant_registry,
        replay_admissions, tenant_traffic)
    cuda = torch.device(device).type == "cuda"
    arrivals = tenant_traffic(model.cfg.vocab_size, seed + 4,
                              **TENANT_TRAFFIC)
    tcfg = dataclasses.replace(ecfg, **TENANT_ENGINE,
                               tenants=make_tenant_registry(serving))
    ragged_decode_attention.launches = 0
    t0 = time.perf_counter()
    eng, by_tenant, quota, rejected = drive_tenants(model, tcfg, arrivals,
                                                    device)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_decode_attention.launches
    chunks = eng.stats.host_syncs("decode")
    L, k = model.cfg.num_layers, tcfg.decode_chunk_size
    want = L * k * chunks if cuda else 0
    _require(launches == want and (launches > 0 or not cuda),
             f"pass tenant: K3 launched {launches} times, expected {want}")
    label = eng.stats.label
    d = eng.stats.as_dict()
    print(f"[tenant] {len(arrivals)} arrivals, {d['completed']} completed, "
          f"{d['generated_tokens']} tokens, {d['steps']} steps, {chunks} "
          f"chunks, {d['preemptions']} preemptions, wall {wall:.3f} s; "
          f"decode tokens/s {d['decode_tokens_per_sec']:.1f}; K3 launches "
          f"{launches} = {L} x {k} x {chunks}; refused: quota "
          f"{len(quota)} {quota}, deadline {eng.scheduler.deadline_rejects},"
          f" queue {len(rejected)}")
    # every admitted request finished, tokens by phase 6's rule, the
    # audit (with the per-tenant census) clean
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    admitted = {rid for rids in by_tenant.values() for rid in rids}
    pairs = [(f"req-{n}", arrivals[i]) for n, i in enumerate(order)
             if f"req-{n}" in admitted]
    audit = eng.cache.check_integrity()
    parted = check_engine_outputs(model, eng, [r for r, _ in pairs],
                                  [(a[1], a[2]) for _, a in pairs])
    print(f"[tenant] audit {audit}; greedy tokens vs dense generate(): "
          f"{parted} of {len(pairs)} requests parted (each at a top-2 "
          f"margin < 1e-3)")
    _require(len(quota) >= 1, "pass tenant: no quota refusal")
    # fairness, from the trace
    events = [e.as_dict() for e in obs.reqtrace.events(
        prefix=f"tr-{label}-")]
    by = obs.reqtrace.ttft_by_tenant(events)
    for t in sorted(by_tenant):
        ttft = np.array([eng.get_request(r).first_token_time
                         - eng.get_request(r).arrival_time
                         for r in by_tenant[t]])
        toks = sum(len(eng.get_request(r).output_ids) for r in by_tenant[t])
        print(f"[tenant] {t}: {len(by_tenant[t])} admitted, {toks} tokens, "
              f"TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms, p99 "
              f"{np.percentile(ttft, 99) * 1e3:.1f} ms; trace median "
              f"{by[t]['ttft_s'] * 1e3:.1f} ms (queue "
              f"{by[t]['queue_s'] * 1e3:.1f}, prefill "
              f"{by[t]['prefill_s'] * 1e3:.1f}, first gap "
              f"{by[t]['first_gap_s'] * 1e3:.1f})")
    dec = obs.reqtrace.ttft_decomposition(events)
    print(f"[tenant] TTFT decomposition medians over {int(dec['n'])} "
          f"requests: queue {dec['queue_s'] * 1e3:.1f} ms, prefill "
          f"{dec['prefill_s'] * 1e3:.1f} ms, first gap "
          f"{dec['first_gap_s'] * 1e3:.1f} ms, TTFT "
          f"{dec['ttft_s'] * 1e3:.1f} ms")
    ratio = by["latency"]["ttft_s"] / by["bulk"]["ttft_s"]
    print(f"[tenant] latency / bulk TTFT p50 {ratio:.4f} (limit 1.0)")
    _require(ratio <= 1.0, "pass tenant: the latency tenant's TTFT p50 "
                           "exceeds the bulk tenant's")
    # the admission order against the scheduler-only replay
    scheduled = [e["request_id"] for e in events
                 if e["kind"] == "scheduled"]
    replay = replay_admissions(
        arrivals, tcfg, serving, obs.reqtrace,
        serving.PagedKVCache(1, 1, 8, tcfg.num_blocks, tcfg.block_size,
                             device="cpu"),
        make_tenant_registry(serving), jaxplan.default_admission_model())
    print(f"[tenant] admission order {scheduled}; replay: the same "
          f"{scheduled == replay['scheduled']}, chunks {replay['chunks']} "
          f"(engine {chunks}), quota refusals {replay['quota']}, "
          f"preemptions {replay['preemptions']}")
    _require(scheduled == replay["scheduled"]
             and quota == replay["quota"]
             and rejected == replay["rejected"]
             and d["preemptions"] == replay["preemptions"],
             "pass tenant: the admission order, refusals or preemptions "
             "differ from the scheduler-only replay")
    tids = sorted({e["trace_id"] for e in events})
    violations = obs.reqtrace.check_causality(
        obs.reqtrace.dump_payload("chip-multi-tenant", trace_ids=tids,
                                  complete=True))
    print(f"[tenant] causality check over {len(tids)} traces: "
          f"{len(violations)} violation(s) {violations[:3]}")
    _require(not violations, "pass tenant: causality violated")
    with tempfile.TemporaryDirectory() as tmp:
        pj, pp = Path(tmp) / "snapshot.json", Path(tmp) / "metrics.prom"
        obs.dump_snapshot(str(pj))
        pp.write_text(obs.to_prometheus())
        from_json, from_prom = _read_back(pj, pp, label)
    want = (len(pairs), d["generated_tokens"])
    print(f"[tenant] snapshots read back (TTFT count, generated tokens): "
          f"JSON {from_json}, Prometheus {from_prom}, engine {want}")
    _require(from_json == want and from_prom == want,
             "pass tenant: a snapshot read back other numbers")
    del eng
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 6e
def run_facade(model, ecfg, device, seed: int) -> None:
    """Phase 6e: Config.enable_llm_engine -> create_predictor -> run on
    right-padded prompts, against the engine alone."""
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.inference.serving import (LLMEngine,
                                                    SamplingParams)
    rng = np.random.RandomState(seed + 5)
    n, mt = FACADE["n"], FACADE["max_tokens"]
    lens = rng.randint(FACADE["p_lo"], FACADE["p_hi"] + 1, n)
    ids = np.zeros((n, int(lens.max())), np.int64)
    for b, m in enumerate(lens):
        ids[b, :m] = rng.randint(1, model.cfg.vocab_size, m)
    cuda = torch.device(device).type == "cuda"
    cfg = inference.Config()
    if not cuda:
        cfg.disable_gpu()
    # the engine's fields but the (model, revision) key, which keeps its
    # default (and whose name enable_llm_engine's model takes)
    opts = {f: v for f, v in dataclasses.asdict(ecfg).items()
            if f not in ("model", "revision")}
    cfg.enable_llm_engine(model=model, **opts, max_tokens=mt)
    pred = inference.create_predictor(cfg)
    [seqs] = pred.run([ids, lens])
    eng = LLMEngine.from_model(model, ecfg, device=device)
    rids = [eng.add_request(ids[b, :m], SamplingParams(max_tokens=mt))
            for b, m in enumerate(lens)]
    alone = eng.run()
    width = int(max(m + len(alone[r]) for m, r in zip(lens, rids)))
    print(f"[facade] create_predictor -> {type(pred).__name__}; sequences "
          f"{seqs.dtype} {list(seqs.shape)} for prompts {lens.tolist()}")
    _require(seqs.dtype == np.int64 and seqs.shape == (n, width),
             f"facade: sequences {seqs.dtype} {seqs.shape}, want int64 "
             f"({n}, {width})")
    for b, (m, r) in enumerate(zip(lens, rids)):
        row = np.concatenate([ids[b, :m], alone[r]])
        _require(np.array_equal(seqs[b, :row.size], row)
                 and not seqs[b, row.size:].any(),
                 f"facade: row {b} is not its prompt and the engine's "
                 f"tokens")
    print(f"[facade] every row is its prompt and the engine's {mt} tokens "
          f"on {card_line() if cuda else 'the CPU'}")
# ------------------------------------------------------------ phases 23-27
# The fleet phases run on the serving bench's model (phase 6) right after
# 6e. Their engine is the serving bench's (chunked prefill over 128
# tokens included) with one change for every fleet pass but 25:
# decode_chunk_size 2 (load_suite's rule, so that requests are in flight
# across many router steps when a fault lands). A chunked prompt is fed
# 2 tokens a trip, so the prefill tier of phase 24 spends up to 384
# trips on a 768-token prompt. Traffic arguments beyond the defaults of
# serving_traffic's generators, and the A/B's request count, lengths and
# steps (a CPU rehearsal shrinks them).
FLEET_ENGINE = dict(decode_chunk_size=2)
FLEET_TRAFFIC: dict = {}
DISAGG_TRAFFIC: dict = {}
DIURNAL_TRAFFIC: dict = {}
DEPLOY_TRAFFIC = dict(n=16)
AB = dict(n=8, p_lo=64, p_hi=256, max_tokens=96, warm=6, k=16)
# readings one phase leaves for a later one: phase 6a's single-engine
# prefix hit rate and the dense references of 6a's and 6c's traffic
READINGS: dict = {}


def _decode_chunks() -> int:
    """Decode chunks run so far by every engine of the process (each
    engine's `serving_host_syncs_total{phase="decode"}`; dead and
    private engines keep their series)."""
    from paddle_tpu_torch import obs
    fam = obs.REGISTRY.get("serving_host_syncs_total")
    if fam is None:
        return 0
    return int(sum(c.value for lbl, c in fam.children()
                   if lbl.get("phase") == "decode"))


class _K3Window:
    """K3's launches over one fleet phase, held to layers x k x the decode
    chunks every engine ran in it (replicas, restarted incarnations,
    probes, canaries, reference engines): the counts set to 0 just
    before the phase and read just after."""

    def __init__(self, name, layers, k, device):
        import torch
        from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
            ragged_decode_attention)
        self.name, self.layers, self.k = name, layers, k
        self.cuda = torch.device(device).type == "cuda"
        self.kernel = ragged_decode_attention
        self.chunks0 = _decode_chunks()
        if self.cuda:
            torch.cuda.synchronize()
        ragged_decode_attention.launches = 0

    def close(self) -> int:
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        launches = self.kernel.launches
        chunks = _decode_chunks() - self.chunks0
        want = self.layers * self.k * chunks if self.cuda else 0
        print(f"[{self.name}] K3 launches {launches} = {self.layers} layers"
              f" x {self.k} trips x {chunks} chunks over every engine of "
              f"the phase: {launches == want}")
        _require(launches == want and (launches > 0 or not self.cuda),
                 f"{self.name}: K3 launched {launches} times, expected "
                 f"{want}")
        return launches


def _router_config(**kw):
    from paddle_tpu_torch.inference.serving import RouterConfig
    kw.setdefault("backoff_base", 0.01)
    kw.setdefault("backoff_max", 0.05)
    kw.setdefault("backoff_jitter", 0.25)
    kw.setdefault("backoff_seed", 0)
    return RouterConfig(**kw)


def _failovers(rs) -> int:
    from paddle_tpu_torch import obs
    fam = obs.REGISTRY.get("serving_failovers_total")
    return int(sum(c.value for lbl, c in fam.children()
                   if lbl.get("router") == rs.label))


def _check_fleet_trace(rs, name, extra_prefixes=()) -> int:
    """The causality checker clean on the pass's complete dump (its
    requests' traces, and `extra_prefixes`' traces), and every failed-over
    request's trace one timeline: failover, then a readmit naming the
    dead replica and another home, two engine admits (the second a
    readmit resuming the streamed tokens) and one finish after the
    readmit. Returns the number of such traces."""
    from paddle_tpu_torch import obs
    prefix = f"tr-{rs.label}-"
    traces = obs.reqtrace.traces(prefix=prefix)
    ids = sorted(traces)
    for p in extra_prefixes:
        ids += sorted(obs.reqtrace.traces(prefix=p))
    dump = obs.reqtrace.dump_payload(name, trace_ids=ids, complete=True)
    violations = obs.reqtrace.check_causality(dump)
    _require(not violations, f"{name}: causality violations {violations}")
    victims = 0
    for tid, evts in traces.items():
        ks = [e.kind for e in evts]
        if "failover" not in ks:
            continue
        victims += 1
        i_fo = ks.index("failover")
        _require("readmit" in ks[i_fo:], f"{name}: {tid} never readmitted")
        i_re = ks.index("readmit", i_fo)
        fo, re_ = evts[i_fo], evts[i_re]
        admits = [e for e in evts if e.kind == "engine_admit"]
        _require(ks.count("finish") == 1 and ks.index("finish") > i_re
                 and re_.attrs["from_replica"] == fo.attrs["replica"]
                 and re_.attrs["to_replica"] != fo.attrs["replica"]
                 and len(admits) >= 2 and admits[-1].attrs["readmit"]
                 and admits[-1].attrs["resume"]
                 == fo.attrs["tokens_streamed"],
                 f"{name}: {tid} is not one timeline across the failover")
    print(f"[{name}] causality clean on {len(ids)} traces "
          f"({len(dump['events'])} events); {victims} failed-over traces "
          f"are one timeline each")
    return victims


def _phase6_rule(model, prompt, got, max_tokens, refs, key, name) -> int:
    """Greedy tokens equal the port's dense generate() except where its
    top-2 margin is under 1e-3 (phase 6's rule). Returns 1 if parted."""
    import numpy as np
    import paddle_tpu_torch.models.generation as gen
    if key not in refs:
        refs[key] = gen.generate(model, prompt[None],
                                 max_tokens)[0, len(prompt):]
    ref = np.asarray(refs[key])
    got = np.asarray(got)
    _require(got.shape == ref.shape, f"{name}: {key} has {got.shape} "
                                     f"tokens, want {ref.shape}")
    t = _first_difference(got, ref)
    if t is None:
        return 0
    margin = top2_margin(model, prompt, ref[:t])
    print(f"[{name}] {key} parts from dense generate() at token {t} "
          f"(reference top-2 margin {margin:.3e})")
    _require(margin < 1e-3, f"{name}: {key} parted at a clear margin")
    return 1


def _audit_fleet(rs, name, failovers: int = 0) -> dict:
    """The end of a fleet pass: every replica holds a live engine whose
    pool audits clean (check_integrity raises otherwise), none ended
    FAILED, the router failed over exactly the `failovers` faults the
    pass injected (so an error raised inside an engine, which the router
    would fail over, fails the run), and no migration or peer fetch was
    aborted or rolled back. Returns the migrator's stats."""
    audits = rs.check_integrity()
    _require(all(a is not None for a in audits.values()),
             f"{name}: a replica ended without a live engine: {audits}")
    _require("failed" not in {str(s) for s in rs.states().values()},
             f"{name}: a replica ended FAILED: {rs.states()}")
    got = _failovers(rs)
    _require(got == failovers, f"{name}: {got} failovers for {failovers} "
                               f"injected faults: "
                               f"{[r.history for r in rs.replicas]}")
    mig = rs.migrator.stats()
    _require(mig["aborted"] == mig["rolled_back"] == mig["prefix_aborted"]
             == 0, f"{name}: aborted migrations {mig}")
    return mig


def _settled_memory(cuda: bool) -> int:
    """Device bytes allocated once every dropped object is collected."""
    import gc
    import torch
    gc.collect()
    if not cuda:
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _pool_bytes(model, ecfg) -> int:
    """One replica's f32 paged pool: K and V of every layer."""
    return (2 * model.cfg.num_layers * ecfg.num_blocks * ecfg.block_size
            * model.cfg.hidden_size * 4)


def _fleet_pass(name, model, ecfg, arrivals, device, spec="", **rkw):
    """One pass of phase 23: the traffic through a fresh 3-replica
    ReplicaSet under fault spec `spec`, the device memory read before
    every router step, and the readings around the failed replica's
    quarantine and its rejoin. Returns the router, the request ids and
    the readings."""
    import time as _time
    import torch
    from paddle_tpu_torch.inference.serving import ReplicaSet
    from paddle_tpu_torch.testing.faults import ServingFaultInjector
    from paddle_tpu_torch.tools.serving_traffic import drive_fleet
    cuda = torch.device(device).type == "cuda"
    faults = ServingFaultInjector(spec)
    rs = ReplicaSet.from_model(
        model, _router_config(num_replicas=3, balance="free_blocks",
                              obs_label=f"chip-{name}", **rkw),
        engine_config=ecfg, faults=faults)
    seen = {"prev": [str(s) for s in rs.states().values()], "mem": None,
            "down_step": None, "up_step": None, "before": None,
            "after": None, "max_step_s": 0.0, "t": 0.0, "homes": {}}

    def before(step):
        seen["mem"] = torch.cuda.memory_allocated() if cuda else 0
        seen["t"] = _time.perf_counter()

    def after(step):
        seen["max_step_s"] = max(seen["max_step_s"],
                                 _time.perf_counter() - seen["t"])
        now = [str(s) for s in rs.states().values()]
        for i, (a, b) in enumerate(zip(seen["prev"], now)):
            if a in ("up", "draining") and b in ("down", "failed"):
                seen["down_step"], seen["before"] = step, seen["mem"]
            if a != "up" and b == "up" and seen["down_step"] is not None:
                seen["up_step"] = step
                seen["after"] = torch.cuda.memory_allocated() if cuda \
                    else 0
        seen["prev"] = now
        for rid, rec in rs._requests.items():
            seen["homes"].setdefault(rid, set()).add(rec.replica)

    t0 = _time.perf_counter()
    rids = drive_fleet(rs, arrivals, before_step=before, after_step=after)
    seen["wall_s"] = _time.perf_counter() - t0
    seen["fired"] = list(faults.fired_log)
    return rs, rids, seen


def run_replica_failover(model, ecfg, device, seed: int) -> int:
    """Phase 23 (load_suite replica_kill): 3 replicas, free-block
    balancing, 24 greedy requests (prompts 64-256, 32-64 new tokens, one
    arrival every 2 router steps), run with no fault, with
    kill_replica@6:1, and with wedge_replica@8:2 under a heartbeat of
    twice the no-fault pass's longest router step. After each pass the
    device memory returns to its value at the start of the phase: no
    pool outlives its fleet. Returns K3's launches over the phase."""
    import dataclasses
    import torch
    from paddle_tpu_torch.tools.serving_traffic import fleet_traffic
    fcfg = dataclasses.replace(ecfg, **FLEET_ENGINE)
    arrivals = fleet_traffic(model.cfg.vocab_size, seed + 7,
                             **FLEET_TRAFFIC)
    cuda = torch.device(device).type == "cuda"
    pool_bytes = _pool_bytes(model, fcfg)
    start = _settled_memory(cuda)

    def returned(name):
        left = _settled_memory(cuda) - start
        print(f"[{name}] device memory once the fleet is dropped: "
              f"{left / 2**20:+.1f} MiB against the start of the phase")
        _require(left < pool_bytes // 8, f"{name}: {left} bytes outlive "
                                         f"the fleet (a pool is "
                                         f"{pool_bytes})")

    win = _K3Window("failover", model.cfg.num_layers,
                    fcfg.decode_chunk_size, device)
    base, base_rids, base_seen = _fleet_pass("replica-nofault", model, fcfg,
                                             arrivals, device)
    _audit_fleet(base, "replica-nofault")
    _require(all(base.get_request(r).finish_reason == "length"
                 for r in base_rids), "no-fault pass: a request did not "
                                      "end 'length'")
    base_tokens = [list(base.get_request(r).tokens) for r in base_rids]
    hb = max(2 * base_seen["max_step_s"], 0.05)
    print(f"[failover] no-fault pass: {len(base_rids)} requests in "
          f"{base_seen['wall_s']:.2f} s; router TTFT p50 "
          f"{base.ttft_quantile(0.5) * 1e3:.1f} ms, p99 "
          f"{base.ttft_quantile(0.99) * 1e3:.1f} ms; longest router step "
          f"{base_seen['max_step_s'] * 1e3:.1f} ms -> heartbeat "
          f"{hb * 1e3:.1f} ms")
    del base
    returned("replica-nofault")
    refs: dict = {}
    for name, spec, rkw in (
            ("replica-kill", "kill_replica@6:1", {}),
            ("replica-wedge", "wedge_replica@8:2",
             dict(heartbeat_timeout_s=hb))):
        dead = int(spec.rsplit(":", 1)[1])
        rs, rids, seen = _fleet_pass(name, model, fcfg, arrivals, device,
                                     spec, **rkw)
        _audit_fleet(rs, name, failovers=1)
        reasons = [rs.get_request(r).finish_reason for r in rids]
        _require(all(x == "length" for x in reasons),
                 f"{name}: finish reasons {reasons}")
        rep = rs.replicas[dead]
        _require(str(rep.state) == "up" and rep.restarts == 1
                 and rep.probe_tokens >= 1 and len(rs.recovery_times) == 1,
                 f"{name}: replica {dead} did not rejoin after its probe "
                 f"({rep.state}, {rep.restarts} restarts, "
                 f"{rep.probe_tokens} probe tokens)")
        victims = _check_fleet_trace(rs, name)
        requeued = [i for i, r in enumerate(rids)
                    if rs.get_request(r).requeues]
        _require(victims == len(requeued) >= 1,
                 f"{name}: {victims} failover traces, {len(requeued)} "
                 f"requeued requests")
        parted = sum(_phase6_rule(model, arrivals[i][1],
                                  rs.get_request(rids[i]).tokens,
                                  arrivals[i][2]["max_tokens"], refs, i,
                                  name) for i in requeued)
        untouched = [i for i, r in enumerate(rids)
                     if not rs.get_request(r).requeues
                     and dead not in seen["homes"][r]]
        same = sum(list(rs.get_request(rids[i]).tokens) == base_tokens[i]
                   for i in untouched)
        print(f"[{name}] fired {seen['fired']}; {len(requeued)} requests "
              f"re-admitted ({parted} parted from dense generate(), each "
              f"at a top-2 margin < 1e-3); {same} of {len(untouched)} "
              f"requests that never lived on replica {dead} equal the "
              f"no-fault pass bitwise")
        _require(same == len(untouched) > 0,
                 f"{name}: requests untouched by the fault differ from "
                 f"the no-fault pass")
        if cuda:
            delta = seen["after"] - seen["before"]
            print(f"[{name}] device memory before the fault "
                  f"{seen['before'] / 2**20:.1f} MiB, after the restart "
                  f"{seen['after'] / 2**20:.1f} MiB (difference "
                  f"{delta / 2**20:.1f} MiB; one pool "
                  f"{pool_bytes / 2**20:.1f} MiB)")
            _require(abs(delta) < pool_bytes,
                     f"{name}: memory after the restart is {delta} bytes "
                     f"from before the fault (a pool is {pool_bytes})")
        print(f"[{name}] router TTFT p50 {rs.ttft_quantile(0.5) * 1e3:.1f} "
              f"ms, p99 {rs.ttft_quantile(0.99) * 1e3:.1f} ms; recovery "
              f"{rs.recovery_times[0]:.4f} s (quarantine at router step "
              f"{seen['down_step']}, back up at {seen['up_step']}); "
              f"{seen['wall_s']:.2f} s")
        del rs, rep
        returned(name)
    torch.cuda.empty_cache()
    return win.close()


def run_disagg(model, ecfg, device, seed: int) -> int:
    """Phase 24 (load_suite disagg): 4 replicas, roles prefill, prefill,
    decode, decode, on serving_traffic.disagg_traffic; then the
    controlled migration A/B in f32 and int8 and a rebalance under the
    decode tier's measured use. Returns K3's launches over the phase."""
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import (BlockMigration,
                                                    ReplicaSet)
    from paddle_tpu_torch.tools.serving_traffic import (disagg_traffic,
                                                        drive_fleet,
                                                        migration_ab)
    fcfg = dataclasses.replace(ecfg, **FLEET_ENGINE)
    vocab = model.cfg.vocab_size
    win = _K3Window("disagg", model.cfg.num_layers, fcfg.decode_chunk_size,
                    device)
    arrivals = disagg_traffic(vocab, seed + 8, **DISAGG_TRAFFIC)
    rs = ReplicaSet.from_model(
        model, _router_config(num_replicas=4,
                              roles=("prefill", "prefill", "decode",
                                     "decode"), obs_label="chip-disagg"),
        engine_config=fcfg)
    t0 = time.perf_counter()
    rids = drive_fleet(rs, arrivals)
    wall = time.perf_counter() - t0
    mig = _audit_fleet(rs, "disagg")
    reasons = [rs.get_request(r).finish_reason for r in rids]
    _require(all(x == "length" for x in reasons),
             f"disagg: finish reasons {reasons}")
    _require(mig["migrations"] >= 1 and mig["revision_refused"] == 0,
             f"disagg: migrations {mig}")
    _check_fleet_trace(rs, "disagg")
    from paddle_tpu_torch import obs
    handed = {e.trace_id for e in obs.reqtrace.events(
        prefix=f"tr-{rs.label}-") if e.kind == "migrate_in"}
    refs: dict = {}
    parted = sum(_phase6_rule(model, p, rs.get_request(r).tokens,
                              kw["max_tokens"], refs, i, "disagg")
                 for i, (r, (_s, p, kw)) in enumerate(zip(rids, arrivals))
                 if kw.get("temperature", 0.0) <= 0.0)
    gaps = [rs.replicas[i].engine.stats.token_gap_quantile(0.99)
            for i in (2, 3)]
    print(f"[disagg] {len(rids)} requests in {wall:.2f} s, "
          f"{len(handed)} handed off to the decode tier; migrations "
          f"{mig['migrations']}, aborted (decode tier full) "
          f"{mig['aborted']}, payload {mig['bytes_moved']} bytes "
          f"({mig['bytes_moved'] / max(mig['migrations'], 1) / 2**20:.2f} "
          f"MiB each); migration seconds p50 "
          f"{rs.migrator.seconds_quantile(0.5) * 1e3:.2f} ms, p99 "
          f"{rs.migrator.seconds_quantile(0.99) * 1e3:.2f} ms; decode "
          f"tier inter-token gap p99 {max(gaps) * 1e3:.1f} ms; router TTFT "
          f"p50 {rs.ttft_quantile(0.5) * 1e3:.1f} ms, p99 "
          f"{rs.ttft_quantile(0.99) * 1e3:.1f} ms; greedy tokens: {parted} "
          f"parted from dense generate() (each at a top-2 margin < 1e-3)")
    del rs
    torch.cuda.empty_cache()

    # the controlled A/B: greedy and sampled rows, f32 and int8 pools
    rng = np.random.RandomState(seed + 9)
    specs = []
    for i in range(AB["n"]):
        kw = dict(max_tokens=AB["max_tokens"])
        if i % 2:
            kw.update(temperature=0.8, top_k=50,
                      seed=int(rng.randint(1, 2 ** 31 - 1)))
        specs.append((rng.randint(1, vocab, (int(rng.randint(
            AB["p_lo"], AB["p_hi"] + 1)),), dtype=np.int32), kw))
    for kvdt in ("float32", "int8"):
        ab = migration_ab(model, dataclasses.replace(
            fcfg, kv_cache_dtype=kvdt), specs, AB["warm"], AB["k"])
        same = sum(a == b for a, b in zip(ab["a"], ab["b"]))
        print(f"[disagg] migration A/B, {kvdt} pools: {ab['live']} live "
              f"requests moved by drain(0, recompute=False) "
              f"({ab['migrated']} migrations, {ab['bytes']} bytes), then "
              f"{AB['k']} router steps: {same} of {len(specs)} token "
              f"streams equal to the same steps in place (greedy and "
              f"sampled alike)")
        _require(ab["live"] == ab["migrated"] == len(specs)
                 and ab["homes"] == [1] * len(specs),
                 f"A/B {kvdt}: not every request moved ({ab['migrated']} "
                 f"of {ab['live']} live)")
        _require(ab["failovers"] == ab["aborted"] == 0,
                 f"A/B {kvdt}: {ab['failovers']} failovers, "
                 f"{ab['aborted']} aborted migrations")
        _require(same == len(specs), f"A/B {kvdt}: a migrated stream "
                                     f"differs from the one in place")

    # rebalance with the watermark under the mixed replica's measured use
    ab = migration_ab(model, fcfg, specs, AB["warm"], action="rebalance")
    same = sum(a == b for a, b in zip(ab["a"], ab["b"]))
    print(f"[disagg] rebalance(watermark {ab['watermark']:.4f}, half the "
          f"replica's measured use {ab['use']:.4f}) moved "
          f"{ab['migrated']} requests; {same} of {len(specs)} streams to "
          f"the end equal to the fleet that kept them in place")
    _require(ab["migrated"] >= 1 and same == len(specs),
             "rebalance moved nothing or changed a stream")
    _require(ab["failovers"] == ab["aborted"] == 0,
             f"rebalance: {ab['failovers']} failovers, {ab['aborted']} "
             f"aborted migrations")
    torch.cuda.empty_cache()
    return win.close()


def run_prefix_fleet(model, ecfg, device, seed: int) -> int:
    """Phase 25: phase 6a's shared-prefix traffic on 3 replicas routed by
    prefix affinity (the fleet's hit rate at least 0.8 x 6a's single
    engine's, load_suite's min_affinity_retention), then phase 6c's
    tiered traffic on 3 round-robin replicas with peer prefix fetch (at
    least one committed fetch). Tokens by phase 6's rule in both.
    Returns K3's launches over the phase."""
    import dataclasses
    import torch
    from paddle_tpu_torch.inference.serving import ReplicaSet
    from paddle_tpu_torch.tools.serving_traffic import (drive_fleet,
                                                        prefix_traffic,
                                                        tiered_traffic)
    vocab = model.cfg.vocab_size
    win = _K3Window("prefix-fleet", model.cfg.num_layers,
                    ecfg.decode_chunk_size, device)
    arrivals = prefix_traffic(vocab, seed + 2, **PREFIX_TRAFFIC)
    pcfg = dataclasses.replace(ecfg, enable_prefix_cache=True)
    rs = ReplicaSet.from_model(
        model, _router_config(num_replicas=3, balance="prefix_affinity",
                              obs_label="chip-affinity"),
        engine_config=pcfg)
    t0 = time.perf_counter()
    rids = drive_fleet(rs, [(s, p, dict(max_tokens=mt))
                            for s, p, mt in arrivals])
    wall = time.perf_counter() - t0
    _audit_fleet(rs, "affinity")
    fps = rs.prefix_stats()
    rate = fps["hits"] / max(fps["hits"] + fps["misses"], 1)
    single = READINGS["prefix_hit_rate"]
    refs = READINGS.setdefault("prefix_refs", {})
    parted = sum(_phase6_rule(model, p, rs.get_request(r).tokens, mt, refs,
                              i, "affinity")
                 for i, (r, (_s, p, mt)) in enumerate(zip(rids, arrivals)))
    homes = [rs.get_request(r).replica for r in rids]
    print(f"[affinity] {len(rids)} requests in {wall:.2f} s over 3 "
          f"replicas (homes per replica {[homes.count(i) for i in range(3)]}"
          f"); hit rate {rate:.4f} (hits {fps['hits']}, misses "
          f"{fps['misses']}, cached_tokens_ratio "
          f"{fps['cached_tokens_ratio']:.4f}) against phase 6a's single "
          f"engine {single:.4f}: retention {rate / single:.4f} (limit "
          f"0.8); TTFT p50 {rs.ttft_quantile(0.5) * 1e3:.1f} ms, p99 "
          f"{rs.ttft_quantile(0.99) * 1e3:.1f} ms; {parted} parted from "
          f"dense generate()")
    _require(rate >= 0.8 * single, "affinity: the fleet kept under 0.8 of "
                                   "the single engine's hit rate")
    del rs
    torch.cuda.empty_cache()

    arrivals = tiered_traffic(vocab, seed + 3, **TIERED_TRAFFIC)
    rs = ReplicaSet.from_model(
        model, _router_config(num_replicas=3, balance="round_robin",
                              peer_prefix_fetch=True,
                              obs_label="chip-peer-fetch"),
        engine_config=dataclasses.replace(pcfg, **TIERED_ENGINE))
    t0 = time.perf_counter()
    rids = drive_fleet(rs, [(s, p, dict(max_tokens=mt))
                            for s, p, mt in arrivals])
    wall = time.perf_counter() - t0
    mig = _audit_fleet(rs, "peer-fetch")
    refs = READINGS.setdefault("tiered_refs", {})
    parted = sum(_phase6_rule(model, p, rs.get_request(r).tokens, mt, refs,
                              i, "peer-fetch")
                 for i, (r, (_s, p, mt)) in enumerate(zip(rids, arrivals)))
    print(f"[peer-fetch] {len(rids)} requests in {wall:.2f} s; peer "
          f"fetches {mig['prefix_fetches']} committed, "
          f"{mig['prefix_aborted']} aborted, {mig['prefix_bytes']} bytes; "
          f"TTFT p50 {rs.ttft_quantile(0.5) * 1e3:.1f} ms, p99 "
          f"{rs.ttft_quantile(0.99) * 1e3:.1f} ms; {parted} parted from "
          f"dense generate()")
    _require(mig["prefix_fetches"] >= 1, "peer-fetch: no committed fetch")
    del rs
    torch.cuda.empty_cache()
    return win.close()


def run_autoscaler(model, ecfg, device, seed: int) -> int:
    """Phase 26 (load_suite autoscale_diurnal): 4 provisioned replicas and
    the Autoscaler stepping with the router on trickle, burst, trickle
    arrivals: at least one shrink by evacuating drain and one grow by
    probe rejoin, every request 'length'. Returns K3's launches."""
    import dataclasses
    import torch
    from paddle_tpu_torch.inference.serving import (Autoscaler,
                                                    AutoscalerConfig,
                                                    ReplicaSet)
    from paddle_tpu_torch.tools.serving_traffic import (diurnal_traffic,
                                                        drive_fleet)
    fcfg = dataclasses.replace(ecfg, **FLEET_ENGINE)
    win = _K3Window("autoscale", model.cfg.num_layers,
                    fcfg.decode_chunk_size, device)
    arrivals = diurnal_traffic(model.cfg.vocab_size, seed + 10,
                               **DIURNAL_TRAFFIC)
    rs = ReplicaSet.from_model(
        model, _router_config(num_replicas=4, obs_label="chip-autoscale"),
        engine_config=fcfg)
    asc = Autoscaler(rs, AutoscalerConfig(
        min_replicas=1, max_replicas=4, target_waiting_per_replica=2.0,
        low_waiting_per_replica=1.0, cooldown_steps=4))
    active, acts = [], []

    def after(step):
        d = asc.step()
        active.append(rs.num_up())
        if d["enacted"]:
            acts.append((step, d["action"], d["reason"], d["replica"]))

    t0 = time.perf_counter()
    rids = drive_fleet(rs, arrivals, after_step=after)
    wall = time.perf_counter() - t0
    _audit_fleet(rs, "autoscale")
    reasons = [rs.get_request(r).finish_reason for r in rids]
    print(f"[autoscale] {len(rids)} requests in {wall:.2f} s over "
          f"{len(active)} router steps; shrinks {asc.shrink_events}, grows "
          f"{asc.grow_events}; actions {acts}; migrations "
          f"{rs.migrator.stats()['migrations']}")
    print(f"[autoscale] active replicas per step: {active}")
    _require(all(x == "length" for x in reasons),
             f"autoscale: finish reasons {reasons}")
    _require(asc.shrink_events >= 1 and asc.grow_events >= 1,
             "autoscale: no shrink or no grow")
    del rs, asc
    torch.cuda.empty_cache()
    return win.close()


def run_rolling_deploy(model, ecfg, device, seed: int) -> int:
    """Phase 27 (load_suite rolling_deploy): ModelRegistry.publish of the
    serving model and of one from seed + 1, ReplicaSet.from_registry over
    3 replicas, a DeployController rollout under live traffic
    (canary_tolerance 3) that commits, the requests pinned to the old
    revision bitwise against a no-deploy fleet on the old weights; then
    a candidate from seed + 2 under the strict default tolerance, which
    rolls back. Nothing lost, causality (invariant 8) clean on both
    dumps. Returns K3's launches over the phase."""
    import dataclasses
    import torch
    from paddle_tpu_torch.inference.serving import (DeployConfig,
                                                    DeployController,
                                                    ModelRegistry,
                                                    ReplicaSet)
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools.serving_traffic import (drive_fleet,
                                                        fleet_traffic)
    fcfg = dataclasses.replace(ecfg, enable_prefix_cache=True,
                               **FLEET_ENGINE)
    win = _K3Window("deploy", model.cfg.num_layers, fcfg.decode_chunk_size,
                    device)
    arrivals = fleet_traffic(model.cfg.vocab_size, seed + 11,
                             **DEPLOY_TRAFFIC)
    models = {}
    for off in (1, 2):
        m = GPT(model.cfg, device=device, seed=seed + off)
        m.eval()
        models[off] = m

    def one_pass(name, candidate, dcfg):
        reg = ModelRegistry()
        t0 = time.perf_counter()
        r_old = reg.publish("m", model, engine_config=fcfg)
        r_new = reg.publish("m", candidate, engine_config=fcfg)
        pub = time.perf_counter() - t0
        _require(r_new != r_old, f"{name}: the revisions collided")
        rs = ReplicaSet.from_registry(
            reg, ("m",) * 3, config=_router_config(
                num_replicas=3, obs_label=f"chip-{name}"))
        _require(all(r.engine.params["wte.weight"].data_ptr()
                     == model.wte.weight.data_ptr() for r in rs.replicas),
                 f"{name}: replicas do not share the revision's weights")
        ctl, status = [None], [None]

        def after(step):
            if ctl[0] is None and step >= 3:
                ctl[0] = DeployController(rs, "m", r_new, config=dcfg)
                ctl[0].start()
            elif ctl[0] is not None and status[0] is None:
                ctl[0].tick()
                if ctl[0].done():
                    status[0] = ctl[0].status()

        t0 = time.perf_counter()
        rids = drive_fleet(rs, arrivals, after_step=after, model="m")
        while status[0] is None:
            rs.step()
            after(10 ** 9)
        while rs.has_unfinished():
            rs.step()
        wall = time.perf_counter() - t0
        _audit_fleet(rs, name)
        reasons = [rs.get_request(r).finish_reason for r in rids]
        _require(all(x == "length" for x in reasons),
                 f"{name}: finish reasons {reasons}")
        _check_fleet_trace(rs, name, extra_prefixes=(ctl[0].deploy_id,))
        st = status[0]
        print(f"[{name}] revisions {r_old} -> {r_new} (published in "
              f"{pub:.2f} s); outcome {st['outcome']} after {st['ticks']} "
              f"ticks ({st['error']}); swapped {st['swapped']}; registry "
              f"active {reg.active('m')}; migrations "
              f"{rs.migrator.stats()['migrations']}; {len(rids)} requests "
              f"in {wall:.2f} s, router TTFT p99 "
              f"{rs.ttft_quantile(0.99) * 1e3:.1f} ms")
        return reg, rs, rids, st, r_old, r_new

    reg, rs, rids, st, r_old, r_new = one_pass(
        "deploy-commit", models[1], DeployConfig(canary_tolerance=3))
    _require(st["outcome"] == "committed" and reg.active("m") == r_new
             and rs.migrator.stats()["migrations"] >= 1
             and all(r.revision == r_new for r in rs.replicas),
             f"deploy-commit: {st}")
    ref = ReplicaSet.from_model(model, _router_config(
        num_replicas=3, obs_label="chip-deploy-ref"), engine_config=fcfg)
    ref_rids = drive_fleet(ref, arrivals)
    _audit_fleet(ref, "deploy-ref")
    old = [i for i, r in enumerate(rids)
           if rs.get_request(r).revision == r_old]
    same = sum(list(rs.get_request(rids[i]).tokens)
               == list(ref.get_request(ref_rids[i]).tokens) for i in old)
    print(f"[deploy-commit] {same} of {len(old)} requests that finished "
          f"pinned to the old revision equal the no-deploy fleet bitwise; "
          f"{len(rids) - len(old)} finished on the new revision")
    _require(len(old) >= 1 and same == len(old),
             "deploy-commit: an old-revision request differs from the "
             "no-deploy fleet")
    del rs, ref, reg
    torch.cuda.empty_cache()
    reg, rs, rids, st, r_old, r_new = one_pass(
        "deploy-rollback", models[2], DeployConfig())
    # the canary gate's own verdict, not a canary that raised (which
    # also rolls back, as "canary failed: <error>")
    verdict = re.fullmatch(r"replica \d+: (\d+) canary prompts diverged "
                           r"\(tolerance 0\)", st["error"] or "")
    _require(st["outcome"] == "rolled_back" and verdict is not None
             and int(verdict.group(1)) >= 1
             and reg.active("m") == r_old
             and all(r.revision == r_old for r in rs.replicas),
             f"deploy-rollback: {st}")
    del rs, reg, models
    torch.cuda.empty_cache()
    return win.close()


def run_fleet(model, ecfg, device, seed: int) -> dict:
    """Phases 23-27; returns K3's launches in each, counted from 0 just
    before it. Request tracing is on: the phases check the traces. Each
    phase ends with the device memory it started with: no pool, model or
    engine of its fleets outlives it."""
    import torch
    from paddle_tpu_torch import obs
    obs.reqtrace.enable()
    cuda = torch.device(device).type == "cuda"
    pool_bytes = _pool_bytes(model, ecfg)
    out = {}
    for name, fn in (("failover", run_replica_failover),
                     ("disagg", run_disagg),
                     ("prefix_fleet", run_prefix_fleet),
                     ("autoscale", run_autoscaler),
                     ("deploy", run_rolling_deploy)):
        mem0 = _settled_memory(cuda)
        t0 = time.perf_counter()
        out[name] = fn(model, ecfg, device, seed)
        left = _settled_memory(cuda) - mem0
        print(f"[fleet] phase {name} in {time.perf_counter() - t0:.1f} s; "
              f"device memory after it {left / 2**20:+.1f} MiB against "
              f"its start")
        _require(left < pool_bytes // 8, f"{name}: {left} bytes outlive "
                                         f"the phase")
    return out


# ------------------------------------------------------------ phase 7
# the flash kernels' main-path shapes: the GPT step's attention (B 32,
# T 1024, causal; K1 6 heads of 128, K2 12 heads of 64 packed in 6 pairs
# of 128 lanes) and ERNIE-large's (k2_nc: B 32, T 512, not causal; K2,
# 16 heads of 64 in 8 pairs)
#
# and Transformer-base's (k1_d64: B 32, 8 heads of 64, T 512, not causal;
# K1 on Paddle's [B, T, H, D] layout, read in place as a strided view),
# with one cross shape beside it (k1_d64_x: 512 queries over 768 keys)
FLASH = {
    "k1": dict(batch=32, heads=6, seq=1024, width=128, head_dim=128,
               scale=1.0 / 128 ** 0.5, causal=True),
    "k2": dict(batch=32, heads=6, seq=1024, width=128, head_dim=64,
               scale=1.0 / 8.0, causal=True),
    "k2_nc": dict(batch=32, heads=8, seq=512, width=128, head_dim=64,
                  scale=1.0 / 8.0, causal=False),
    "k1_d64": dict(batch=32, heads=8, seq=512, width=64, head_dim=64,
                   scale=1.0 / 8.0, causal=False, layout="bthd"),
    "k1_d64_x": dict(batch=32, heads=8, seq=512, kv_seq=768, width=64,
                     head_dim=64, scale=1.0 / 8.0, causal=False,
                     layout="bthd")}


def _is_k1(kernel) -> bool:
    return kernel.startswith("k1")


def _flash_fns(kernel):
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import packed_flash as k2
    if _is_k1(kernel):
        return (k1.flash_attention_fwd, k1.flash_attention_bwd,
                k1.flash_attention_reference)
    return k2.packed_flash_fwd, k2.packed_flash_bwd, k2.packed_flash_reference


def _shape(kernel) -> str:
    c = FLASH[kernel]
    tk = f" Tk {c['kv_seq']}" if "kv_seq" in c else ""
    lay = " [B,T,H,D] view" if c.get("layout") == "bthd" else ""
    return (f"B {c['batch']} T {c['seq']}{tk} "
            f"{'causal' if c['causal'] else 'not causal'}{lay}")


def flash_inputs(kernel, dtype, device, seed):
    """q, k, v and do at the kernel's FLASH shape, N(0, 1) from `seed`,
    heads-major [B, H, T, W]; with layout "bthd", views of [B, T, H, W]
    tensors (the layout MultiHeadAttention hands K1); k and v over
    kv_seq keys where one is given."""
    import torch
    c = FLASH[kernel]
    g = torch.Generator().manual_seed(seed)
    lens = (c["seq"], c.get("kv_seq", c["seq"]),
            c.get("kv_seq", c["seq"]), c["seq"])
    if c.get("layout") == "bthd":
        return [torch.randn(c["batch"], t, c["heads"], c["width"],
                            generator=g).to(device, dtype).transpose(1, 2)
                for t in lens]
    return [torch.randn(c["batch"], c["heads"], t, c["width"],
                        generator=g).to(device, dtype) for t in lens]


# agreement limits per tensor. f32: relative L2 error and max |err| over
# max |w|. bf16: relative L2 error, and the worst excess of |err| over
# one bf16 ulp of |w| in units of the tensor's rms. The plain version
# keeps P and dS in f32; the kernels, like the TPU kernels, round them to
# bf16 before the products that take them, and delta = rowsum(do * o)
# reads the bf16 output, as FA2 does. So the bf16 limits come from the
# reference's own error: FLASH_REF_MARGIN times the reading of the
# reference's arithmetic against the plain version, cut to two
# significant digits, and never below the limit each had before
# (_BF16_FLOOR). The reference kernels are the JAX package's Pallas K1
# (`_fa_core`) and K2 (`packed_flash_attention`); they run only in
# interpret mode on a CPU, where [1, 2, 256, 128] is their largest
# practical shape (FLASH_PALLAS_READINGS). The excess is a maximum over
# elements and grows with their count (B 32 x 6 heads here against 1 x
# 2 there: the Pallas readings fell under the check's readings by up to
# 4x), so the limits are taken at the check's own shape and inputs from
# reference_rounding, the reference's rounding points in plain PyTorch
# (FLASH_REF_READINGS, phase 7 on the H100). k2_nc, K2 at ERNIE-large's
# non-causal shape, takes its limits by the same rule from
# reference_rounding(causal=False) at B 32 x T 512; its Pallas readings
# are those of packed_flash_attention(causal=False). k1_d64 and
# k1_d64_x (K1 at head dim 64, not causal, Transformer-base's shape and
# a cross shape) take theirs by the same rule, their Pallas readings
# those of `_fa_core` at [1, 2, 256, 64] not causal (tests/
# test_torch_transformer.py holds them). tests/
# test_torch_flash_attention.py recomputes the Pallas readings, holds
# reference_rounding to them where both run, and checks each limit's
# derivation; phase 7 requires reference_rounding's readings within the
# limits on every run. lse is f32 in every version.
_F32_TOL = dict(l2=1e-5, peak=1e-4)
FLASH_REF_MARGIN = 2
FLASH_PALLAS_READINGS = {
    "k1": {"out": dict(l2=2.434e-3, excess=9.789e-3),
           "lse": dict(l2=3.357e-8, excess=0.0),
           "dq": dict(l2=2.663e-3, excess=1.761e-2),
           "dk": dict(l2=2.713e-3, excess=2.458e-2),
           "dv": dict(l2=2.440e-3, excess=1.412e-2)},
    "k2": {"out": dict(l2=2.012e-3, excess=8.434e-3),
           "lse": dict(l2=3.518e-8, excess=0.0),
           "dq": dict(l2=2.669e-3, excess=1.505e-2),
           "dk": dict(l2=2.593e-3, excess=1.598e-2),
           "dv": dict(l2=2.448e-3, excess=2.021e-2)},
    "k2_nc": {"out": dict(l2=2.403e-3, excess=6.721e-3),
              "lse": dict(l2=2.855e-8, excess=0.0),
              "dq": dict(l2=2.635e-3, excess=9.261e-3),
              "dk": dict(l2=2.644e-3, excess=1.283e-2),
              "dv": dict(l2=2.586e-3, excess=7.199e-3)},
    # `_fa_core` at [1, 2, 256, 64], not causal
    "k1_d64": {"out": dict(l2=2.533e-3, excess=5.690e-3),
               "lse": dict(l2=2.590e-8, excess=0.0),
               "dq": dict(l2=2.696e-3, excess=6.279e-3),
               "dk": dict(l2=2.616e-3, excess=8.781e-3),
               "dv": dict(l2=2.563e-3, excess=8.055e-3)}}
# reference_rounding at each kernel's FLASH shape (k1, k2: B 32, T 1024,
# causal; k2_nc: B 32, T 512, not causal), --seed 0 (NVIDIA H100 80GB
# HBM3, 700 W)
FLASH_REF_READINGS = {
    "k1": {"out": dict(l2=2.095e-3, excess=1.966e-2),
           "lse": dict(l2=0.0, excess=0.0),
           "dq": dict(l2=2.759e-3, excess=9.071e-2),
           "dk": dict(l2=2.726e-3, excess=8.992e-2),
           "dv": dict(l2=2.531e-3, excess=6.073e-2)},
    "k2": {"out": dict(l2=2.091e-3, excess=2.088e-2),
           "lse": dict(l2=0.0, excess=0.0),
           "dq": dict(l2=2.784e-3, excess=9.804e-2),
           "dk": dict(l2=2.734e-3, excess=1.411e-1),
           "dv": dict(l2=2.530e-3, excess=8.341e-2)},
    "k2_nc": {"out": dict(l2=2.414e-3, excess=1.007e-2),
              "lse": dict(l2=0.0, excess=0.0),
              "dq": dict(l2=2.646e-3, excess=1.463e-2),
              "dk": dict(l2=2.594e-3, excess=1.615e-2),
              "dv": dict(l2=2.566e-3, excess=1.382e-2)},
    # K1 at Transformer-base's shape (B 32, 8 heads of 64, T 512, not
    # causal, [B, T, H, D] views) and its cross shape (Tk 768), --seed 0
    # (NVIDIA H100 80GB HBM3, 700 W)
    "k1_d64": {"out": dict(l2=2.411e-3, excess=8.271e-3),
               "lse": dict(l2=0.0, excess=0.0),
               "dq": dict(l2=2.646e-3, excess=1.276e-2),
               "dk": dict(l2=2.593e-3, excess=1.774e-2),
               "dv": dict(l2=2.570e-3, excess=1.392e-2)},
    "k1_d64_x": {"out": dict(l2=2.426e-3, excess=9.477e-3),
                 "lse": dict(l2=0.0, excess=0.0),
                 "dq": dict(l2=2.638e-3, excess=1.802e-2),
                 "dk": dict(l2=2.594e-3, excess=1.725e-2),
                 "dv": dict(l2=2.570e-3, excess=1.215e-2)}}
_BF16_FLOOR = {"out": dict(l2=5e-4, excess=1e-3),
               "lse": dict(l2=1e-6, excess=1e-3),
               "dq": dict(l2=4e-3, excess=0.5),
               "dk": dict(l2=4e-3, excess=0.5),
               "dv": dict(l2=5e-4, excess=1e-3)}
FLASH_NAMES = ("out", "lse", "dq", "dk", "dv")
FLASH_TOL = {
    "float32": {kernel: dict.fromkeys(FLASH_NAMES, _F32_TOL)
                for kernel in FLASH},
    "bfloat16": {
        "k1": {"out": dict(l2=4.1e-3, excess=3.9e-2),
               "lse": dict(l2=1e-6, excess=1e-3),
               "dq": dict(l2=5.5e-3, excess=0.5),
               "dk": dict(l2=5.4e-3, excess=0.5),
               "dv": dict(l2=5.0e-3, excess=0.12)},
        "k2": {"out": dict(l2=4.1e-3, excess=4.1e-2),
               "lse": dict(l2=1e-6, excess=1e-3),
               "dq": dict(l2=5.5e-3, excess=0.5),
               "dk": dict(l2=5.4e-3, excess=0.5),
               "dv": dict(l2=5.0e-3, excess=0.16)},
        "k2_nc": {"out": dict(l2=4.8e-3, excess=2.0e-2),
                  "lse": dict(l2=1e-6, excess=1e-3),
                  "dq": dict(l2=5.2e-3, excess=0.5),
                  "dk": dict(l2=5.1e-3, excess=0.5),
                  "dv": dict(l2=5.1e-3, excess=2.7e-2)},
        "k1_d64": {"out": dict(l2=4.8e-3, excess=1.6e-2),
                   "lse": dict(l2=1e-6, excess=1e-3),
                   "dq": dict(l2=5.2e-3, excess=0.5),
                   "dk": dict(l2=5.1e-3, excess=0.5),
                   "dv": dict(l2=5.1e-3, excess=2.7e-2)},
        "k1_d64_x": {"out": dict(l2=4.8e-3, excess=1.8e-2),
                     "lse": dict(l2=1e-6, excess=1e-3),
                     "dq": dict(l2=5.2e-3, excess=0.5),
                     "dk": dict(l2=5.1e-3, excess=0.5),
                     "dv": dict(l2=5.1e-3, excess=2.4e-2)}}}
# float16: the kernels are the bf16 kernels' template at T = __half, so
# they round P, dS and their outputs at the same points, to a type whose
# unit roundoff is 2^-11 where bf16's is 2^-8. The f16 limit of each
# tensor rounded to 16 bits is its bf16 limit over F16_ROUNDOFF_RATIO;
# lse, f32 in every version, keeps its limit. tests/
# test_torch_flash_attention.py holds the Pallas reference kernels'
# float16 readings within these limits, and phase 7 requires
# reference_rounding's float16 readings within them on every run.
F16_ROUNDOFF_RATIO = 8
FLASH_TOL["float16"] = {
    kernel: {name: lims if name == "lse" else
             {m: v / F16_ROUNDOFF_RATIO for m, v in lims.items()}
             for name, lims in tol.items()}
    for kernel, tol in FLASH_TOL["bfloat16"].items()}


def reference_rounding(q, k, v, do, causal: bool, scale: float):
    """The TPU reference kernels' 16-bit arithmetic in plain PyTorch over
    heads-major [B, H, T, D] in bf16 or f16 (lo, q's dtype): f32 scores
    and softmax; P (against the row max) rounded to lo before P V; the
    output rounded to lo and delta = rowsum(do * o) read from it;
    P = exp(s - lse) and dS = P (dP - delta) scale rounded to lo before
    dV = P^T dO,
    dK = dS^T Q and dQ = dS K. Returns (out, lse, dq, dk, dv). It stands
    in for the Pallas kernels, which run only in interpret mode on a CPU,
    at the chip check's shape; tests/test_torch_flash_attention.py holds
    it to their readings where both run."""
    import torch
    bf = q.dtype
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = qf @ kf.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    out = ((e.to(bf).float() @ vf) / l).to(bf)
    del e
    lse = (m + l.log()).squeeze(-1)
    p = torch.exp(s - lse.unsqueeze(-1))
    del s
    delta = (out.float() * dof).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    dv = (p.to(bf).float().transpose(-1, -2) @ dof).to(bf)
    del p
    dsb = ds.to(bf).float()
    del ds
    return (out, lse, (dsb @ kf).to(bf),
            (dsb.transpose(-1, -2) @ qf).to(bf), dv)


def _reference_rounding_of(kernel, q, k, v, do, causal, scale):
    """reference_rounding on K1's heads-major or K2's packed tensors."""
    if _is_k1(kernel):
        return reference_rounding(q, k, v, do, causal, scale)
    from paddle_tpu_torch.ops.kernels.packed_flash import _repack, _unpack
    out, lse, dq, dk, dv = reference_rounding(
        *(_unpack(t) for t in (q, k, v, do)), causal, scale)
    B, Hp, T = q.shape[0], q.shape[1], q.shape[2]
    return (_repack(out), lse.reshape(B, Hp, 2, T), _repack(dq),
            _repack(dk), _repack(dv))


def flash_readings(kernel, dtype, device, seed: int):
    """At the kernel's FLASH shape and mask: {tensor: agreement} of the
    kernel with the plain version for out, lse, dq, dk and dv, and in
    bf16 and f16 also of reference_rounding with the plain version (else
    None)."""
    import torch
    from paddle_tpu_torch.tools.measure import agreement
    fwd, bwd, ref = _flash_fns(kernel)
    sc, causal = FLASH[kernel]["scale"], FLASH[kernel]["causal"]
    q, k, v, do = flash_inputs(kernel, dtype, device, seed)
    o, lse = fwd(q, k, v, causal, sc)
    got = (o, lse, *bwd(q, k, v, o, lse, do, causal, sc))
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    ro, rlse = ref(qr, kr, vr, causal, sc, return_lse=True)
    want = (ro.detach(), rlse.detach(),
            *torch.autograd.grad(ro, (qr, kr, vr), do))
    del ro, rlse, qr, kr, vr
    stats = {}
    for name, a, w in zip(FLASH_NAMES, got, want):
        _require(a.shape == w.shape and a.dtype == w.dtype,
                 f"{kernel} {name}: {a.shape}/{a.dtype} vs "
                 f"{w.shape}/{w.dtype}")
        stats[name] = agreement(a, w)
    del got
    emulated = None
    if dtype != torch.float32:
        emu = _reference_rounding_of(kernel, q, k, v, do, causal, sc)
        emulated = {name: agreement(a, w)
                    for name, a, w in zip(FLASH_NAMES, emu, want)}
        del emu
    del want, q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return stats, emulated


def _over(stats: dict, tol: dict) -> list:
    return [f"{name} {m} {stats[name][m]:.3e} > {lim:g}"
            for name in FLASH_NAMES for m, lim in tol[name].items()
            if stats[name][m] > lim]


def _line(stats: dict) -> str:
    return "; ".join(f"{n} l2 {st['l2']:.3e} abs {st['abs']:.2e} peak "
                     f"{st['peak']:.1e} excess {st['excess']:.3e}"
                     for n, st in stats.items())


def check_flash(kernel, device, seed: int) -> dict:
    """Kernel vs plain at its FLASH shape: out, lse, dq, dk and dv in f32,
    in bf16, the main path's dtype, and in f16 (AMP's other 16-bit type),
    to FLASH_TOL; in bf16 and f16 the reference rounding's own readings
    must lie within the limits too (the bf16 limits were derived from
    them). Returns {dtype name: max |err| of the forward (out, lse) and
    of the backward (dq, dk, dv)} for bf16 and f16."""
    import torch
    errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dtype)[6:]
        tol = FLASH_TOL[dname][kernel]
        stats, emulated = flash_readings(kernel, dtype, device, seed)
        print(f"[{kernel}] kernel vs plain, {dname}, {_shape(kernel)} "
              f"(limits FLASH_TOL): {_line(stats)}")
        _require(not _over(stats, tol), f"{kernel} disagrees with its plain "
                                        f"version in {dname}: "
                                        f"{_over(stats, tol)}")
        if emulated is not None:
            print(f"[{kernel}] reference rounding vs plain, {dname} "
                  f"(FLASH_REF_READINGS): {_line(emulated)}")
            _require(not _over(emulated, tol),
                     f"{kernel}: the reference rounding's readings exceed "
                     f"the limits derived from them: {_over(emulated, tol)}")
        errs[dname] = {
            "fwd": max(stats[n]["abs"] for n in ("out", "lse")),
            "bwd": max(stats[n]["abs"] for n in ("dq", "dk", "dv"))}
    return errs


# ------------------------------------------------------------ phase 8
def time_flash(kernel, device, seed: int, dtype=None):
    """(forward numbers, backward numbers) at the kernel's FLASH shape,
    in bf16 (or `dtype`), cold L2."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.packed_flash import _unpack
    from paddle_tpu_torch.tools.measure import cold_ms
    fwd, bwd, ref = _flash_fns(kernel)
    c = FLASH[kernel]
    sc, causal = c["scale"], c["causal"]
    dtype = dtype or torch.bfloat16
    q, k, v, do = flash_inputs(kernel, dtype, device, seed)
    o, lse = fwd(q, k, v, causal, sc)
    ms_f = cold_ms(lambda: fwd(q, k, v, causal, sc), 10)
    ms_b = cold_ms(lambda: bwd(q, k, v, o, lse, do, causal, sc), 5)
    plain_f = cold_ms(lambda: ref(q, k, v, causal, sc), 3)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    ro = ref(qr, kr, vr, causal, sc)
    plain_b = cold_ms(lambda: torch.autograd.grad(
        ro, (qr, kr, vr), do, retain_graph=True), 3)
    del ro
    # yardstick only (never called by the port): SDPA on heads-major
    # [B, H, T, D] (K2's inputs unpacked beforehand, not timed)
    if not _is_k1(kernel):
        q, k, v, do = (_unpack(t).contiguous() for t in (q, k, v, do))
    lib_f = cold_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), 10)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    lib_b = cold_ms(lambda: torch.autograd.grad(
        so, (qs, ks, vs), do, retain_graph=True), 10)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        torch.autograd.grad(out, (qs, ks, vs), do)
    lib_fb = cold_ms(fwd_bwd, 10)
    del so
    B, H, T, D = q.shape[0], q.shape[1], q.shape[2], q.shape[3]
    Tk = k.shape[2]
    # (row, col) score pairs: row >= col under the causal mask
    pairs = T * (T + 1) // 2 if causal else T * Tk
    # 16-bit elements: q and o (forward), and do and dq (backward), over
    # the queries; k and v (and dk, dv) over the keys; lse f32
    eq, ek = B * H * T * D, B * H * Tk * D
    res = []
    for what, ms, plain, lib, flops, nbytes in (
            ("forward", ms_f, plain_f, lib_f, 4 * B * H * D * pairs,
             (2 * eq + 2 * ek) * 2 + B * H * T * 4),
            ("backward", ms_b, plain_b, lib_b, 10 * B * H * D * pairs,
             (4 * eq + 4 * ek) * 2 + B * H * T * 4)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        entry = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                 "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        res.append(entry)
        print(f"[{kernel}] {what} timing, B {B} H {H} T {T} Tk {Tk} D {D} "
              f"{str(dtype)[6:]} "
              f"{'causal' if causal else 'not causal'} (cold L2, mean): "
              f"kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms by {entry['bound_by']} "
              f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); kernel "
              f"{flops / ms / 1e9:.2f} TFLOP/s")
    print(f"[{kernel}] SDPA forward+backward {lib_fb:.4f} ms; kernel "
          f"forward+backward {ms_f + ms_b:.4f} ms")
    return res


# ------------------------------------------------------------ phase 9
# the route check's batch rows, and its limit on each parameter's
# gradient (relative L2 error, flash route vs composed attention, which
# runs its softmax in bf16; a sound route reads about 1.2e-2 on the card)
GRAD_B, GRAD_TOL = 8, 0.05


def _rel_l2(a, w) -> float:
    return ((a.float() - w.float()).norm()
            / w.float().norm().clamp_min(1e-30)).item()


def route_check(model, loss_fn, args, f32_reference: bool = False):
    """The first step's loss on the whole batch and every parameter's
    gradient on its first GRAD_B rows, with the flash route off (composed
    attention) and on. Returns (composed loss, flash loss, worst
    per-parameter relative L2 error of the flash gradients against the
    composed ones, {}); with f32_reference the dict holds each route's
    worst error against composed attention on an f32 copy of the model
    (same weights, same rows), which says which route carries the error."""
    import copy
    import torch
    from paddle_tpu_torch.core import flags
    params = [p for p in model.parameters() if p.requires_grad]
    rows = tuple(a[:GRAD_B] for a in args)

    def route(flash: bool):
        flags.set_flags({"FLAGS_use_flash_attention": flash})
        try:
            with torch.no_grad():
                loss = loss_fn(model, *args).item()
            grads = torch.autograd.grad(loss_fn(model, *rows), params)
        finally:
            flags.set_flags({"FLAGS_use_flash_attention": True})
        return loss, grads

    composed, g_comp = route(False)
    flash, g_flash = route(True)
    gerr = max(_rel_l2(a, w) for a, w in zip(g_flash, g_comp))
    vs_f32 = {}
    if f32_reference:
        ref = copy.deepcopy(model).float()
        flags.set_flags({"FLAGS_use_flash_attention": False})
        try:
            g_ref = torch.autograd.grad(
                loss_fn(ref, *rows),
                [p for p in ref.parameters() if p.requires_grad])
        finally:
            flags.set_flags({"FLAGS_use_flash_attention": True})
        vs_f32 = {name: max(_rel_l2(a, w) for a, w in zip(g, g_ref))
                  for name, g in (("flash", g_flash), ("composed", g_comp))}
        del ref, g_ref
    return composed, flash, gerr, vs_f32


def drive_train(num_heads: int, warmup: int, steps: int, device,
                seed: int) -> dict:
    """The full-width train step; checks losses, routing, launches and
    the first step's loss against composed attention."""
    import math
    import torch
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import packed_flash as k2
    from paddle_tpu_torch.tools import train_bench
    built = train_bench.build(num_heads, seed, device)
    model, _, x, y = built
    composed, flash_loss, gerr, _ = route_check(model, gpt_loss_fn, (x, y))
    fns = (k1.flash_attention_fwd, k1.flash_attention_bwd,
           k2.packed_flash_fwd, k2.packed_flash_bwd)
    for f in fns:
        f.launches = 0
    torch.cuda.synchronize()
    res = train_bench.run(num_heads, warmup, steps, built=built)
    torch.cuda.synchronize()
    counts = [f.launches for f in fns]
    n = warmup + steps
    L = model.cfg.num_layers
    want = [L * n, L * n, 0, 0] if num_heads == 6 else [0, 0, L * n, L * n]
    losses = res["losses"]
    name = "k1" if num_heads == 6 else "k2"
    print(f"[train {num_heads}h] losses {[round(v, 5) for v in losses]}")
    print(f"[train {num_heads}h] step s {[round(t, 4) for t in res['step_s']]}"
          f"; tokens/s {res['tokens_per_sec']:.1f}, MFU {res['mfu']:.4f} "
          f"(bf16 peak 989 TFLOP/s), peak memory "
          f"{res['peak_mem_gb']:.2f} GB")
    print(f"[train {num_heads}h] launches fwd/bwd K1 {counts[0]}/"
          f"{counts[1]}, K2 {counts[2]}/{counts[3]} (want {want}); "
          f"LAST_PATH {res['last_path']}; first loss {losses[0]:.6f} "
          f"(flash route alone {flash_loss:.6f}) vs composed "
          f"{composed:.6f}; worst per-leaf gradient relative L2 error vs "
          f"composed, B {GRAD_B}: {gerr:.3e} (limit {GRAD_TOL:g})")
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    _require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    _require(res["last_path"] == "flash",
             f"LAST_PATH {res['last_path']}")
    _require(counts == want, f"{name} launches {counts} != {want}")
    rel = abs(losses[0] - composed) / abs(composed)
    _require(rel <= 1e-4, f"first loss {losses[0]} vs composed {composed}")
    _require(gerr <= GRAD_TOL, f"gradients vs composed: {gerr} > "
                               f"{GRAD_TOL}")
    res["counts"] = counts
    del built, model
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ phase 9b
# the eager loop's warm-up and timed steps, and the float16 check's
# depth, batch and steps
EAGER_WARMUP, EAGER_STEPS = 2, 8
FP16_LAYERS, FP16_BATCH, FP16_STEPS = 2, 4, 2
# where GradScaler's one host read a step lives
FOUND_INF_SITE = "paddle_tpu_torch/amp/grad_scaler.py"
# the eager loop's loss against TrainStep O1's at every step (relative):
# the same forward and update on the same weights and batch
EAGER_O1_REL = 1e-5


def _count_syncs(fn):
    """fn wrapped to record, per call, where torch's sync debug mode saw
    a synchronizing CUDA operation inside it: "file:line" of the
    innermost frame of this checkout's code below this script. Only the
    warning torch gives for such an operation counts; the notice that
    the first set_sync_debug_mode("warn") of a process prints (that the
    mode is a prototype) is not one."""
    import traceback
    import warnings
    import torch
    here = Path(__file__).resolve()
    calls = []

    def site() -> str:
        ours = [f for f in traceback.extract_stack()
                if Path(f.filename).resolve().is_relative_to(here.parent)
                and Path(f.filename).resolve() != here]
        if not ours:
            return "?"
        f = ours[-1]
        return f"{Path(f.filename).resolve().relative_to(here.parent)}:" \
               f"{f.lineno}"

    def counted(*args, **kwargs):
        prev = torch.cuda.get_sync_debug_mode()
        seen = []
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            show = warnings.showwarning

            def record(message, category, filename, lineno, *rest):
                if "called a synchronizing CUDA operation" in str(message):
                    seen.append(site())
                else:
                    show(message, category, filename, lineno, *rest)
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        calls.append(seen)
        return out
    counted.calls = calls
    return counted


def drive_eager(device, seed: int) -> dict:
    """Phase 9b: the reference-style eager loop (train_bench.run_eager)
    at bench_gpt's width through K1, TrainStep with O1 inside its loss on
    the same weights and batch, and the float16 route at small depth."""
    import math
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import packed_flash as k2
    from paddle_tpu_torch.tools import train_bench
    fns = (k1.flash_attention_fwd, k1.flash_attention_bwd,
           k2.packed_flash_fwd, k2.packed_flash_bwd)
    prev = place._default
    paddle.set_device(f"gpu:{device.index or 0}")
    try:
        st = train_bench.build_eager(seed=seed, device=device)
        # every synchronizing operation of GradScaler.minimize (unscale
        # and its found-inf check, the optimizer step, the scale update)
        sc = st["scaler"]
        sc.minimize = _count_syncs(sc.minimize)
        for f in fns:
            f.launches = 0
        torch.cuda.synchronize()
        res = train_bench.run_eager(EAGER_WARMUP, EAGER_STEPS, built=st)
        torch.cuda.synchronize()
        counts = [f.launches for f in fns]
        sites = sc.minimize.calls
        syncs = [len(c) for c in sites]
        x, y = st["x"].numpy(), st["y"].numpy()
        del st
        torch.cuda.empty_cache()
        o1 = train_bench.run_o1_trainstep(
            EAGER_WARMUP, EAGER_STEPS, built=train_bench.build_o1_trainstep(
                seed, device, x, y))
        torch.cuda.empty_cache()
        fp16 = _eager_fp16(device, seed, fns)
    finally:
        place._default = prev
    n = EAGER_WARMUP + EAGER_STEPS
    L = train_bench.bench_config(6).num_layers
    want = [L * n, L * n, 0, 0]
    sched = train_bench.eager_schedule()
    want_lrs = []
    for _ in range(n):
        want_lrs.append(sched())
        sched.step()
    losses = res["losses"]
    # the two routes run the same forward and the same update on the same
    # weights and batch: every step's loss within EAGER_O1_REL
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, o1["losses"])]
    rel = max(rels)
    for name, r in (("eager", res), ("TrainStep O1", o1)):
        print(f"[eager] {name}: losses {[round(v, 5) for v in r['losses']]}"
              f"; step s {[round(t, 4) for t in r['step_s']]}; tokens/s "
              f"{r['tokens_per_sec']:.1f}, MFU {r['mfu']:.4f} (bench.py "
              f"FLOPs over 989 TFLOP/s bf16), peak memory "
              f"{r['peak_mem_gb']:.2f} GB")
    where = sorted({w for c in sites for w in c})
    print(f"[eager] LRs {res['lrs']} (LinearWarmup's {want_lrs}); "
          f"GradScaler scale {res['loss_scale']:g}, skipped "
          f"{res['skipped_steps']}, found-inf host reads "
          f"{res['found_inf_syncs']}, synchronizing CUDA operations in "
          f"scaler.minimize per step {syncs} (at {where})")
    print(f"[eager] launches fwd/bwd K1 {counts[0]}/{counts[1]}, K2 "
          f"{counts[2]}/{counts[3]} (want {want}); LAST_PATH "
          f"{res['last_path']}, q {res['last_dtype']}; losses vs "
          f"TrainStep O1 step by step: worst rel {rel:.2e} (limit "
          f"{EAGER_O1_REL:g}; first {losses[0]:.7f} vs "
          f"{o1['losses'][0]:.7f})")
    fp16_want = FP16_LAYERS * FP16_STEPS
    print(f"[eager] float16 at {FP16_LAYERS} layers, batch {FP16_BATCH}: "
          f"losses {fp16['losses']}, LAST_PATH {fp16['last_path']}, q "
          f"{fp16['last_dtype']}, K1 launches fwd/bwd {fp16['k1']} (want "
          f"{fp16_want} each), scale {fp16['scale']:g}, skipped "
          f"{fp16['skipped']}")
    _require(all(math.isfinite(v) for v in losses + o1["losses"]),
             "eager: non-finite loss")
    _require(losses[-1] < losses[0], f"eager: loss did not fall: {losses}")
    _require(o1["losses"][-1] < o1["losses"][0],
             f"TrainStep O1: loss did not fall: {o1['losses']}")
    _require(len(rels) == n and rel <= EAGER_O1_REL,
             f"eager losses {losses} vs TrainStep O1 {o1['losses']}")
    _require(counts == want, f"eager: launches {counts} != {want}")
    _require(res["last_path"] == "flash" and res["last_dtype"] == "bfloat16",
             f"eager: LAST_PATH {res['last_path']}, q {res['last_dtype']}")
    _require(res["lrs"] == want_lrs, f"eager: LRs {res['lrs']} != "
                                     f"{want_lrs}")
    _require(res["found_inf_syncs"] == n and syncs == [1] * n
             and all(w.startswith(FOUND_INF_SITE) for w in where),
             f"eager: found-inf reads {res['found_inf_syncs']}, syncs in "
             f"scaler.minimize {syncs} at {where} (want one a step, in "
             f"{FOUND_INF_SITE})")
    _require(fp16["last_path"] == "flash" and fp16["last_dtype"] == "float16"
             and fp16["k1"] == [fp16_want, fp16_want]
             and all(math.isfinite(v) for v in fp16["losses"]),
             f"float16: {fp16}")
    return {"eager": res, "o1_trainstep": o1, "counts": counts,
            "syncs": syncs, "fp16": fp16}


def _eager_fp16(device, seed: int, fns) -> dict:
    """The eager loop with auto_cast(dtype="float16") at small depth:
    attention takes K1's float16 instance."""
    import dataclasses
    from paddle_tpu_torch.nn.functional import attention as A
    from paddle_tpu_torch.tools import train_bench
    cfg = dataclasses.replace(train_bench.bench_config(6),
                              num_layers=FP16_LAYERS)
    st = train_bench.build_eager(cfg, seed, device, "float16", FP16_BATCH)
    for f in fns:
        f.launches = 0
    losses = [train_bench.eager_step(st).item() for _ in range(FP16_STEPS)]
    return {"losses": losses, "last_path": A.LAST_PATH,
            "last_dtype": str(A.LAST_DTYPE)[6:],
            "k1": [fns[0].launches, fns[1].launches],
            "scale": st["scaler"].get_init_loss_scaling(),
            "skipped": st["scaler"].skipped_steps}


# ------------------------------------------------------------ phase 10
# K4 against its plain version. Both round one f32 sum per element to
# bf16 (summed in different orders), so a sound kernel differs from it
# by rare one-ulp flips: relative L2 error, and the worst excess of |err|
# over one bf16 ulp of the plain value in units of its rms (sound
# readings on the H100 at the five geometries: l2 1.4e-5 to 8.4e-5,
# excess 1.6e-7 to 2.0e-6)
K4_TOL = dict(l2=3e-4, excess=1e-4)
K4_SOURCE = "paddle_tpu_torch/ops/kernels/csrc/fused_conv.cu"


def _k4_bad(agree) -> list:
    return [f"{m} {agree[m]:.3e} > {lim:g}" for m, lim in K4_TOL.items()
            if agree[m] > lim]


def check_k4(device, seed: int) -> list:
    """K4 vs its plain version, bitwise against a repeat of itself, and
    timed (kernel, plain, composed path, torch.matmul alone, bound) at the
    five block-boundary geometries of the A/B tool, from its input
    recipe."""
    import torch
    from paddle_tpu_torch.ops.kernels.fused_conv import (
        fused_scale_relu_matmul)
    from paddle_tpu_torch.tools import fused_conv_proto as proto
    rows = []
    for geom in proto.inputs(seed, device):
        r = proto.measure(*geom)
        first = fused_scale_relu_matmul(*geom[1:])
        r["bitwise"] = torch.equal(first, fused_scale_relu_matmul(*geom[1:]))
        del geom, first
        a = r["agreement"]
        print(f"[k4] {r['name']} (M {r['m']}, K {r['k']}, N {r['n']}; tile "
              f"128 x {r['block_n']}, grid {r['grid']}, {r['stages']} "
              f"stages): kernel vs plain l2 {a['l2']:.2e} abs "
              f"{a['abs']:.2e} excess {a['excess']:.2e} (limits {K4_TOL}); "
              f"bitwise equal over a repeat: {r['bitwise']}; cold L2 mean: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
              f"composed {r['composed_ms']:.4f}, torch.matmul alone "
              f"{r['matmul_ms']:.4f}, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['mbytes']:.1f} MB, {r['gflop']:.2f} "
              f"GFLOP); kernel {r['tb_per_s']:.3f} TB/s, "
              f"{r['tflop_per_s']:.1f} TFLOP/s, {r['share']:.1%} of the "
              f"bound; profiler kernel time {r['profiler_ms']:.4f} ms, "
              f"wrapper host time {r['host_us']:.1f} us a call")
        bad = _k4_bad(a)
        _require(not bad, f"K4 disagrees with its plain version at "
                          f"{r['name']}: {bad}")
        _require(r["bitwise"], f"K4 is not bitwise repeatable at "
                               f"{r['name']}")
        rows.append(r)
        torch.cuda.empty_cache()
    total = sum(r["ms"] for r in rows)
    prof = sum(r["profiler_ms"] for r in rows)
    bound = sum(r["bound_ms"] for r in rows)
    print(f"[k4] five geometries: kernel {total:.4f} ms (profiler "
          f"{prof:.4f}), bound {bound:.4f} ms, {bound / total:.1%} of the "
          f"bound ({bound / prof:.1%} by the profiler)")
    return rows


# ------------------------------------------------------------ phase 11
# K4 on ResNet-50's own block-boundary tensors against the model's next
# convolution: K4 rounds its f32 transform to bf16 once, the model
# applies scale and shift in bf16 (as the JAX package does) and rounds
# after each op, so the two differ by a few bf16 ulps of the next conv's
# input; relative L2 limit on the next conv's output (sound readings on
# the H100: 4.0e-3 to 4.4e-3 at the five sites)
K4_MODEL_TOL = 1e-2


def check_k4_on_model(device, seed: int) -> dict:
    """One training-mode bf16 forward of the port's ResNet-50 at batch 128
    x 224^2; at each of the five sites hooks capture the pre-BN
    convolution output, the BN's batch-statistics fold, the identity and
    the next 1x1 convolution's weight as [K, N], and launch K4 on them
    (laid out as [N*H*W, C]) when the next convolution runs. K4's result
    is held against the model's own next-conv output and against its
    plain version. Then each site's K4 call is timed beside the model's
    own boundary on the same tensors (BN-apply, residual add and ReLU as
    the train step's fused BN route computes them after its statistics,
    then the next convolution; NCHW). Returns K4's launches during the
    forward and the summed times."""
    import torch
    from paddle_tpu_torch.nn.functional.norm import (_apply_scale_shift,
                                                     _bn_stats, _fold)
    from paddle_tpu_torch.ops.kernels.fused_conv import (
        fused_scale_relu_matmul, fused_scale_relu_matmul_reference)
    from paddle_tpu_torch.tools.measure import agreement, cold_ms
    from paddle_tpu_torch.tools.train_bench import resnet_batch
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(num_classes=1000, device=device, seed=seed).to(
        torch.bfloat16).train()
    x, _ = resnet_batch(seed, device)
    layers = (model.layer1, model.layer2, model.layer3, model.layer4)
    sites = [(f"layer{i + 1}.0.bn3 + identity -> layer{i + 1}.1.conv1",
              L[0].conv3, L[0].bn3, L[0].downsample, L[1].conv1)
             for i, L in enumerate(layers)]
    b = model.layer1[0]
    sites.append(("layer1.0.bn2 -> layer1.0.conv3", b.conv2, b.bn2, None,
                  b.conv3))

    def rows(t):                           # [N, C, H, W] -> [N*H*W, C]
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]).contiguous()

    seen, results, hooks, timed = {}, [], [], []
    for name, src, bn, res, dst in sites:
        def keep(key):
            return lambda mod, inp, out: seen.__setitem__(key, out)

        def run_k4(mod, inp, out, name=name, bn=bn, res=res, src=src):
            pre = seen.pop(src)
            mean, var = _bn_stats(pre, (0, 2, 3))
            scale, shift = _fold(pre, mean, var, bn.weight, bn.bias,
                                 bn._epsilon)
            ident = None if res is None else seen.pop(res)
            xs = rows(pre)
            zs = None if ident is None else rows(ident)
            w = mod.weight[:, :, 0, 0].t().contiguous()
            got = fused_scale_relu_matmul(xs, zs, w, scale, shift)
            results.append((name, tuple(xs.shape), w.shape[1],
                            agreement(got, rows(out)),
                            agreement(got, fused_scale_relu_matmul_reference(
                                xs, zs, w, scale, shift))))

            def boundary(pre=pre, mean=mean, var=var, bn=bn, ident=ident,
                         mod=mod):
                t = _apply_scale_shift(pre, mean, var, bn.weight, bn.bias,
                                       bn._epsilon, 1)
                return mod(torch.relu(t if ident is None else t + ident))
            timed.append((name, boundary,
                          lambda a=(xs, zs, w, scale, shift):
                          fused_scale_relu_matmul(*a)))
        hooks.append(src.register_forward_hook(keep(src)))
        if res is not None:
            hooks.append(res.register_forward_hook(keep(res)))
        hooks.append(dst.register_forward_hook(run_k4))
    fused_scale_relu_matmul.launches = 0
    torch.cuda.synchronize()
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    launches = fused_scale_relu_matmul.launches
    for h in hooks:
        h.remove()
    for name, shape, n, vs_model, vs_plain in results:
        print(f"[k4 model] {name}: [{shape[0]}, {shape[1]}] -> {n}; vs the "
              f"model's next conv l2 {vs_model['l2']:.3e} (limit "
              f"{K4_MODEL_TOL:g}) peak {vs_model['peak']:.2e}; vs plain l2 "
              f"{vs_plain['l2']:.2e} excess {vs_plain['excess']:.2e}")
        _require(vs_model["l2"] <= K4_MODEL_TOL,
                 f"K4 vs the model's next conv at {name}: "
                 f"{vs_model['l2']} > {K4_MODEL_TOL}")
        bad = _k4_bad(vs_plain)
        _require(not bad, f"K4 vs plain on the model's tensors at {name}: "
                          f"{bad}")
    print(f"[k4 model] K4 launches during the forward: {launches} "
          f"(want {len(sites)})")
    _require(len(results) == len(sites) and launches == len(sites),
             f"K4 launched {launches} times at {len(results)} sites")
    del x, seen, results
    total = {"k4_ms": 0.0, "model_ms": 0.0}
    with torch.no_grad():
        for name, boundary, k4 in timed if device.type == "cuda" else ():
            k4_ms, model_ms = cold_ms(k4, 20), cold_ms(boundary, 20)
            total["k4_ms"] += k4_ms
            total["model_ms"] += model_ms
            print(f"[k4 model] {name}: K4 {k4_ms:.4f} ms (its [N*H*W, C] "
                  f"input copy left out) vs the model's own boundary "
                  f"(BN-apply (+ residual) + ReLU, then the cuDNN 1x1 "
                  f"conv, NCHW) {model_ms:.4f} ms: {model_ms / k4_ms:.2f}x")
    print(f"[k4 model] five sites: K4 {total['k4_ms']:.4f} ms vs the "
          f"model's boundary {total['model_ms']:.4f} ms")
    del model, timed
    torch.cuda.empty_cache()
    return {"launches": launches, **total}


# ------------------------------------------------------------ phase 12
# the BN route check: first-step loss on the whole batch and every
# parameter's gradient on the first ROUTE_B images, fused BN+ReLU
# (`_bn_act_core`) against BN, add and ReLU as separate ops; limits on
# the loss (relative) and the gradients (relative L2). The two routes do
# the same bf16 operations (the H100 read 0 for both); the gradient limit
# leaves room for cuDNN backward algorithms that sum in a run-dependent
# order (one bf16 ulp is 2^-8 relative)
ROUTE_B, ROUTE_TOL = 8, dict(loss=1e-5, grad=5e-3)


def drive_resnet(device, seed: int, warmup: int = 2, steps: int = 10
                 ) -> dict:
    """The ResNet-50 train step at bench_resnet's geometry: the BN route
    check, step 1 (the running stats move and become f32), then the
    remaining warm-up and the timed steps through tools/train_bench.py."""
    import math
    import torch
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.tools import train_bench
    built = train_bench.build_resnet(seed, device)
    model, step, x, y = built
    params = [p for p in model.parameters() if p.requires_grad]
    saved = {k: b.clone() for k, b in model.named_buffers()}

    def route(fused: bool):
        flags.set_flags({"FLAGS_fuse_bn_act": fused})
        try:
            with torch.no_grad():
                loss = train_bench.ce_loss_fn(model, x, y).item()
            grads = torch.autograd.grad(train_bench.ce_loss_fn(
                model, x[:ROUTE_B], y[:ROUTE_B]), params)
        finally:
            flags.set_flags({"FLAGS_fuse_bn_act": True})
        return loss, grads

    composed, g_comp = route(False)
    fused, g_fused = route(True)
    gerr = max(((a.float() - w.float()).norm()
                / w.float().norm().clamp_min(1e-30)).item()
               for a, w in zip(g_fused, g_comp))
    del g_comp, g_fused
    lerr = abs(fused - composed) / abs(composed)
    print(f"[resnet] BN route check: first loss fused {fused:.6f} vs "
          f"composed {composed:.6f} ({lerr:.2e} relative, limit "
          f"{ROUTE_TOL['loss']:g}); worst per-parameter gradient relative "
          f"L2 error on {ROUTE_B} images {gerr:.3e} (limit "
          f"{ROUTE_TOL['grad']:g})")
    _require(lerr <= ROUTE_TOL["loss"], f"BN routes' loss: {lerr}")
    _require(gerr <= ROUTE_TOL["grad"], f"BN routes' gradients: {gerr}")
    # the route check's training-mode forwards moved the running stats
    for k, b in model.named_buffers():
        b.data = saved[k]
    first = step(x, y).item()
    moved = [k for k, b in model.named_buffers()
             if not torch.equal(b.float(), saved[k].float())]
    dtypes = {str(b.dtype) for b in model.buffers()}
    print(f"[resnet] after step 1: {len(moved)} of {len(saved)} running "
          f"stats moved; their dtypes {sorted(dtypes)} (were bf16)")
    _require(len(moved) == len(saved), "running stats did not all move")
    _require(dtypes == {"torch.float32"}, f"running stats {dtypes}")
    res = train_bench.run_resnet(warmup - 1, steps, built=built)
    losses = [first] + res["losses"]
    res["losses"] = losses
    print(f"[resnet] losses {[round(v, 5) for v in losses]}")
    print(f"[resnet] step s {[round(t, 4) for t in res['step_s']]}; "
          f"imgs/s {res['imgs_per_sec']:.1f}, MFU {res['mfu']:.4f} (3 x "
          f"4.1 GFLOP/img over the bf16 peak 989 TFLOP/s), peak memory "
          f"{res['peak_mem_gb']:.2f} GB")
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    _require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    del built, model
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ phase 13-14
def drive_mlm(model_name: str, warmup: int, steps: int, device,
              seed: int) -> dict:
    """The MLM + NSP train step at bench_ernie's ("ernie") or bench_bert's
    ("bert") geometry through tools/train_bench.py. ERNIE-large (T 512)
    must run every layer's attention through K2 non-causal: the route
    check against composed attention (loss and GRAD_B-row gradients,
    each route also held against an f32 composed copy of the model),
    LAST_PATH "flash", K2 launches of layers x steps each way and none
    of K1. BERT-base (T 128, under flash_attention_min_seq) must take
    composed attention with no flash launch. Both: losses finite and
    falling."""
    import math
    import torch
    from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import packed_flash as k2
    from paddle_tpu_torch.tools import train_bench
    built = train_bench.build_mlm(model_name, seed, device)
    model, _, args = built
    flash = model_name == "ernie"
    tag = f"[{model_name}]"
    if flash:
        composed, flash_loss, gerr, vs_f32 = route_check(
            model, bert_pretrain_loss_fn, args, f32_reference=True)
        print(f"{tag} route check: first loss flash {flash_loss:.6f} vs "
              f"composed {composed:.6f}; worst per-parameter gradient "
              f"relative L2 error vs composed, B {GRAD_B}: {gerr:.3e} "
              f"(limit {GRAD_TOL:g}); against an f32 composed copy: flash "
              f"{vs_f32['flash']:.3e}, bf16 composed "
              f"{vs_f32['composed']:.3e}")
    fns = (k1.flash_attention_fwd, k1.flash_attention_bwd,
           k2.packed_flash_fwd, k2.packed_flash_bwd)
    for f in fns:
        f.launches = 0
    torch.cuda.synchronize()
    res = train_bench.run_mlm(model_name, warmup, steps, built=built)
    torch.cuda.synchronize()
    counts = [f.launches for f in fns]
    L = model.cfg.num_layers * (warmup + steps)
    want = [0, 0, L, L] if flash else [0, 0, 0, 0]
    losses = res["losses"]
    print(f"{tag} {res['batch']} x {res['seq']}, {res['masked']} masked "
          f"positions a row; losses {[round(v, 5) for v in losses]}")
    print(f"{tag} step s {[round(t, 4) for t in res['step_s']]}; samples/s "
          f"{res['samples_per_sec']:.2f}, MFU {res['mfu']:.4f} (bench.py's "
          f"FLOPs per sample over the bf16 peak 989 TFLOP/s), peak memory "
          f"{res['peak_mem_gb']:.2f} GB")
    print(f"{tag} launches fwd/bwd K1 {counts[0]}/{counts[1]}, K2 "
          f"{counts[2]}/{counts[3]} (want {want}); LAST_PATH "
          f"{res['last_path']}")
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    _require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    _require(res["last_path"] == ("flash" if flash else "composed"),
             f"{model_name} LAST_PATH {res['last_path']}")
    _require(counts == want, f"{model_name} launches {counts} != {want}")
    if flash:
        rel = abs(losses[0] - composed) / abs(composed)
        _require(rel <= 1e-4, f"first loss {losses[0]} vs composed "
                              f"{composed}")
        _require(gerr <= GRAD_TOL, f"gradients vs composed: {gerr} > "
                                   f"{GRAD_TOL}")
    res["counts"] = counts
    del built, model, args
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ phase 15
def drive_lenet(device, seed: int) -> dict:
    """bench_lenet's step (100 timed steps) and bench_lenet_multistep's
    (MultiStepTrainStep, K 50, 2 timed calls) through tools/train_bench.py:
    losses finite and falling (the multistep run by its first and last
    call's mean loss); samples/s of each."""
    import math
    from paddle_tpu_torch.tools import train_bench
    out = {}
    for k in (None, train_bench.LENET_K):
        res = train_bench.run_lenet(k, built=train_bench.build_lenet(
            seed, k, device))
        losses, n = res["losses"], k or 1
        first, last = (sum(v) / n for v in (losses[:n], losses[-n:]))
        what = f"MultiStepTrainStep(k={k})" if k else "TrainStep"
        print(f"[lenet] {what}: {res['timed_steps']} timed steps in "
              f"{res['timed_s']:.4f} s, samples/s "
              f"{res['samples_per_sec']:.1f}; loss {first:.5f} -> "
              f"{last:.5f}")
        _require(all(math.isfinite(v) for v in losses),
                 f"LeNet {what}: non-finite loss")
        _require(last < first, f"LeNet {what}: loss did not fall "
                               f"({first} -> {last})")
        out[what] = res
    return out


# ------------------------------------------------------------ phase 16
# Transformer-base: warm-up and timed steps; the greedy decode's sources
# and new tokens
TRANSFORMER_STEPS = (2, 5)
DECODE = dict(rows=4, steps=16)


def drive_transformer(device, seed: int) -> dict:
    """Phase 16 (seq2seq_bench.run_transformer): the first step's loss
    with use_flash_attention on and off under the same paddle.seed (the
    same dropout masks) within 1e-4 relative; then every count at 0 and
    2 warm-up + 5 timed steps: losses finite and falling, K1 12 forward
    and 12 backward launches a step, K2 none, LAST_PATH "flash" with
    bf16 q; then, in eval mode, the encoder over the same sources (6 K1
    forward launches) and a greedy decode of 16 tokens for 4 sources
    through gen_cache equal, token for token, to the decode without
    caches. Returns the run's numbers with the model and optimizer
    state (`built`), and K1's launches."""
    import math
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import packed_flash as k2
    from paddle_tpu_torch.tools import seq2seq_bench as sb
    st = sb.build_transformer(seed, device)
    L = st["cfg"]["layers"]

    def first_loss(flash: bool) -> float:
        flags.set_flags({"FLAGS_use_flash_attention": flash})
        try:
            paddle.seed(seed + 1)
            with torch.no_grad():
                return sb.transformer_forward(st).item()
        finally:
            flags.set_flags({"FLAGS_use_flash_attention": True})
    composed, flash = first_loss(False), first_loss(True)
    fns = (k1.flash_attention_fwd, k1.flash_attention_bwd,
           k2.packed_flash_fwd, k2.packed_flash_bwd)
    paddle.seed(seed + 1)
    for f in fns:
        f.launches = 0
    torch.cuda.synchronize()
    warm, steps = TRANSFORMER_STEPS
    res = sb.run_transformer(warm, steps, built=st)
    torch.cuda.synchronize()
    counts = [f.launches for f in fns]
    n = warm + steps
    want = [2 * L * n, 2 * L * n, 0, 0]
    losses = res["losses"]
    print(f"[transformer] losses {[round(v, 5) for v in losses]}")
    print(f"[transformer] step s {[round(t, 4) for t in res['step_s']]}; "
          f"tokens/s (source + target) {res['tokens_per_sec']:.1f}, MFU "
          f"{res['mfu']:.4f} ({res['flops_per_step']:.4e} FLOP a step by "
          f"seq2seq_bench.transformer_flops; bf16 peak 989 TFLOP/s), peak "
          f"memory {res['peak_mem_gb']:.2f} GB")
    rel = abs(flash - composed) / abs(composed)
    print(f"[transformer] launches fwd/bwd K1 {counts[0]}/{counts[1]}, K2 "
          f"{counts[2]}/{counts[3]} (want {want}); LAST_PATH "
          f"{res['last_path']} ({res['last_dtype']} q); first loss "
          f"{losses[0]:.7f}, flash route alone {flash:.7f} vs composed "
          f"{composed:.7f} (rel {rel:.3e}, limit 1e-4)")
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    _require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    _require(counts == want, f"transformer launches {counts} != {want}")
    _require(res["last_path"] == "flash" and res["last_dtype"] == "bfloat16",
             f"LAST_PATH {res['last_path']} {res['last_dtype']}")
    _require(rel <= 1e-4, f"first loss flash {flash} vs composed "
                          f"{composed}")
    _require(losses[0] == flash, f"first step's loss {losses[0]} != the "
                                 f"route check's {flash}")
    k1.flash_attention_fwd.launches = 0
    st["model"].eval()
    with torch.no_grad(), paddle.amp.auto_cast(level="O1",
                                               dtype="bfloat16"):
        st["model"].encode(st["src"])
    st["model"].train()
    enc = k1.flash_attention_fwd.launches
    print(f"[transformer] eval encoder: K1 forward launches {enc} "
          f"(want {L})")
    _require(enc == L, f"eval encoder K1 launches {enc} != {L}")
    src = st["src"][:DECODE["rows"]]
    ids_c, margins = sb.greedy_decode(st["model"], src, DECODE["steps"])
    ids_u, _ = sb.greedy_decode(st["model"], src, DECODE["steps"],
                                cached=False)
    same = bool((ids_c == ids_u).all())
    print(f"[transformer] greedy decode, {DECODE['rows']} sources x "
          f"{DECODE['steps']} tokens: cached == uncached {same}; smallest "
          f"top-2 margin a step {min(margins):.3e}")
    _require(same, f"cached greedy decode {ids_c.numpy().tolist()} != "
                   f"uncached {ids_u.numpy().tolist()}")
    res.update(counts=counts, built=st, encoder_launches=enc)
    return res


# ------------------------------------------------------------ phase 17
LSTM_STEPS = (2, 8)
BEAM = dict(rows=8, beam_size=4, max_step_num=20)
# the beam's scores on CUDA against the CPU run's (relative): f32 GEMMs
# sum in other orders on the two devices (TF32 off), about 1e-7 a
# log-probability over 20 steps of 10000-way softmaxes
BEAM_SCORE_REL = 1e-5


def drive_lstm(device, seed: int) -> dict:
    """Phase 17 (seq2seq_bench.run_lstm, beam_search): losses finite and
    falling over 2 warm-up + 8 steps; then beam search (beam 4, 20 steps)
    from 8 rows' states: ids and parents on CUDA equal to the CPU run's on
    the same weights, scores within BEAM_SCORE_REL."""
    import copy
    import math
    import numpy as np
    import torch
    from paddle_tpu_torch.tools import seq2seq_bench as sb
    st = sb.build_lstm(seed, device)
    warm, steps = LSTM_STEPS
    res = sb.run_lstm(warm, steps, built=st)
    losses = res["losses"]
    print(f"[lstm] losses {[round(v, 4) for v in losses]}")
    print(f"[lstm] step s {[round(t, 4) for t in res['step_s']]}; tokens/s "
          f"{res['tokens_per_sec']:.1f}, peak memory "
          f"{res['peak_mem_gb']:.3f} GB")
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    _require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    prefixes = st["x"][:BEAM["rows"]]
    t0 = time.perf_counter()
    out = sb.beam_search(st["model"], prefixes, BEAM["beam_size"],
                         BEAM["max_step_num"])
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    cpu_model = copy.deepcopy(st["model"]).to(device="cpu")
    ref = sb.beam_search(cpu_model, prefixes.cpu(), BEAM["beam_size"],
                         BEAM["max_step_num"])
    got = {k: v.cpu().numpy() for k, v in out.items()}
    want = {k: v.numpy() for k, v in ref.items()}
    rel = float(np.abs(got["scores"] - want["scores"]).max()
                / np.abs(want["scores"]).max())
    same = all(np.array_equal(got[k], want[k])
               for k in ("predicted_ids", "parent_ids"))
    print(f"[lstm] beam search {got['predicted_ids'].shape} in {beam_s:.3f}"
          f" s: ids and parents equal to the CPU run's {same}; scores max "
          f"rel err {rel:.3e} (limit {BEAM_SCORE_REL:g})")
    _require(same, "beam ids / parents differ between CUDA and the CPU")
    _require(rel <= BEAM_SCORE_REL, f"beam scores rel err {rel}")
    res.update(beam_s=beam_s, beam_rel=rel)
    return res


# ------------------------------------------------------------ phase 18
OPT_STEPS = 5
# parameters after OPT_STEPS steps on CUDA against the CPU (worst
# relative L2 error over the parameters): the same f32 updates, the
# gradients' GEMMs summed in other orders (TF32 off)
OPT_REL = 1e-5


def _new_optimizers():
    from paddle_tpu_torch import optimizer as O
    return {
        "SGD": lambda p: O.SGD(0.1, parameters=p),
        "Adamax": lambda p: O.Adamax(0.01, parameters=p),
        "Adadelta": lambda p: O.Adadelta(1.0, parameters=p),
        "Adagrad": lambda p: O.Adagrad(0.05, parameters=p),
        "RMSProp": lambda p: O.RMSProp(0.01, momentum=0.9, parameters=p),
        "RMSProp centered": lambda p: O.RMSProp(
            0.01, momentum=0.9, centered=True, parameters=p),
        "Lamb": lambda p: O.Lamb(0.01, parameters=p),
        "Lars": lambda p: O.Lars(0.1, parameters=p),
        "LarsMomentum": lambda p: O.LarsMomentum(0.1, momentum=0.5,
                                                 parameters=p)}


def check_optimizers(device, seed: int) -> dict:
    """Phase 18a: each new optimizer, OPT_STEPS eager steps on an MLP
    (32 -> 64 -> ReLU -> 10, batch 64) from the same weights and batch on
    the card and on the CPU; worst relative L2 error of the parameters
    within OPT_REL, and the loss falls."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.place import default_device
    nn, F = paddle.nn, paddle.nn.functional
    rng = np.random.RandomState(seed)
    x = rng.randn(64, 32).astype(np.float32)
    y = rng.randint(0, 10, (64,))
    worst = {}
    for name, make in _new_optimizers().items():
        params, losses = {}, {}
        for dev in (device, "cpu"):
            paddle.seed(seed)
            with default_device(dev):
                model = nn.Sequential(nn.Linear(32, 64), nn.ReLU(),
                                      nn.Linear(64, 10))
                xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
            opt = make(model.parameters())
            ls = []
            for _ in range(OPT_STEPS):
                loss = F.cross_entropy(model(xt), yt)
                loss.backward()
                opt.step()
                opt.clear_grad()
                ls.append(loss.item())
            params[str(dev)] = [p.detach().cpu() for p in model.parameters()]
            losses[str(dev)] = ls
        rel = max(((a - w).norm() / w.norm()).item() for a, w in
                  zip(params[str(device)], params["cpu"]))
        worst[name] = rel
        cl = losses[str(device)]
        print(f"[optimizers] {name}: {OPT_STEPS} steps, loss {cl[0]:.5f} -> "
              f"{cl[-1]:.5f}; parameters CUDA vs CPU worst rel L2 "
              f"{rel:.3e} (limit {OPT_REL:g})")
        _require(rel <= OPT_REL, f"{name}: CUDA vs CPU {rel} > {OPT_REL}")
        _require(cl[-1] < cl[0], f"{name}: loss did not fall {cl}")
    return worst


def check_save_load(built: dict, device, seed: int) -> None:
    """Phase 18b: paddle.save of phase 16's Transformer state_dict and
    Adam state_dict, paddle.load into a new model and optimizer (other
    random weights), then one more training step and the loss after it
    on both, each under the same paddle.seed: both losses bitwise
    equal."""
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import seq2seq_bench as sb
    with tempfile.TemporaryDirectory() as d:
        paddle.save(built["model"].state_dict(), f"{d}/model.pdparams")
        paddle.save(built["opt"].state_dict(), f"{d}/adam.pdopt")
        new = sb.build_transformer(seed + 7, device)
        for k in ("src", "tgt_in", "tgt_out", "tgt_mask"):
            new[k] = built[k]
        # the optimizer's state is keyed by parameter name; a new process
        # would generate the original's names, this one must give them
        old_names = {k: p.name for k, p in
                     built["model"].named_parameters()}
        for k, p in new["model"].named_parameters():
            p.name = old_names[k]
        missing, unexpected = new["model"].set_state_dict(
            paddle.load(f"{d}/model.pdparams"))
        new["opt"].set_state_dict(paddle.load(f"{d}/adam.pdopt"))
    _require(not missing and not unexpected,
             f"state names differ: {missing} {unexpected}")
    got = []
    for st in (built, new):
        paddle.seed(seed + 2)
        step_loss = sb.transformer_step(st)
        paddle.seed(seed + 3)
        got.append((step_loss, sb.transformer_forward(st).item()))
    print(f"[save/load] Transformer + Adam state through paddle.save / "
          f"paddle.load: step loss {got[0][0]!r} vs {got[1][0]!r}, next "
          f"loss {got[0][1]!r} vs {got[1][1]!r} (bitwise)")
    _require(got[0] == got[1], f"reloaded losses {got[1]} != {got[0]}")
    del new


# ------------------------------------------------------------ phase 19
# the first step of a vision model on the card against the same model
# on the CPU. At init, with batch statistics, these networks' gradients
# carry f32 rounding of about 1e-2 relative L2 (MobileNetV2 at batch 4 and
# ResNet-50 at batch 8, 224^2: the CPU's own f32 gradients lie 1.4e-2 and
# 2.8e-2 from a float64 evaluation, measured), so the f32 gradients are
# held to twice the f32 rounding the same run reads on the CPU (f32
# against f64) plus FIRST_STEP_TOL["grad32"], and the equality itself is
# held in float64; the f32 loss within FIRST_STEP_TOL["loss"] relative. A
# gradient that is zero in exact arithmetic (a BN bias under a later
# conv + BN) is compared against 5 % of the largest gradient's norm.
FIRST_STEP_TOL = dict(loss=1e-5, grad32=1e-4, grad64=1e-6)
MOBILENET_CHECK_B = 4
# MobileNetV2's warm-up and timed steps: RMSProp at the paper's 0.045 from
# a zero mean square moves every weight by ~3 x lr at first, and the loss
# on the fixed batch swings for a dozen steps (the H100 read 7.04 -> 16.76
# -> ... -> 23.62 at step 15 -> 5.03 at step 22), so 20 timed steps; the
# EMA check's limit (absolute, f32 shadows against the update by hand)
MOBILENET_STEPS = (2, 20)
EMA_TOL = 1e-6


def _eval_dropout(model) -> None:
    """Dropout layers to eval mode: the card and the CPU draw different
    masks, so the device checks run without them."""
    from paddle_tpu_torch.nn import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.eval()


def _first_step(build, x, y, dev, dtype):
    """The training-mode loss and every parameter's gradient (as f64 CPU
    tensors) of build(dev) cast to dtype, on x, y."""
    import torch
    from paddle_tpu_torch.tools import train_bench
    model = build(dev).to(dtype=dtype)
    model.train()
    _eval_dropout(model)
    params = [p for p in model.parameters() if p.requires_grad]
    loss = train_bench.ce_loss_fn(model, x.to(dev, dtype), y.to(dev))
    grads = [g.detach().cpu().double()
             for g in torch.autograd.grad(loss, params)]
    del model, params
    torch.cuda.empty_cache()
    return loss.item(), grads


def _grad_err(got, want) -> float:
    """The worst per-parameter relative L2 error, each against
    max(its own norm, 5 % of the largest gradient norm)."""
    top = max(w.norm().item() for w in want)
    return max((a - w).norm().item() / max(w.norm().item(), 0.05 * top)
               for a, w in zip(got, want))


def check_first_step(name, build_a, build_b, x, y, dev_a, dev_b,
                     transform=None) -> dict:
    """The first step of build_a on dev_a against build_b on dev_b (the
    same weights; transform maps the batch for b), in f32 and f64: the
    f32 loss within FIRST_STEP_TOL["loss"], the f32 gradients within
    twice b's f32 rounding (b in f32 against b in f64) plus
    FIRST_STEP_TOL["grad32"], the f64 gradients within
    FIRST_STEP_TOL["grad64"]."""
    import torch
    xb = transform(x) if transform else x
    tol = FIRST_STEP_TOL
    la32, ga32 = _first_step(build_a, x, y, dev_a, torch.float32)
    lb32, gb32 = _first_step(build_b, xb, y, dev_b, torch.float32)
    _, ga64 = _first_step(build_a, x, y, dev_a, torch.float64)
    lb64, gb64 = _first_step(build_b, xb, y, dev_b, torch.float64)
    lerr = abs(la32 - lb32) / abs(lb32)
    g32, floor32 = _grad_err(ga32, gb32), _grad_err(gb32, gb64)
    g64 = _grad_err(ga64, gb64)
    lim32 = 2 * floor32 + tol["grad32"]
    print(f"[{name}] first step, {x.shape[0]} images: f32 loss {la32:.7f} "
          f"vs {lb32:.7f} ({lerr:.2e} relative, limit {tol['loss']:g}; "
          f"f64 {lb64:.9f}); worst of {len(ga32)} gradients, f32 "
          f"{g32:.3e} relative L2 (limit {lim32:.3e}: f32 rounding "
          f"{floor32:.3e} against f64), f64 {g64:.3e} (limit "
          f"{tol['grad64']:g})")
    _require(lerr <= tol["loss"], f"{name} first f32 loss: {lerr}")
    _require(g32 <= lim32, f"{name} f32 gradients: {g32} > {lim32}")
    _require(g64 <= tol["grad64"], f"{name} f64 gradients: {g64}")
    return {"loss_rel": lerr, "grad32_rel_l2": g32, "f32_rounding": floor32,
            "grad64_rel_l2": g64}


def drive_mobilenet(device, seed: int) -> dict:
    """Phase 19: MobileNetV2 (scale 1.0, 1000 classes, 224^2) at its
    paper's recipe through tools/train_bench.py: the first step on the
    card against the CPU (check_first_step), then batch 96 under RMSProp
    + L2Decay + ExponentialDecay, O2 bf16 through jit.TrainStep and the
    EMA after every step: losses finite and falling, the EMA shadows
    equal to the same update by hand, apply()/restore() around one eval
    forward; imgs/s, MFU, peak memory and the profile's idle share."""
    import math
    import torch
    from paddle_tpu_torch.tools import train_bench
    from paddle_tpu_torch.vision.models import mobilenet_v2
    x, y = train_bench.vision_batch("mobilenet_v2", seed, "cpu")
    b = MOBILENET_CHECK_B

    def build(dev):
        return mobilenet_v2(device=dev, seed=seed)
    check = check_first_step("mobilenet_v2 card vs CPU", build, build,
                             x[:b].float(), y[:b], device,
                             torch.device("cpu"))
    torch.cuda.empty_cache()
    built = train_bench.build_vision("mobilenet_v2", seed, device)
    model, ema = built["model"], built["ema"]
    names = list(ema._params)
    manual = {k: ema._params[k].detach().float().clone() for k in names}
    warm, steps = MOBILENET_STEPS

    def by_hand():
        for k in names:
            manual[k] = 0.9999 * manual[k] + 0.0001 * ema._params[
                k].detach().float()

    # the warm-up steps, the EMA's update (inside the step) replayed by hand
    losses = []
    for _ in range(warm):
        losses.append(built["step"](built["x"], built["y"]).item())
        by_hand()
    ema_err = max((ema._shadow[k] - manual[k]).abs().max().item()
                  for k in names)
    del manual
    res = train_bench.run_vision("mobilenet_v2", 0, steps, built=built)
    losses += res["losses"]
    model.eval()
    live = {k: p.detach().clone() for k, p in model.named_parameters()}
    with ema.apply():
        swapped = all(torch.equal(p.detach(), ema._shadow[p.name].to(
            p.dtype)) for p in model.parameters())
        logits = model(built["x"][:8])
    restored = all(torch.equal(p.detach(), live[k])
                   for k, p in model.named_parameters())
    model.train()
    prof = train_bench.profile_steps(built["step"], (built["x"], built["y"]),
                                     3, train_bench._VISION_GROUPS,
                                     train_bench._VISION_RANGES)
    timed = losses[warm:warm + steps]
    print(f"[mobilenet_v2] losses {[round(v, 4) for v in losses]}; lr "
          f"{res['lr']}")
    print(f"[mobilenet_v2] batch {res['batch']}: imgs/s "
          f"{res['imgs_per_sec']:.1f}, MFU {res['mfu']:.4f} (3 x 2 x 300 M "
          f"multiply-adds an image over 989 TFLOP/s), peak memory "
          f"{res['peak_mem_gb']:.2f} GB, device idle share "
          f"{prof['idle_share']:.3f}; step s "
          f"{[round(t, 4) for t in res['step_s']]}")
    print(f"[mobilenet_v2] profile of 3 steps (s): "
          f"{ {k: round(v, 5) for k, v in prof['groups_s'].items()} }")
    print(f"[mobilenet_v2] EMA(0.9999) shadows vs the update by hand: max "
          f"|diff| {ema_err:.3e} (limit {EMA_TOL:g}); apply() swapped "
          f"{swapped}, eval logits {tuple(logits.shape)} finite "
          f"{bool(torch.isfinite(logits).all())}, restore() bitwise "
          f"{restored}")
    _require(all(math.isfinite(v) for v in losses), "MobileNetV2: "
             "non-finite loss")
    _require(timed[-1] < timed[0], f"MobileNetV2: loss did not fall over "
                                   f"the timed steps: {timed}")
    _require(ema_err <= EMA_TOL, f"EMA shadows off by {ema_err}")
    _require(swapped and restored, "EMA apply/restore")
    _require(bool(torch.isfinite(logits).all()), "EMA eval logits")
    res.update(check=check, ema_err=ema_err, idle_share=prof["idle_share"],
               profile=prof)
    del built, model, ema
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ phase 20
# NHWC against NCHW on the card (check_first_step's rule): batch; the
# space-to-depth stem's limit (of the plain stem's largest entry, f32)
NHWC_CHECK_B = 8
S2D_TOL = 1e-5

def drive_resnet_nhwc(device, seed: int, nchw: dict) -> dict:
    """Phase 20: resnet50(data_format="NHWC") on the NCHW model's weights
    and the permuted batch: the first loss and gradients equal
    (check_first_step); the space-to-depth stem equals the plain one in
    f32; then bench_resnet's geometry channel-last (O2, Momentum(0.1),
    128 x 224^2) beside phase 12's NCHW reading (`nchw`), with the
    profile's convolution, layout transform and copy time for both
    layouts. The channel-last steps must launch no layout transform
    (train_bench.LAYOUT_KEYS) and no more copies (COPY_KEYS) than the
    NCHW steps, and every 4-D weight must be channels_last after
    amp.decorate."""
    import math
    import torch
    from paddle_tpu_torch.tools import train_bench
    from paddle_tpu_torch.vision.models import resnet50
    x, y = train_bench.resnet_batch(seed, "cpu")
    x, y = x[:NHWC_CHECK_B].float(), y[:NHWC_CHECK_B]
    state = {k: v.numpy() for k, v in
             resnet50(device="cpu", seed=seed).state_dict().items()}

    def build(fmt):
        return lambda dev: resnet50(device=dev, seed=seed + 1,
                                    data_format=fmt).load_jax_params(state)
    check = check_first_step(
        "resnet50 NHWC vs NCHW", build("NHWC"), build("NCHW"),
        x.permute(0, 2, 3, 1).contiguous(), y, device, device,
        transform=lambda a: a.permute(0, 3, 1, 2).contiguous())
    a = build("NCHW")(device)
    xd = x.to(device)
    with torch.no_grad():
        plain = a.conv1(xd)
        folded = a._stem_s2d(xd)
        s2d_err = ((folded - plain).abs().max()
                   / plain.abs().max()).item()
    print(f"[resnet nhwc] space-to-depth stem vs the 7x7/s2 stem, f32, "
          f"{NHWC_CHECK_B} images: {s2d_err:.3e} (limit {S2D_TOL:g})")
    _require(s2d_err <= S2D_TOL, f"space-to-depth stem: {s2d_err}")
    del a, plain, folded, xd
    torch.cuda.empty_cache()
    out = {"check": check, "s2d_rel": s2d_err}
    for fmt in ("NHWC", "NCHW"):
        built = train_bench.build_resnet(seed, device, fmt)
        if fmt == "NHWC":
            weights = [p for p in built[0].parameters() if p.dim() == 4]
            strided = [p.name for p in weights if not p.is_contiguous(
                memory_format=torch.channels_last)]
            print(f"[resnet NHWC] {len(weights) - len(strided)} of "
                  f"{len(weights)} conv weights channels_last after "
                  f"amp.decorate (O2 bf16)")
            _require(not strided, f"NHWC conv weights not channels_last: "
                                  f"{strided}")
        res = (train_bench.run_resnet(2, 10, built=built)
               if fmt == "NHWC" else {})
        if fmt == "NCHW":
            train_bench.run_resnet(2, 0, built=built)
        prof = train_bench.profile_steps(built[1], built[2:], 3,
                                         train_bench._VISION_GROUPS,
                                         train_bench._VISION_RANGES)
        g, n = prof["groups_s"], prof["groups_n"]
        print(f"[resnet {fmt}] profile of 3 steps: conv (cuDNN) "
              f"{g['conv (cuDNN)']:.4f} s, layout transforms "
              f"{g['layout transform']:.4f} s ({n['layout transform']} "
              f"launches), copies / casts {g['copy / cast']:.4f} s "
              f"({n['copy / cast']} launches), batch norm "
              f"{g['batch_norm']:.4f} s, idle share "
              f"{prof['idle_share']:.3f}; top kernels "
              f"{[(k[:70], c) for k, c, _ in prof['top'][:5]]}")
        out[fmt] = {"profile": prof, **res}
        del built
        torch.cuda.empty_cache()
    r = out["NHWC"]
    print(f"[resnet nhwc] losses {[round(v, 5) for v in r['losses']]}; "
          f"imgs/s {r['imgs_per_sec']:.1f} (NCHW, phase 12: "
          f"{nchw['imgs_per_sec']:.1f}), MFU {r['mfu']:.4f}, peak memory "
          f"{r['peak_mem_gb']:.2f} GB")
    # the O2 curve on one fixed batch swings from step to step (Momentum
    # 0.1, no warm-up; NCHW and NHWC round differently and part after a
    # few steps): the timed steps' mean must lie below the first loss
    timed = r["losses"][2:]
    _require(all(math.isfinite(v) for v in r["losses"]), "NHWC non-finite "
             "loss")
    _require(sum(timed) / len(timed) < r["losses"][0],
             f"NHWC loss did not fall: {r['losses']}")
    nhwc, nchw_n = (out[f]["profile"]["groups_n"] for f in ("NHWC", "NCHW"))
    _require(nhwc["layout transform"] == 0, "the channel-last steps "
             f"launched {nhwc['layout transform']} layout transforms")
    _require(nhwc["copy / cast"] <= nchw_n["copy / cast"],
             f"the channel-last steps launched {nhwc['copy / cast']} "
             f"copies, the NCHW steps {nchw_n['copy / cast']}")
    return out


# ------------------------------------------------------------ phase 21
# VGG-16's warm-up and timed steps: at Momentum(0.01, 0.9) without warm-up
# the loss on the fixed batch rises for ~8 steps before it falls (the H100
# read 9.11 -> 15.66 at step 9 -> 0.17 at step 42; the CPU in f32 at batch
# 16 does the same), so 40 timed steps
VGG_STEPS = (2, 40)


def drive_vgg(device, seed: int) -> dict:
    """Phase 21: vgg16(batch_norm=True), configuration D, batch 64 on one
    card (256 over 4 GPUs in the paper), Momentum(0.01, 0.9),
    L2Decay(5e-4), O2: losses finite and falling over the timed steps;
    imgs/s, MFU, peak memory."""
    import math
    import torch
    from paddle_tpu_torch.tools import train_bench
    warm, steps = VGG_STEPS
    built = train_bench.build_vision("vgg16", seed, device)
    res = train_bench.run_vision("vgg16", warm, steps, built=built)
    timed = res["losses"][warm:]
    print(f"[vgg16] losses {[round(v, 4) for v in res['losses']]}")
    print(f"[vgg16] batch {res['batch']}: imgs/s {res['imgs_per_sec']:.1f}, "
          f"MFU {res['mfu']:.4f} (3 x 2 x "
          f"{built['flops_per_img'] / 6e9:.2f} G multiply-adds an image), "
          f"peak memory {res['peak_mem_gb']:.2f} GB")
    _require(all(math.isfinite(v) for v in res["losses"]), "VGG-16: "
             "non-finite loss")
    _require(timed[-1] < timed[0], f"VGG-16: loss did not fall: {timed}")
    del built
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ phase 22
# each vision functional and layer on the card against the CPU on the
# same inputs: the largest |card - CPU| over the CPU's largest entry, in
# f32 (TF32 off) and, for convolution, pooling and norms, with bf16
# inputs against the CPU's f32 on the same bf16 values. The limits
# (VISION_TOL) stand beside the largest readings of this phase on an
# NVIDIA H100 80GB HBM3 at 700 W (VISION_READINGS): about 4x and 2.5x
# them (f32: cuDNN and the CPU sum in other orders; bf16: ~2 ulps of
# 2**-8 on the output).
VISION_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
VISION_READINGS = {"float32": ("grid_sample bilinear / nearest", 5.49e-6),
                   "bfloat16": ("instance_norm", 7.83e-3)}


def _vision_cases():
    """(name, input shapes, fn(*tensors) -> tensor or tuple, bf16 too)."""
    import torch
    from paddle_tpu_torch.nn import functional as F

    def bn(fmt):
        def fn(x, w, b):
            c = w.shape[0]
            return F.batch_norm(x, torch.zeros(c, device=x.device),
                                torch.ones(c, device=x.device), w, b, True,
                                data_format=fmt)
        return fn

    def focal(x, t):
        return F.sigmoid_focal_loss(x, (t > 0.5).to(x.dtype), 4.0)

    def affine(t):
        eye = torch.tensor([[1.0, 0.1, 0.05], [-0.1, 0.9, 0.0]],
                           device=t.device)
        return F.affine_grid(eye + 0.1 * t, [4, 64, 48, 40], False)

    def sample(x, g, mode):
        return F.grid_sample(x, 1.2 * g, mode, "zeros", False)

    big = (2, 256, 64, 64)
    return [
        ("conv1d NLC", [(8, 128, 64), (96, 64, 5), (96,)],
         lambda x, w, b: F.conv1d(x, w, b, 2, 2, data_format="NLC"), True),
        ("conv2d NHWC depthwise", [(8, 56, 56, 144), (144, 1, 3, 3)],
         lambda x, w: F.conv2d(x, w, None, 2, 1, groups=144,
                               data_format="NHWC"), True),
        ("conv3d SAME", [(2, 16, 16, 32, 32), (32, 16, 3, 3, 3)],
         lambda x, w: F.conv3d(x, w, None, 1, "SAME"), True),
        ("conv1d_transpose", [(4, 64, 128), (64, 32, 4)],
         lambda x, w: F.conv1d_transpose(x, w, None, 2, 1), True),
        ("conv2d_transpose NHWC 256->128, 64^2", [(2, 64, 64, 256),
                                                 (256, 128, 4, 4), (128,)],
         lambda x, w, b: F.conv2d_transpose(x, w, b, 2, 1,
                                            data_format="NHWC"), True),
        ("conv2d_transpose groups, asymmetric", [(2, 256, 32, 32),
                                                 (256, 64, 3, 3)],
         lambda x, w: F.conv2d_transpose(x, w, None, 2, [1, 0, 2, 1],
                                         groups=2), True),
        ("conv3d_transpose output_size", [(2, 32, 8, 16, 16),
                                          (32, 16, 3, 3, 3)],
         lambda x, w: F.conv3d_transpose(x, w, None, 2, 1,
                                         output_size=[16, 32, 32]), True),
        ("max_pool2d ceil + mask", [(8, 64, 57, 57)],
         lambda x: F.max_pool2d(x, 3, 2, 1, return_mask=True,
                                ceil_mode=True), True),
        ("max_pool1d NLC", [(8, 130, 64)],
         lambda x: F.max_pool1d(x, 3, 2, 1, data_format="NLC"), True),
        ("max_pool3d", [(2, 32, 9, 17, 17)],
         lambda x: F.max_pool3d(x, 3, 2, [1, 0, 1], ceil_mode=True), True),
        ("avg_pool1d exclusive ceil", [(8, 64, 131)],
         lambda x: F.avg_pool1d(x, 4, 3, 1, ceil_mode=True), True),
        ("avg_pool2d NHWC divisor_override", [(8, 57, 57, 64)],
         lambda x: F.avg_pool2d(x, 3, 2, 1, divisor_override=7,
                                data_format="NHWC"), True),
        ("avg_pool3d", [(2, 32, 9, 17, 17)],
         lambda x: F.avg_pool3d(x, 2, 2, 0, exclusive=False), True),
        ("adaptive_avg_pool2d NHWC 7x7", [(8, 13, 13, 512)],
         lambda x: F.adaptive_avg_pool2d(x, 7, "NHWC"), True),
        ("adaptive_max_pool2d + mask", [(8, 64, 27, 31)],
         lambda x: F.adaptive_max_pool2d(x, [5, 7], True), True),
        ("adaptive pools 1d / 3d", [(8, 64, 61), (2, 32, 9, 10, 11)],
         lambda x, z: torch.cat([F.adaptive_avg_pool1d(x, 7).flatten(),
                                 F.adaptive_max_pool1d(x, 9).flatten(),
                                 F.adaptive_avg_pool3d(z, 3).flatten(),
                                 F.adaptive_max_pool3d(z, [2, 3, 4])
                                 .flatten()]), True),
        ("group_norm 256ch 64^2, 32 groups", [big, (256,), (256,)],
         lambda x, w, b: F.group_norm(x, 32, 1e-5, w, b), True),
        ("group_norm NHWC", [(2, 32, 32, 128), (128,), (128,)],
         lambda x, w, b: F.group_norm(x, 8, 1e-5, w, b, "NHWC"), True),
        ("instance_norm", [(4, 64, 32, 32), (64,), (64,)],
         lambda x, w, b: F.instance_norm(x, weight=w, bias=b), True),
        ("instance_norm NHWC", [(4, 32, 32, 64)],
         lambda x: F.instance_norm(x, data_format="NHWC"), True),
        ("local_response_norm", [(4, 96, 27, 27)],
         lambda x: F.local_response_norm(x, 5, 1e-3, 0.75, 2.0), True),
        ("batch_norm 3-D", [(16, 64, 100), (64,), (64,)], bn("NCL"), True),
        ("batch_norm 5-D NDHWC", [(2, 8, 16, 16, 32), (32,), (32,)],
         bn("NDHWC"), True),
        ("interpolate nearest 256ch 64^2 -> 128^2", [big],
         lambda x: F.interpolate(x, [128, 128]), False),
        ("interpolate bilinear up", [big],
         lambda x: F.interpolate(x, scale_factor=2, mode="bilinear"),
         False),
        ("interpolate bilinear down (antialias)", [big],
         lambda x: F.interpolate(x, [27, 45], mode="bilinear"), False),
        ("interpolate bicubic up", [big],
         lambda x: F.interpolate(x, [96, 80], mode="bicubic"), False),
        ("interpolate align_corners bilinear / bicubic", [big],
         lambda x: torch.cat([
             F.interpolate(x, [100, 90], mode="bilinear",
                           align_corners=True).flatten(),
             F.interpolate(x, [100, 90], mode="bicubic",
                           align_corners=True).flatten()]), False),
        ("interpolate trilinear / linear / area", [(2, 16, 8, 16, 16),
                                                   (4, 32, 50)],
         lambda x, z: torch.cat([
             F.interpolate(x, [12, 20, 24], mode="trilinear",
                           data_format="NCDHW").flatten(),
             F.interpolate(z, [77], mode="linear",
                           data_format="NCW").flatten(),
             F.interpolate(x[:, :, 0], [7, 5], mode="area").flatten()]),
         False),
        ("unfold / fold", [(4, 32, 30, 28), (4, 32 * 6, 15 * 15)],
         lambda x, c: torch.cat([
             F.unfold(x, [3, 2], 2, [1, 0, 2, 1], 1).flatten(),
             F.fold(c, [30, 28], [3, 2], 2, 1, 1).flatten()]), False),
        ("pixel_shuffle / unshuffle", [(4, 64, 32, 32), (4, 16, 32, 16)],
         lambda x, z: torch.cat([
             F.pixel_shuffle(x, 2).flatten(),
             F.pixel_shuffle(x.permute(0, 2, 3, 1), 2, "NHWC").flatten(),
             F.pixel_unshuffle(z, 2).flatten(),
             F.pixel_unshuffle(z.permute(0, 2, 3, 1), 4, "NHWC")
             .flatten()]), False),
        ("grid_sample bilinear / nearest", [(4, 32, 40, 48),
                                            (4, 30, 20, 2)],
         lambda x, g: torch.cat([sample(x, g.tanh(), "bilinear").flatten(),
                                 sample(x, g.tanh(), "nearest").flatten()]),
         False),
        ("affine_grid", [(4, 2, 3)], affine, False),
        ("temporal_shift", [(12, 64, 14, 14)],
         lambda x: torch.cat([
             F.temporal_shift(x, 4).flatten(),
             F.temporal_shift(x.permute(0, 2, 3, 1), 3, 0.125, "NHWC")
             .flatten()]), False),
        ("pad reflect / replicate / circular / constant",
         [(4, 32, 20, 24)],
         lambda x: torch.cat([F.pad(x, [2, 1, 0, 3], m, 0.5).flatten()
                              for m in ("reflect", "replicate", "circular",
                                        "constant")]), False),
        ("diag_embed / sigmoid_focal_loss", [(64, 33), (256, 80),
                                             (256, 80)],
         lambda d, x, t: torch.cat([F.diag_embed(d, 1, 0, 2).flatten(),
                                    focal(x, t.sigmoid()).flatten()]),
         False),
    ]


def _vision_layers():
    """(name, layer built on the CPU, input shape)."""
    from paddle_tpu_torch import nn
    return [
        ("Conv1D", nn.Conv1D(32, 48, 3, padding=1, padding_mode="circular"),
         (4, 32, 50)),
        ("Conv2D NHWC reflect", nn.Conv2D(32, 64, 3, 2, 1,
                                          padding_mode="reflect",
                                          data_format="NHWC"),
         (4, 33, 33, 32)),
        ("Conv3D", nn.Conv3D(16, 32, 3, padding="SAME"), (2, 16, 8, 12, 12)),
        ("Conv1DTranspose", nn.Conv1DTranspose(32, 16, 4, 2, 1),
         (4, 32, 40)),
        ("Conv2DTranspose", nn.Conv2DTranspose(64, 32, 4, 2, 1, groups=2),
         (4, 64, 16, 16)),
        ("Conv3DTranspose", nn.Conv3DTranspose(16, 8, 2, 2), (2, 16, 6, 8, 8)),
        ("MaxPool1D", nn.MaxPool1D(3, 2, 1), (4, 32, 51)),
        ("MaxPool2D NHWC", nn.MaxPool2D(3, 2, 1, data_format="NHWC"),
         (4, 31, 31, 32)),
        ("MaxPool3D", nn.MaxPool3D(2, ceil_mode=True), (2, 16, 7, 9, 9)),
        ("AvgPool1D", nn.AvgPool1D(3, 2, 1), (4, 32, 51)),
        ("AvgPool2D", nn.AvgPool2D(3, 2, 1, ceil_mode=True), (4, 32, 31, 31)),
        ("AvgPool3D", nn.AvgPool3D(2, 2), (2, 16, 8, 8, 8)),
        ("AdaptiveAvgPool1D", nn.AdaptiveAvgPool1D(5), (4, 32, 51)),
        ("AdaptiveAvgPool2D", nn.AdaptiveAvgPool2D((7, 7)), (4, 32, 13, 13)),
        ("AdaptiveAvgPool3D", nn.AdaptiveAvgPool3D(2), (2, 16, 7, 8, 9)),
        ("AdaptiveMaxPool1D", nn.AdaptiveMaxPool1D(5), (4, 32, 51)),
        ("AdaptiveMaxPool2D", nn.AdaptiveMaxPool2D(3), (4, 32, 13, 13)),
        ("AdaptiveMaxPool3D", nn.AdaptiveMaxPool3D(2), (2, 16, 7, 8, 9)),
        ("BatchNorm", nn.BatchNorm(32, act="relu"), (8, 32, 14, 14)),
        ("BatchNorm1D", nn.BatchNorm1D(32), (8, 32, 50)),
        ("BatchNorm3D", nn.BatchNorm3D(16), (2, 16, 6, 8, 8)),
        ("GroupNorm", nn.GroupNorm(8, 64), (4, 64, 16, 16)),
        ("InstanceNorm1D", nn.InstanceNorm1D(32), (4, 32, 50)),
        ("InstanceNorm2D", nn.InstanceNorm2D(32), (4, 32, 16, 16)),
        ("InstanceNorm3D", nn.InstanceNorm3D(16), (2, 16, 6, 8, 8)),
        ("LocalResponseNorm", nn.LocalResponseNorm(5), (4, 32, 16, 16)),
        ("Upsample", nn.Upsample(scale_factor=2, mode="bilinear"),
         (4, 32, 16, 16)),
        ("UpsamplingNearest2D", nn.UpsamplingNearest2D(size=[40, 24]),
         (4, 32, 16, 16)),
        ("UpsamplingBilinear2D", nn.UpsamplingBilinear2D(size=[40, 24]),
         (4, 32, 16, 16)),
        ("Pad1D", nn.Pad1D([2, 3], mode="reflect"), (4, 32, 20)),
        ("Pad2D", nn.Pad2D(2, mode="replicate"), (4, 32, 16, 16)),
        ("Pad3D", nn.Pad3D([1, 0, 2, 1, 0, 1], value=0.5), (2, 8, 6, 8, 8)),
        ("ZeroPad2D", nn.ZeroPad2D([1, 2, 0, 1]), (4, 32, 16, 16)),
        ("PixelShuffle", nn.PixelShuffle(2), (4, 64, 16, 16)),
    ]


def _vs_cpu(got, want) -> float:
    """The largest |got - want| over want's largest entry, over each
    tensor of a tuple; non-finite entries must match exactly."""
    import torch
    got = [got] if torch.is_tensor(got) else list(got)
    want = [want] if torch.is_tensor(want) else list(want)
    worst = 0.0
    for a, w in zip(got, want):
        a, w = a.detach().cpu().double(), w.detach().double()
        fin = w.isfinite()
        if not bool((a[~fin] == w[~fin]).all()):
            return float("inf")
        if fin.any():
            worst = max(worst, ((a - w)[fin].abs().max()
                                / w[fin].abs().max().clamp_min(1e-30))
                        .item())
    return worst


def check_vision_ops(device, seed: int) -> dict:
    """Phase 22: every vision functional (VISION cases) and layer on the
    card against the CPU, f32 and (convolution, pooling, norms) bf16;
    then ModelAverage and Lookahead over a few Momentum steps on an MLP,
    card against CPU."""
    import copy
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.place import default_device
    g = torch.Generator().manual_seed(seed)
    readings = {"float32": {}, "bfloat16": {}}
    for name, shapes, fn, lowp in _vision_cases():
        xs = [torch.randn(s, generator=g) for s in shapes]
        want = fn(*xs)
        readings["float32"][name] = _vs_cpu(
            fn(*[x.to(device) for x in xs]), want)
        if lowp:
            xb = [x.bfloat16() for x in xs]
            ref = fn(*[x.float() for x in xb])
            got = fn(*[x.to(device) for x in xb])
            got = (got if torch.is_tensor(got) else got[0]).float()
            readings["bfloat16"][name] = _vs_cpu(
                got, ref if torch.is_tensor(ref) else ref[0])
    with default_device("cpu"):
        paddle.seed(seed)
        layers = _vision_layers()
    for name, layer, shape in layers:
        x = torch.randn(shape, generator=g)
        layer.train()
        dev_layer = copy.deepcopy(layer).to(device)
        want = layer(x)
        readings["float32"][f"layer {name}"] = _vs_cpu(
            dev_layer(x.to(device)), want)
    for kind, v in _wrappers_vs_cpu(device, seed).items():
        readings["float32"][f"optimizer {kind}"] = v
    bad = []
    for dtype, tol in VISION_TOL.items():
        worst = sorted(readings[dtype].items(), key=lambda kv: -kv[1])
        print(f"[vision ops] {dtype}: {len(worst)} cases, card vs CPU "
              f"(of the CPU's largest entry), limit {tol:g}; the largest: "
              f"{[(k, f'{v:.2e}') for k, v in worst[:8]]}")
        bad += [(dtype, k) for k, v in worst if not v <= tol]
    _require(not bad, f"vision ops over their limit: {bad}")
    return readings


WRAPPER_KINDS = ("Momentum", "Lookahead", "ModelAverage",
                 "Lookahead + ModelAverage")


def _wrapper_runs(device, seed: int, dtype=None) -> dict:
    """Momentum alone, Lookahead(Momentum, k=2), ModelAverage over
    Momentum and ModelAverage over Lookahead(Momentum), each 5 steps over
    an MLP from the same starting weights and batch (in `dtype`, float32
    by default) on `device`: each one's final weights (with
    ModelAverage: applied), copied to the CPU. The starting weights are copies of an untrained reference
    net's, so no run starts from another's trained weights."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.place import default_device
    dtype = dtype or torch.float32
    rng = torch.Generator().manual_seed(seed + 1)
    xb = torch.randn(64, 32, generator=rng).to(device, dtype)
    yb = torch.randn(64, 8, generator=rng).to(device, dtype)
    with default_device("cpu"):
        paddle.seed(seed)
        ref = paddle.nn.Sequential(paddle.nn.Linear(32, 64),
                                   paddle.nn.ReLU(), paddle.nn.Linear(64, 8))
    state = {k: v.detach().numpy().copy() for k, v in ref.state_dict().items()}
    out = {}
    for kind in WRAPPER_KINDS:
        with default_device(device):
            net = paddle.nn.Sequential(paddle.nn.Linear(32, 64),
                                       paddle.nn.ReLU(),
                                       paddle.nn.Linear(64, 8))
        net.to(dtype=dtype)
        net.set_state_dict(state)
        params = list(net.parameters())
        opt = paddle.optimizer.Momentum(0.05, 0.9, parameters=params)
        if "Lookahead" in kind:
            opt = paddle.optimizer.Lookahead(opt, alpha=0.5, k=2)
        ma = paddle.optimizer.ModelAverage(0.15, parameters=params,
                                           min_average_window=2,
                                           max_average_window=10)
        for _ in range(5):
            ((net(xb) - yb) ** 2).mean().backward()
            opt.step()
            opt.clear_grad()
            ma.update()
        if "ModelAverage" in kind:
            with ma.apply():
                out[kind] = [p.detach().cpu().clone() for p in params]
        else:
            out[kind] = [p.detach().cpu().clone() for p in params]
    return out


def _wrappers_vs_cpu(device, seed: int) -> dict:
    """_wrapper_runs on `device` against the CPU: the largest difference
    of each kind's final weights (_vs_cpu)."""
    got = _wrapper_runs(device, seed)
    want = _wrapper_runs("cpu", seed)
    return {kind: max(_vs_cpu(a, w) for a, w in zip(got[kind], want[kind]))
            for kind in WRAPPER_KINDS}


def run_serving(device, seed: int) -> dict:
    """Phases 3-6e and the fleet phases 23-27; returns K3's kernel entry
    (its launches from phase 6, 6a-6d's in pass_launches, 23-27's in
    fleet_launches)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_decode_attention)
    from paddle_tpu_torch.tools.engine_bench import serving_setup
    from paddle_tpu_torch.tools.serving_traffic import (bench_traffic,
                                                        drive_engine)
    max_err = check_k3(device, seed)
    timing = time_k3(device, seed)
    full = time_k3(device, seed, FULL_LENGTHS, "full-context")

    # the serving bench's model and engine (K3_SHAPE), warmed up on two
    # short requests
    model, ecfg = serving_setup(device, seed)
    cfg = model.cfg
    check_logits(model, device, seed)
    specs = bench_traffic(cfg.vocab_size, seed)
    ragged_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, rids = drive_engine(model, ecfg, specs, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_decode_attention.launches
    chunks = eng.stats.host_syncs("decode")
    want = cfg.num_layers * ecfg.decode_chunk_size * chunks
    print(f"[engine] K3 launches {launches} = {cfg.num_layers} layers x "
          f"{ecfg.decode_chunk_size} trips x {chunks} chunks: "
          f"{launches == want}")
    _require(launches == want and (launches > 0 or not cuda),
             f"K3 launched {launches} times, expected {want}")
    d = eng.stats.as_dict()
    ttft = np.array([eng.get_request(r).first_token_time
                     - eng.get_request(r).arrival_time for r in rids])
    print(f"[engine] {len(rids)} requests, {d['generated_tokens']} tokens, "
          f"{d['steps']} steps, {d['preemptions']} preemptions, wall "
          f"{wall:.3f} s")
    print(f"[engine] decode tokens/s {d['decode_tokens_per_sec']:.1f} "
          f"(generated / (prefill + decode time)); decode-only "
          f"{d['generated_tokens'] / d['time_decode']:.1f}; time prefill "
          f"{d['time_prefill']:.3f} s, decode {d['time_decode']:.3f} s, "
          f"schedule {d['time_schedule']:.3f} s")
    print(f"[engine] TTFT mean {ttft.mean() * 1e3:.1f} ms, p50 "
          f"{np.percentile(ttft, 50) * 1e3:.1f} ms, max "
          f"{ttft.max() * 1e3:.1f} ms")
    check_registry_ttft(eng, ttft)
    parted = check_engine_outputs(model, eng, rids, specs)
    print(f"[engine] greedy tokens vs dense generate(): {parted} of "
          f"{len(rids)} requests parted (each at a top-2 margin < 1e-3)")
    del eng
    torch.cuda.empty_cache()
    tracing_off(model, ecfg, specs, device, d["decode_tokens_per_sec"])
    passes = run_prefix_passes(model, ecfg, device, seed)
    passes["tenant"] = run_tenant_pass(model, ecfg, device, seed)
    run_facade(model, ecfg, device, seed)
    fleet = run_fleet(model, ecfg, device, seed)
    READINGS.clear()
    del model
    torch.cuda.empty_cache()
    return {
        "name": "ragged_decode_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/"
                  "ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:127",
        "launches": launches, "max_abs_err": max_err, **timing,
        "full_context": full, "pass_launches": passes,
        "fleet_launches": fleet}


FLASH_SOURCE = "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu"
FLASH_ENTRIES = (
    ("flash_attention_fwd", "k1", 0,
     "paddle_tpu/ops/pallas/flash_attention.py:186"),
    ("flash_attention_bwd", "k1", 1,
     "paddle_tpu/ops/pallas/flash_attention.py:203"),
    ("packed_flash_fwd", "k2", 0, "paddle_tpu/ops/pallas/packed_flash.py:212"),
    ("packed_flash_bwd", "k2", 1, "paddle_tpu/ops/pallas/packed_flash.py:368"),
    ("packed_flash_fwd_noncausal", "k2_nc", 0,
     "paddle_tpu/ops/pallas/packed_flash.py:212"),
    ("packed_flash_bwd_noncausal", "k2_nc", 1,
     "paddle_tpu/ops/pallas/packed_flash.py:368"),
    ("flash_attention_fwd_d64_noncausal", "k1_d64", 0,
     "paddle_tpu/ops/pallas/flash_attention.py:186"),
    ("flash_attention_bwd_d64_noncausal", "k1_d64", 1,
     "paddle_tpu/ops/pallas/flash_attention.py:203"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    build_kernels()
    kernels = [run_serving(device, args.seed)]
    errs = {k: check_flash(k, device, args.seed) for k in FLASH}
    timing = {k: time_flash(k, device, args.seed) for k in FLASH}
    k1_f16 = time_flash("k1", device, args.seed, torch.float16)
    train = {6: drive_train(6, 2, 10, device, args.seed),
             12: drive_train(12, 2, 3, device, args.seed)}
    eager = drive_eager(device, args.seed)
    k4 = check_k4(device, args.seed)
    k4_model = check_k4_on_model(device, args.seed)
    resnet = drive_resnet(device, args.seed)
    # bench_ernie's 15 timed steps: AdamW(1e-4) without warm-up makes the
    # first steps' loss rise and swing in both packages (tests/
    # test_torch_bert.py holds the port's O2 curve to the JAX package's),
    # and at 5 timed steps the swing had not settled below step 1's loss
    ernie = drive_mlm("ernie", 2, 15, device, args.seed)
    drive_mlm("bert", 2, 10, device, args.seed)
    drive_lenet(device, args.seed)
    transformer = drive_transformer(device, args.seed)
    check_save_load(transformer.pop("built"), device, args.seed)
    torch.cuda.empty_cache()
    drive_lstm(device, args.seed)
    check_optimizers(device, args.seed)
    drive_mobilenet(device, args.seed)
    drive_resnet_nhwc(device, args.seed, resnet)
    drive_vgg(device, args.seed)
    check_vision_ops(device, args.seed)
    counts = {"k1": train[6]["counts"][:2], "k2": train[12]["counts"][2:],
              "k2_nc": ernie["counts"][2:],
              "k1_d64": transformer["counts"][:2]}
    for name, kernel, i, replaces in FLASH_ENTRIES:
        kernels.append({"name": name, "route": "cuda",
                        "source": FLASH_SOURCE, "replaces": replaces,
                        "launches": counts[kernel][i],
                        "max_abs_err": errs[kernel]["bfloat16"][
                            ("fwd", "bwd")[i]],
                        **timing[kernel][i]})
        if kernel == "k1":
            # K1's launches on phase 9b's eager path (its own count), and
            # its float16 instance: phase 7's max |err|, phase 8's times
            # and its launches on phase 9b's float16 run
            kernels[-1].update(
                eager_launches=eager["counts"][i],
                transformer_launches=transformer["counts"][i],
                f16_max_abs_err=errs[kernel]["float16"][("fwd", "bwd")[i]],
                f16_ms=k1_f16[i]["ms"], f16_plain_ms=k1_f16[i]["plain_ms"],
                f16_library_ms=k1_f16[i]["library_ms"],
                f16_launches=eager["fp16"]["k1"][i])
    total = {key: sum(r[key] for r in k4)
             for key in ("ms", "plain_ms", "bound_ms", "composed_ms",
                         "matmul_ms", "profiler_ms")}
    # times summed over the five block-boundary geometries; no single
    # PyTorch call computes relu(x * scale + shift (+ z)) @ w, so
    # library_ms is null (composed_ms and matmul_ms are the yardsticks);
    # profiler_ms is the kernel's own device time, model_boundary_ms the
    # model's BN-apply + ReLU + 1x1 conv on phase 11's tensors, beside
    # K4's on_model_ms there
    kernels.append({"name": "fused_scale_relu_matmul", "route": "cuda",
                    "source": K4_SOURCE,
                    "replaces": "tools/fused_conv_proto.py:75",
                    "launches": k4_model["launches"],
                    "max_abs_err": max(r["agreement"]["abs"] for r in k4),
                    "ms": total["ms"], "plain_ms": total["plain_ms"],
                    "bound_ms": total["bound_ms"],
                    "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                                for r in k4)
                                 else "operations"),
                    "library_ms": None, "composed_ms": total["composed_ms"],
                    "matmul_ms": total["matmul_ms"],
                    "profiler_ms": total["profiler_ms"],
                    "model_boundary_ms": k4_model["model_ms"],
                    "on_model_ms": k4_model["k4_ms"]})
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
