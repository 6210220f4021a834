#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a GPU and the CUDA
toolkit. Phases, each of which fails the run (non-zero exit) on error:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from this checkout's sources (K3 of the
   serving path, K1/K2 of the train step; one nvcc per source, started
   together) and print what `ptxas -v` reports;
3. hold K3 against its plain PyTorch version on the card at the shapes
   the serving path gives it (f32 within 1e-5, bf16 within 1e-2);
4. time K3, its plain version and the one-call PyTorch yardstick
   with CUDA events, cold L2, beside the bytes/operations bound;
5. one full-width paged_decode_step through the kernel against the dense
   decode_step, logits within 1e-4 * max|logit|;
6. the serving engine at the full width of the serving bench (GPT 768
   hidden, 12 layers, 6 heads of 128, vocab 32768, 1024 positions; 16
   greedy requests, prompts 64-256, outputs 64-256, staggered arrivals,
   random weights from --seed): every request finishes, the cache audits
   clean, the kernel launched layers x k x chunks times, and the tokens
   equal the port's dense generate() except where the reference's top-2
   logit margin is under 1e-3;
7. flash kernels K1 (6 heads of 128) and K2 (12 heads of 64, packed
   pairs) against their plain versions at the train step's attention
   shape (B 32, T 1024, causal): out, lse, dq, dk and dv in f32 and in
   bf16, each held to the limits of FLASH_TOL (relative L2 error, and
   per element against one bf16 ulp of the plain value);
8. their forward and backward timed with CUDA events at that shape
   (bf16, cold L2) beside the plain versions, the
   F.scaled_dot_product_attention(is_causal=True) yardstick (forward,
   and its backward call) and the bound at the bf16 tensor peak;
9. the GPT train step at the full width of bench.py's bench_gpt (vocab
   32768, hidden 768, 12 layers, 32 x 1024 tokens, AMP O2 bf16 with f32
   masters, AdamW + global-norm clip, jit.TrainStep) with 6 heads (K1;
   2 warm-up + 10 steps) and 12 heads (K2; 2 + 3): every loss finite,
   the loss falls, LAST_PATH == "flash", 12 forward and 12 backward
   launches per step, the first step's loss within 1e-4 relative of the
   same forward with use_flash_attention off (composed attention), and
   every parameter's gradient on the first GRAD_B rows of the batch
   within GRAD_TOL (relative L2) of the composed route's.

The last three lines are: one JSON object with each kernel's numbers,
the card's name and power limit, and {"ok": true, "device": {...}}.
float32 matmuls run in full float32 (TF32 off) throughout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor
# FLOP/s, bf16 dense tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# the serving slice's kernel shapes: the engine's max_num_seqs rows, the
# model's heads and head_dim, the engine's block size and pool, and
# max_seq_len / block_size table columns
N, H, D, BS, NB = 8, 6, 128, 32, 512
MB = 1024 // BS
LENGTHS = (0, 1, 31, 32, 33, 300, 1023, 1024)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2
def build_kernels() -> None:
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"[build] {len(reports)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f} s: {', '.join(reports)}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "ptxas" in line:
                print(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------ phase 3-4
def k3_inputs(device, dtype, seed: int):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    need = [-(-n // BS) for n in LENGTHS]
    blocks = rng.permutation(NB)[:sum(need)]
    tables = np.zeros((N, MB), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = blocks[at:at + n]
        at += n
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(N, H, D, generator=g)
    kp = torch.randn(NB, BS, H, D, generator=g)
    vp = torch.randn(NB, BS, H, D, generator=g)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            torch.from_numpy(tables).to(device),
            torch.tensor(LENGTHS, dtype=torch.int32, device=device))


def check_k3(device, seed: int) -> float:
    import torch
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_attention_reference, ragged_decode_attention)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        args = k3_inputs(device, dtype, seed)
        got = ragged_decode_attention(*args)
        torch.cuda.synchronize()
        want = ragged_attention_reference(*args)
        err = (got.float() - want.float()).abs().max().item()
        errs[dtype] = err
        print(f"[k3] kernel vs plain, {str(dtype)[6:]} pools: max |err| "
              f"{err:.3e} (tolerance {tol:g})")
        _require(err <= tol, f"K3 disagrees with its plain version in "
                             f"{dtype}: {err} > {tol}")
        _require(bool(torch.all(got[0] == 0)), "K3 dead row is not zero")
    return errs[torch.float32]


def cold_ms(fn, iters: int) -> float:
    """Mean device ms of fn() with L2 flushed before each call (the
    engine finds each layer's pools cold)."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def time_k3(device, seed: int) -> dict:
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.inference.serving import gather_block_kv
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_attention_reference, ragged_decode_attention)
    q, kp, vp, tables, lengths = k3_inputs(device, torch.float32, seed)
    ms = cold_ms(lambda: ragged_decode_attention(q, kp, vp, tables,
                                                 lengths), 50)
    plain_ms = cold_ms(lambda: ragged_attention_reference(
        q, kp, vp, tables, lengths), 10)
    # yardstick only (never called by the port): SDPA over the context
    # gathered beforehand, masked by length; the gather is not timed
    kc, vc = gather_block_kv(kp, tables), gather_block_kv(vp, tables)
    mask = (torch.arange(MB * BS, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = cold_ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask), 50)
    live = sum(LENGTHS)
    nbytes = (live * H * D * 2 * 4 + 2 * N * H * D * 4
              + sum(-(-n // BS) for n in LENGTHS) * 4 + N * 4)
    flops = 4 * live * H * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"[k3] timing (cold L2, mean): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA yardstick {library_ms:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms by {out['bound_by']} "
          f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
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
def check_engine_outputs(model, eng, rids, specs) -> int:
    """Every request finished and the cache is whole; greedy tokens equal
    the port's dense generate() except where the dense reference's top-2
    margin is under 1e-3. Returns how many requests parted."""
    import numpy as np
    import torch
    import paddle_tpu_torch.models.generation as gen
    eng.cache.check_integrity()
    _require(eng.cache.num_free() == eng.cache.num_blocks,
             "blocks leaked after drain")
    params = gen.extract_params(model)
    parted = 0
    for rid, (prompt, max_tokens) in zip(rids, specs):
        req = eng.get_request(rid)
        _require(req.state in ("finished_length", "finished_stopped"),
                 f"{rid} ended {req.state}")
        got = np.asarray(req.output_ids)
        ref = gen.generate(model, prompt[None], max_tokens)[0, len(prompt):]
        _require(got.shape == ref.shape and np.all(got >= 0),
                 f"{rid}: {got.shape} tokens, want {ref.shape}")
        diff = np.nonzero(got != ref)[0]
        if diff.size:
            t = int(diff[0])
            ctx = np.concatenate([prompt, ref[:t]]).astype(np.int32)[None]
            logits, _ = gen.prefill(params, torch.from_numpy(ctx),
                                    model.cfg.geom)
            top2 = torch.topk(logits[0], 2).values
            margin = (top2[0] - top2[1]).item()
            print(f"[engine] {rid} parts from dense generate() at token {t} "
                  f"(reference top-2 margin {margin:.3e})")
            _require(margin < 1e-3, f"{rid} parted at a clear margin")
            parted += 1
    return parted


# ------------------------------------------------------------ phase 7
# the train step's attention: T 1024, causal; K1 6 heads of 128, K2 12
# heads of 64 packed in 6 pairs of 128 lanes
TRAIN_T, TRAIN_B = 1024, 32
FLASH = {
    "k1": dict(heads=6, width=128, head_dim=128, scale=1.0 / 128 ** 0.5),
    "k2": dict(heads=6, width=128, head_dim=64, scale=1.0 / 8.0)}


def _flash_fns(kernel):
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import packed_flash as k2
    if kernel == "k1":
        return (k1.flash_attention_fwd, k1.flash_attention_bwd,
                k1.flash_attention_reference)
    return k2.packed_flash_fwd, k2.packed_flash_bwd, k2.packed_flash_reference


def flash_inputs(kernel, b, dtype, device, seed):
    import torch
    c = FLASH[kernel]
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, c["heads"], TRAIN_T, c["width"],
                        generator=g).to(device, dtype) for _ in range(4)]


# agreement limits per tensor. f32: relative L2 error and max |err| over
# max |w|. bf16, where kernel and plain version each round an f32 result
# once, so a sound element differs by about one bf16 ulp (2^-7 of its
# magnitude) at most: relative L2 error, and the worst excess of |err|
# over one ulp of |w| in units of the tensor's rms. dq and dk get wider
# bf16 limits: the kernel's delta = rowsum(do * o) reads the bf16 output,
# as FA2 does, while the plain version's autograd uses the f32 one (a
# plain FA2 backward with that delta reads the same errors on the CPU)
BF16_ULP = 2.0 ** -7
_F32_TOL = dict(l2=1e-5, peak=1e-4)
_BF16_TIGHT = dict(l2=5e-4, excess=1e-3)
_BF16_DELTA = dict(l2=4e-3, excess=0.5)
FLASH_TOL = {
    "float32": dict.fromkeys(("out", "lse", "dq", "dk", "dv"), _F32_TOL),
    "bfloat16": {"out": _BF16_TIGHT, "lse": dict(l2=1e-6, excess=1e-3),
                 "dq": _BF16_DELTA, "dk": _BF16_DELTA, "dv": _BF16_TIGHT}}


def agreement(a, w) -> dict:
    """How far a lies from w: relative L2 error, max |err| (also over
    max |w|), and the worst excess of |err| over one bf16 ulp of |w| in
    units of rms(w)."""
    a, w = a.float(), w.float()
    d = (a - w).abs()
    wn = w.norm()
    rms = wn / w.numel() ** 0.5
    return {"l2": ((a - w).norm() / wn).item(), "abs": d.max().item(),
            "peak": (d.max() / w.abs().max()).item(),
            "excess": ((d - BF16_ULP * w.abs()).clamp_min(0).max()
                       / rms).item()}


def check_flash(kernel, device, seed: int) -> dict:
    """Kernel vs plain at the train step's shape (B 32): out, lse, dq, dk
    and dv in f32 and in bf16, the main path's dtype. Returns bf16 max
    |err| of the forward (out, lse) and of the backward (dq, dk, dv)."""
    import torch
    fwd, bwd, ref = _flash_fns(kernel)
    sc = FLASH[kernel]["scale"]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        tol = FLASH_TOL[dname]
        q, k, v, do = flash_inputs(kernel, TRAIN_B, dtype, device, seed)
        o, lse = fwd(q, k, v, True, sc)
        got = (o, lse, *bwd(q, k, v, o, lse, do, True, sc))
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        ro, rlse = ref(qr, kr, vr, True, sc, return_lse=True)
        want = (ro.detach(), rlse.detach(),
                *torch.autograd.grad(ro, (qr, kr, vr), do))
        del ro, rlse, qr, kr, vr
        stats, bad = {}, []
        for name, a, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            _require(a.shape == w.shape and a.dtype == w.dtype,
                     f"{kernel} {name}: {a.shape}/{a.dtype} vs "
                     f"{w.shape}/{w.dtype}")
            stats[name] = agreement(a, w)
            bad += [f"{name} {m} {stats[name][m]:.3e} > {lim:g}"
                    for m, lim in tol[name].items() if stats[name][m] > lim]
        print(f"[{kernel}] kernel vs plain, {dname}, B {TRAIN_B} T "
              f"{TRAIN_T} causal (limits FLASH_TOL): " + "; ".join(
                  f"{n} l2 {st['l2']:.2e} abs {st['abs']:.2e} peak "
                  f"{st['peak']:.1e} excess {st['excess']:.2e}"
                  for n, st in stats.items()))
        _require(not bad, f"{kernel} disagrees with its plain version in "
                          f"{dname}: {bad}")
        errs = {"fwd": max(stats[n]["abs"] for n in ("out", "lse")),
                "bwd": max(stats[n]["abs"] for n in ("dq", "dk", "dv"))}
        del got, want, q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return errs


# ------------------------------------------------------------ phase 8
def time_flash(kernel, device, seed: int):
    """(forward numbers, backward numbers) at B 32, bf16, cold L2."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.packed_flash import _unpack
    fwd, bwd, ref = _flash_fns(kernel)
    c = FLASH[kernel]
    sc = c["scale"]
    q, k, v, do = flash_inputs(kernel, TRAIN_B, torch.bfloat16, device,
                               seed)
    o, lse = fwd(q, k, v, True, sc)
    ms_f = cold_ms(lambda: fwd(q, k, v, True, sc), 10)
    ms_b = cold_ms(lambda: bwd(q, k, v, o, lse, do, True, sc), 5)
    plain_f = cold_ms(lambda: ref(q, k, v, True, sc), 3)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    ro = ref(qr, kr, vr, True, sc)
    plain_b = cold_ms(lambda: torch.autograd.grad(
        ro, (qr, kr, vr), do, retain_graph=True), 3)
    del ro
    # yardstick only (never called by the port): SDPA on heads-major
    # [B, H, T, D] (K2's inputs unpacked beforehand, not timed)
    if kernel == "k2":
        q, k, v, do = (_unpack(t).contiguous() for t in (q, k, v, do))
    lib_f = cold_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib_b = cold_ms(lambda: torch.autograd.grad(
        so, (qs, ks, vs), do, retain_graph=True), 10)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        torch.autograd.grad(out, (qs, ks, vs), do)
    lib_fb = cold_ms(fwd_bwd, 10)
    del so
    B, H, T, D = q.shape[0], q.shape[1], q.shape[2], q.shape[3]
    pairs = T * (T + 1) // 2               # causal (row >= col) pairs
    elem = B * H * T * D
    res = []
    for what, ms, plain, lib, flops, nbytes in (
            ("forward", ms_f, plain_f, lib_f, 4 * B * H * D * pairs,
             4 * elem * 2 + B * H * T * 4),
            ("backward", ms_b, plain_b, lib_b, 10 * B * H * D * pairs,
             8 * elem * 2 + B * H * T * 4)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        entry = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                 "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        res.append(entry)
        print(f"[{kernel}] {what} timing, B {B} H {H} T {T} D {D} bf16 "
              f"causal (cold L2, mean): kernel {ms:.4f} ms, plain "
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


def drive_train(num_heads: int, warmup: int, steps: int, device,
                seed: int) -> dict:
    """The full-width train step; checks losses, routing, launches and
    the first step's loss against composed attention."""
    import math
    import torch
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import packed_flash as k2
    from paddle_tpu_torch.tools import train_bench
    built = train_bench.build(num_heads, seed, device)
    model, _, x, y = built
    params = [p for p in model.parameters() if p.requires_grad]

    def route(flash: bool):
        """(first-step loss on the whole batch, per-leaf gradients on the
        first GRAD_B rows) with the flash route on or off."""
        flags.set_flags({"FLAGS_use_flash_attention": flash})
        try:
            with torch.no_grad():
                loss = gpt_loss_fn(model, x, y).item()
            grads = torch.autograd.grad(
                gpt_loss_fn(model, x[:GRAD_B], y[:GRAD_B]), params)
        finally:
            flags.set_flags({"FLAGS_use_flash_attention": True})
        return loss, grads

    composed, g_comp = route(False)
    flash_loss, g_flash = route(True)
    gerr = max(((a.float() - w.float()).norm()
                / w.float().norm().clamp_min(1e-30)).item()
               for a, w in zip(g_flash, g_comp))
    del g_comp, g_flash
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


def run_serving(device, seed: int) -> dict:
    """Phases 3-6; returns K3's kernel entry."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import EngineConfig
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_decode_attention)
    from paddle_tpu_torch.tools.serving_traffic import (bench_traffic,
                                                        drive_engine)
    max_err = check_k3(device, seed)
    timing = time_k3(device, seed)

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_heads=6, max_seq_len=1024)
    model = GPT(cfg, device=device, seed=seed)
    model.eval()
    check_logits(model, device, seed)

    ecfg = EngineConfig(block_size=BS, num_blocks=NB, max_num_seqs=N,
                        max_prefill_tokens=2048, decode_chunk_size=8,
                        kernel="ragged", prefill_chunk_threshold=128)
    # warm-up on two short requests (library init, allocator), not counted
    drive_engine(model, ecfg, bench_traffic(cfg.vocab_size, seed + 1,
                                            n_req=2, t_lo=16, t_hi=17),
                 device)
    specs = bench_traffic(cfg.vocab_size, seed)
    ragged_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, rids = drive_engine(model, ecfg, specs, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_decode_attention.launches
    chunks = eng.stats.host_syncs["decode"]
    want = cfg.num_layers * ecfg.decode_chunk_size * chunks
    print(f"[engine] K3 launches {launches} = {cfg.num_layers} layers x "
          f"{ecfg.decode_chunk_size} trips x {chunks} chunks: "
          f"{launches == want}")
    _require(launches > 0 and launches == want,
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
    parted = check_engine_outputs(model, eng, rids, specs)
    print(f"[engine] greedy tokens vs dense generate(): {parted} of "
          f"{len(rids)} requests parted (each at a top-2 margin < 1e-3)")
    del model, eng
    torch.cuda.empty_cache()
    return {
        "name": "ragged_decode_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/"
                  "ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:127",
        "launches": launches, "max_abs_err": max_err, **timing}


FLASH_SOURCE = "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu"
FLASH_ENTRIES = (
    ("flash_attention_fwd", "k1", 0,
     "paddle_tpu/ops/pallas/flash_attention.py:186"),
    ("flash_attention_bwd", "k1", 1,
     "paddle_tpu/ops/pallas/flash_attention.py:203"),
    ("packed_flash_fwd", "k2", 0, "paddle_tpu/ops/pallas/packed_flash.py:212"),
    ("packed_flash_bwd", "k2", 1, "paddle_tpu/ops/pallas/packed_flash.py:368"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
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
    train = {6: drive_train(6, 2, 10, device, args.seed),
             12: drive_train(12, 2, 3, device, args.seed)}
    counts = {"k1": train[6]["counts"][:2], "k2": train[12]["counts"][2:]}
    for name, kernel, i, replaces in FLASH_ENTRIES:
        kernels.append({"name": name, "route": "cuda",
                        "source": FLASH_SOURCE, "replaces": replaces,
                        "launches": counts[kernel][i],
                        "max_abs_err": errs[kernel][("fwd", "bwd")[i]],
                        **timing[kernel][i]})
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
