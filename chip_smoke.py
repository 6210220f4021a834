#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a GPU and the CUDA
toolkit. Phases, each of which fails the run (non-zero exit) on error:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the serving path from this checkout's
   sources (one nvcc per source, started together) and print what
   `ptxas -v` reports;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (f32 within 1e-5, bf16 within 1e-2);
4. time the kernel, its plain version and the one-call PyTorch yardstick
   with CUDA events, cold L2, beside the bytes/operations bound;
5. one full-width paged_decode_step through the kernel against the dense
   decode_step, logits within 1e-4 * max|logit|;
6. the serving engine at the full width of the serving bench (GPT 768
   hidden, 12 layers, 6 heads of 128, vocab 32768, 1024 positions; 16
   greedy requests, prompts 64-256, outputs 64-256, staggered arrivals,
   random weights from --seed): every request finishes, the cache audits
   clean, the kernel launched layers x k x chunks times, and the tokens
   equal the port's dense generate() except where the reference's top-2
   logit margin is under 1e-3.

The line before the last is one JSON object with each kernel's numbers;
the last line is {"ok": true, "device": {...}}. float32 matmuls run in
full float32 (TF32 off) throughout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from paddle_tpu_torch.inference.serving import EngineConfig
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_decode_attention)
    from paddle_tpu_torch.tools.serving_traffic import (bench_traffic,
                                                        drive_engine)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    build_kernels()
    max_err = check_k3(device, args.seed)
    timing = time_k3(device, args.seed)

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_heads=6, max_seq_len=1024)
    model = GPT(cfg, device=device, seed=args.seed)
    model.eval()
    check_logits(model, device, args.seed)

    ecfg = EngineConfig(block_size=BS, num_blocks=NB, max_num_seqs=N,
                        max_prefill_tokens=2048, decode_chunk_size=8,
                        kernel="ragged", prefill_chunk_threshold=128)
    # warm-up on two short requests (library init, allocator), not counted
    drive_engine(model, ecfg, bench_traffic(cfg.vocab_size, args.seed + 1,
                                            n_req=2, t_lo=16, t_hi=17),
                 device)
    specs = bench_traffic(cfg.vocab_size, args.seed)
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

    kernels = [{
        "name": "ragged_decode_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/"
                  "ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:127",
        "launches": launches, "max_abs_err": max_err, **timing}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
