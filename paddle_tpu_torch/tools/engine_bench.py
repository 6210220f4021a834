"""The serving engine's end-to-end numbers on one GPU, as chip_smoke.py
phase 6 drives it.

    python -m paddle_tpu_torch.tools.engine_bench [--runs N]

Builds the full-width serving model (GPT vocab 32768, hidden 768, 12
layers, 6 heads of 128, 1024 positions, random weights from seed 0, f32
with TF32 off) and the engine (block 32, 512 blocks, 8 sequences, ragged
kernel, decode chunks of 8, chunked prefill above 128 prompt tokens),
warms it up on two short requests (`serving_setup`), then sends the
bench traffic (16 greedy requests) `--runs` times. Prints one JSON line
per run: decode tokens/s (generated / (prefill + decode time),
EngineStats' definition),
TTFT mean/p50/max, wall seconds, the K3 launches and decode chunks; then
the card's name and power limit. It uses only entry points that every
slice of the port has, so the same file times an older checkout:
`PYTHONPATH=<checkout> python <this file>`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional


# the serving bench at full width: the model and the engine
# (`serving_setup`); chip_smoke.py takes K3's shapes from them
GPT_CONFIG = dict(vocab_size=32768, hidden_size=768, num_layers=12,
                  num_heads=6, max_seq_len=1024)
ENGINE_CONFIG = dict(block_size=32, num_blocks=512, max_num_seqs=8,
                     max_prefill_tokens=2048, decode_chunk_size=8,
                     kernel="ragged", prefill_chunk_threshold=128)
# K3's shapes there: rows, heads, head_dim, block size, pool blocks and
# table columns
K3_SHAPE = (ENGINE_CONFIG["max_num_seqs"], GPT_CONFIG["num_heads"],
            GPT_CONFIG["hidden_size"] // GPT_CONFIG["num_heads"],
            ENGINE_CONFIG["block_size"], ENGINE_CONFIG["num_blocks"],
            GPT_CONFIG["max_seq_len"] // ENGINE_CONFIG["block_size"])


def serving_setup(device, seed: int, **cfg_overrides):
    """(model, EngineConfig) of the serving bench at full width
    (GPT_CONFIG, ENGINE_CONFIG; cfg_overrides replace GPT_CONFIG's
    entries, as chip_smoke.py cuts the depth), the model in eval mode,
    and the engine warmed up on two short requests (library init,
    allocator). chip_smoke.py and profile_serving.py build theirs here
    too."""
    import torch
    from paddle_tpu_torch.inference.serving import EngineConfig
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.tools.serving_traffic import (bench_traffic,
                                                        drive_engine)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(**{**GPT_CONFIG, **cfg_overrides})
    model = GPT(cfg, device=device, seed=seed)
    model.eval()
    ecfg = EngineConfig(**ENGINE_CONFIG)
    drive_engine(model, ecfg, bench_traffic(cfg.vocab_size, seed + 1,
                                            n_req=2, t_lo=16, t_hi=17),
                 device)
    return model, ecfg


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("engine_bench: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_decode_attention)
    from paddle_tpu_torch.tools.serving_traffic import (bench_traffic,
                                                        drive_engine)
    device = torch.device("cuda")
    model, ecfg = serving_setup(device, args.seed)
    specs = bench_traffic(model.cfg.vocab_size, args.seed)
    for run in range(args.runs):
        ragged_decode_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, rids = drive_engine(model, ecfg, specs, device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = eng.stats.as_dict()
        ttft = np.array([eng.get_request(r).first_token_time
                         - eng.get_request(r).arrival_time for r in rids])
        print(json.dumps({
            "run": run, "decode_tokens_per_sec": d["decode_tokens_per_sec"],
            "ttft_ms": {"mean": ttft.mean() * 1e3,
                        "p50": float(np.percentile(ttft, 50)) * 1e3,
                        "max": ttft.max() * 1e3},
            "wall_s": wall, "generated_tokens": d["generated_tokens"],
            "k3_launches": ragged_decode_attention.launches,
            "decode_chunks": eng.stats.host_syncs("decode")}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
