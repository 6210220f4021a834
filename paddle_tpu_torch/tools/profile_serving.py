"""Where the serving engine's time goes on the GPU.

    python -m paddle_tpu_torch.tools.profile_serving

Run from the root of a checkout on a machine with a GPU. Builds the
full-width model and engine that chip_smoke.py drives (the serving
bench geometry, ragged kernel, decode_chunk_size 8, chunked prefill
above 128 prompt tokens, random weights from seed 0), sends the bench
traffic, and records engine steps 20..29 (past the arrival ramp) with
torch.profiler.
Prints the window's wall time, the device's busy time (kernels and
copies, one stream) and idle share, the number of device activities,
and the kernels that take the most device time. The profiler's own
host cost lengthens the window, so its idle share is an upper bound.
"""
from __future__ import annotations

import subprocess
import time

SEED = 0
STEPS = (20, 30)                 # profiled engine steps, end exclusive


def main() -> int:
    start, stop = STEPS
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .engine_bench import serving_setup
    from .serving_traffic import bench_traffic, drive_engine

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    model, ecfg = serving_setup(device, SEED)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def before_step(i: int) -> None:
        if i == start:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif i == stop:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()

    drive_engine(model, ecfg, bench_traffic(model.cfg.vocab_size, SEED),
                 device, before_step=before_step)
    if "wall" not in window:
        raise RuntimeError(f"the run had fewer than {stop} steps")

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    k3 = sum(e.self_device_time_total for e in rows
             if "ragged_split_kernel" in e.key
             or "ragged_paged_attention" in e.key)
    d2h = sum(e.count for e in rows if "DtoH" in e.key)
    wall_us = window["wall"] * 1e6
    print(f"[profile] card: {card}")
    print(f"[profile] engine steps {start}..{stop - 1}: wall "
          f"{window['wall']:.4f} s, device busy {busy_us / 1e6:.4f} s, "
          f"idle share {1 - busy_us / wall_us:.3f}")
    # one device-to-host copy per decode chunk and per prefill
    print(f"[profile] device activities {launches} ({d2h} device-to-host "
          f"copies); K3 {k3 / 1e6:.4f} s = {k3 / max(busy_us, 1):.3f} of "
          f"busy")
    print("[profile] top device time (s, share of busy, count, name):")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e6:.4f}  "
              f"{e.self_device_time_total / max(busy_us, 1):.3f}  "
              f"{e.count:6d}  {e.key[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
