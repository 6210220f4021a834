"""Device timing and agreement measures shared by chip_smoke.py and the
port's tools (GPU only for the timing), and K3's input recipe."""
from __future__ import annotations

__all__ = ["cold_ms", "agreement", "BF16_ULP", "HBM_BYTES_PER_S",
           "BF16_FLOPS", "bound", "card_line", "K3_MIXED_LENGTHS",
           "k3_inputs"]

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, bf16 dense tensor
# FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# one bf16 ulp relative to a value's magnitude (8 significant bits)
BF16_ULP = 2.0 ** -7


def cold_ms(fn, iters: int) -> float:
    """Mean device ms of fn() over `iters` calls, each timed with CUDA
    events after a 256 MiB write that flushes the 50 MB L2 (the callers'
    inputs arrive cold), after 3 warm-up calls."""
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


def bound(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the HBM rate and the operations over the peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# K3's mixed lengths (chip_smoke.py phases 3-4): a dead row, lengths on
# and beside block edges, and full rows
K3_MIXED_LENGTHS = (0, 1, 31, 32, 33, 300, 1023, 1024)


def k3_inputs(device, dtype, seed: int, lengths, n, h, d, bs, nb, mb):
    """K3's inputs: q [n, h, d], pools [nb, bs, h, d] ~ N(0, 1) from
    `seed`, each row's live blocks distinct pool blocks in seeded random
    order, table [n, mb] entries past them 0, and the lengths, on
    `device`."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    need = [-(-x // bs) for x in lengths]
    blocks = rng.permutation(nb)[:sum(need)]
    tables = np.zeros((n, mb), np.int32)
    at = 0
    for i, k in enumerate(need):
        tables[i, :k] = blocks[at:at + k]
        at += k
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(n, h, d, generator=g)
    kp = torch.randn(nb, bs, h, d, generator=g)
    vp = torch.randn(nb, bs, h, d, generator=g)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            torch.from_numpy(tables).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))
