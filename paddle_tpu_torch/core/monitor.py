"""Global stat registry (port of paddle_tpu/core/monitor.py; reference:
platform/monitor.h StatRegistry:77 with STAT_ADD:130 / STAT_SUB /
STAT_RESET).

Host-side named int counters under one lock, as in the JAX module.
`device_memory_stats` reads the CUDA caching allocator's counters
(`torch.cuda.memory_stats`) where the JAX module read PJRT's
`memory_stats()`: {} for the CPU or without a GPU.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

__all__ = ["stat_add", "stat_sub", "stat_reset", "stat_get", "stat_names",
           "print_stats", "device_memory_stats"]

_lock = threading.Lock()
_stats: Dict[str, int] = {}


def stat_add(name: str, value: int = 1) -> int:
    """reference: STAT_ADD (monitor.h:130)."""
    with _lock:
        _stats[name] = _stats.get(name, 0) + int(value)
        return _stats[name]


def stat_sub(name: str, value: int = 1) -> int:
    return stat_add(name, -int(value))


def stat_reset(name: str = None):
    with _lock:
        if name is None:
            _stats.clear()
        else:
            _stats[name] = 0


def stat_get(name: str) -> int:
    with _lock:
        return _stats.get(name, 0)


def stat_names() -> List[str]:
    with _lock:
        return sorted(_stats)


def print_stats() -> str:
    """reference: StatRegistry::publish-style dump."""
    with _lock:
        rows = sorted(_stats.items())
    lines = ["-" * 44, f"{'Stat':<32}{'Value':>12}", "-" * 44]
    lines += [f"{k[:31]:<32}{v:>12}" for k, v in rows]
    lines.append("-" * 44)
    return "\n".join(lines)


def device_memory_stats(device=None) -> Dict[str, int]:
    """Live device memory counters of the CUDA caching allocator (the
    analogue of the reference's STAT_gpuN_mem_size fed by the
    allocator): torch.cuda.memory_stats(device) with its numeric
    entries as ints; {} on the CPU or without a GPU."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    ms = torch.cuda.memory_stats(device)
    return {k: int(v) for k, v in ms.items() if isinstance(v, (int, float))}
