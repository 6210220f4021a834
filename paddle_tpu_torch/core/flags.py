"""Global flags registry (port of paddle_tpu/core/flags.py).

Flags are plain Python values seeded from FLAGS_* environment variables,
set with `set_flags({"FLAGS_name": value})` and read with `flag(name)`.
The port defines the flags its ported modules read; the attention
routing flags and fuse_bn_act live here so that every module sees one
registry.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "flag"]

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default, help_str: str = ""):
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = value
    return value


def set_flags(flags: Dict[str, Any]) -> None:
    for k, v in flags.items():
        key = k[6:] if k.startswith("FLAGS_") else k
        if key not in _REGISTRY:
            raise ValueError(f"Unknown flag {k!r}")
        _REGISTRY[key] = v


def flag(name: str):
    return _REGISTRY[name]


# nn/functional/attention.py's flags (paddle_tpu/nn/functional/
# attention.py:24-34)
define_flag("use_flash_attention", True,
            "Use the flash-attention kernels when applicable.")
define_flag("flash_attention_min_seq", 512,
            "Below this query length the composed path is taken even when "
            "a flash kernel applies (the TPU crossover; kept so both "
            "packages route alike).")

# nn/functional/norm.py's flag (paddle_tpu/nn/functional/norm.py:25-28)
define_flag("fuse_bn_act", True,
            "Use the fused bn+(add+)relu op (residual-light backward) in "
            "models that call batch_norm_act.")
