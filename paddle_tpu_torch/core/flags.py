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

from .unported import require_defaults

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default, help_str: str = "", public: bool = True):
    """Register flag `name` (FLAGS_name in the environment overrides
    `default`). Every flag is public: the reference's public=False marks
    a flag in a set nothing reads, so only the default is accepted."""
    require_defaults("define_flag", public=(public, True))
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


def get_flags(flags):
    """{name: value} for one flag name or a list of them."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        key = k[6:] if k.startswith("FLAGS_") else k
        if key not in _REGISTRY:
            raise ValueError(f"Unknown flag {k!r}")
        out[k] = _REGISTRY[key]
    return out


def flag(name: str):
    return _REGISTRY[name]


# the op boundary's NaN/Inf check (core/dispatch.py), off by default as
# in paddle_tpu/core/flags.py
define_flag("check_nan_inf", False,
            "Raise FloatingPointError when an op called from user code "
            "returns NaN/Inf.")

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
