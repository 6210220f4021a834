"""Checkpoint integrity manifests (part of paddle_tpu/incubate/checkpoint.py).

Port of the reference's sha256 manifest: `_array_manifest` hashes every
array leaf of a host-side state tree, keyed by its JSON path, and
`CHECKSUM_FILE` names the file a snapshot's manifest is written to. The
serving model registry (inference/serving/deploy.py) derives revision
ids from it, so the same bytes give the same digests, and the same
revision id, in both packages. `_to_host` fetches torch tensors to
numpy (`.detach().cpu().numpy()`), keeping container structure.

Not ported yet (ROADMAP Queue 1 item 6): AutoCheckpointManager,
train_epoch_range, register and the sharded save/load.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = ["CHECKSUM_FILE"]

CHECKSUM_FILE = "checksums.json"


def _to_host(obj):
    """Recursively fetch every tensor to host numpy, preserving container
    structure."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_host(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _array_manifest(state, prefix="$"):
    """sha256 per array leaf of a (host-side) state tree, keyed by JSON
    path. Hashes contiguous raw bytes, so the digest is layout-
    independent."""
    out = {}
    if isinstance(state, np.ndarray):
        out[prefix] = hashlib.sha256(
            np.ascontiguousarray(state).tobytes()).hexdigest()
    elif isinstance(state, dict):
        for k in sorted(state):
            out.update(_array_manifest(state[k], f"{prefix}.{k}"))
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            out.update(_array_manifest(v, f"{prefix}[{i}]"))
    return out
