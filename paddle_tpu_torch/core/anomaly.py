"""NaN/Inf detection for the serving engine's step guard (port of the
two primitives of paddle_tpu/core/anomaly.py it uses)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["rows_not_finite", "any_not_finite_host"]


def rows_not_finite(a: torch.Tensor) -> torch.Tensor:
    """Per-row anomaly flags for a [N, ...] batch: True where row i holds
    any NaN/Inf. Stays on the tensor's device (no host sync); 0-D and
    1-D input is one row -> [1]."""
    if a.ndim == 0:
        a = a[None]
    if a.ndim == 1:
        a = a[None]
    return ~torch.isfinite(a).reshape(a.shape[0], -1).all(dim=1)


def any_not_finite_host(a) -> bool:
    """Host-side check for a value that is already host numpy (the
    engine's fetched prefill logits): True iff it holds NaN/Inf."""
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.inexact):
        return False
    return not bool(np.isfinite(a).all())
