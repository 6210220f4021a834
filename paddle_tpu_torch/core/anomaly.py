"""Anomaly guard: NaN/Inf detection on losses and gradients with policies
(port of paddle_tpu/core/anomaly.py:43-201).

The JAX guard computes one not-finite flag inside the compiled train
step and gates the update through `jnp.where`; only the counter update
reads the flag on the host. The port keeps that shape on the device:

- `tree_not_finite` reduces every floating leaf to one bool tensor on
  the leaves' device (a max-abs norm per dtype group, NaN and Inf
  propagate), with no host read;
- `jit.TrainStep(anomaly_guard=)` applies the policy from that flag on
  the device: 'zero_grads' sanitizes the gradients before clipping,
  'skip_step' copies the trained parameters, the optimizer state and
  the buffers before the step and puts them back through `torch.where`
  on the flag after it (bitwise the values before the step),
  'raise' lets the update through as the JAX step does; then one host
  read of the flag feeds `AnomalyGuard.record`, the one read the JAX
  step makes too.

Policies:
  raise      fail fast with FloatingPointError (step granularity)
  skip_step  drop the poisoned update entirely and count it
  zero_grads zero the non-finite gradient entries, apply the rest

The serving engine's row checks (`rows_not_finite`,
`any_not_finite_host`, `rows_not_finite_host`) live here too.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

__all__ = ["AnomalyGuard", "anomaly_guard", "set_anomaly_guard",
           "current_guard", "tree_not_finite", "rows_not_finite",
           "any_not_finite_host", "rows_not_finite_host",
           "sanitize_tree", "POLICIES"]

POLICIES = ("raise", "skip_step", "zero_grads")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


# ---------------------------------------------------------------- primitives
def tree_not_finite(tree) -> torch.Tensor:
    """A 0-d bool tensor, True iff ANY floating leaf of `tree` holds
    NaN/Inf (paddle_tpu/core/anomaly.py:43). Computed on the leaves'
    device (one max-abs norm launch per dtype group, no host read); a
    tree without floating leaves gives False on the CPU."""
    groups = {}
    for a in _leaves(tree):
        if a.is_floating_point() and a.numel():
            groups.setdefault((a.device, a.dtype), []).append(a.detach())
    if not groups:
        return torch.zeros((), dtype=torch.bool)
    flags = []
    for (dev, _), ts in groups.items():
        norms = torch._foreach_norm(ts, float("inf"))
        flags.append((~torch.isfinite(torch.stack(
            [n.float() for n in norms]))).any())
    out = flags[0]
    for f in flags[1:]:
        out = out | f.to(out.device)
    return out


def rows_not_finite(a: torch.Tensor) -> torch.Tensor:
    """Per-row anomaly flags for a [N, ...] batch: True where row i holds
    any NaN/Inf. Stays on the tensor's device (no host sync); 0-D and
    1-D input is one row -> [1]."""
    if a.ndim == 0:
        a = a[None]
    if a.ndim == 1:
        a = a[None]
    return ~torch.all(torch.isfinite(a).reshape(a.shape[0], -1), dim=1)


def any_not_finite_host(a) -> bool:
    """Host-side check for a value that is already host numpy (the
    engine's fetched prefill logits): True iff it holds NaN/Inf."""
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.inexact):
        return False
    return not bool(np.isfinite(a).all())


def rows_not_finite_host(a) -> "np.ndarray":
    """Host-side twin of rows_not_finite ([N, ...] numpy -> [N] bool)."""
    a = np.asarray(a)
    if a.ndim == 0:
        a = a[None]
    if a.ndim == 1:
        a = a[None]
    if not np.issubdtype(a.dtype, np.inexact):
        return np.zeros(a.shape[0], bool)
    return ~np.isfinite(a).reshape(a.shape[0], -1).all(axis=1)


def sanitize_tree(tree):
    """Replace non-finite entries with 0 in every floating leaf (the
    zero_grads policy's repair), keeping the container structure; other
    leaves pass unchanged."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_floating_point():
            return tree
        return torch.where(torch.isfinite(tree), tree,
                           torch.zeros((), dtype=tree.dtype,
                                       device=tree.device))
    if isinstance(tree, dict):
        return {k: sanitize_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [sanitize_tree(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree


# --------------------------------------------------------------------- guard
class AnomalyGuard:
    """Policy + counters for non-finite losses/gradients
    (paddle_tpu/core/anomaly.py:110). Counters are host ints:
    skipped_steps, zeroed_steps, raised, checked_steps."""

    def __init__(self, policy: str = "raise"):
        if policy not in POLICIES:
            raise ValueError(
                f"anomaly policy must be one of {POLICIES}, got {policy!r}")
        self.policy = policy
        self.skipped_steps = 0
        self.zeroed_steps = 0
        self.raised = 0
        self.checked_steps = 0

    def record(self, bad: bool, where: str = "step",
               counter: Optional[str] = None) -> bool:
        """Count one guarded check whose anomaly flag is `bad` (a host
        bool); applies the policy's counter and raises under 'raise'.
        `counter` ('skipped'|'zeroed') overrides the policy-derived
        choice. Returns bad."""
        self.checked_steps += 1
        if not bad:
            return False
        if self.policy == "raise":
            self.raised += 1
            raise FloatingPointError(
                f"anomaly guard: non-finite values detected in {where} "
                f"(policy='raise'; use 'skip_step'/'zero_grads' to ride "
                f"through)")
        if counter is None:
            counter = "zeroed" if self.policy == "zero_grads" else "skipped"
        if counter == "zeroed":
            self.zeroed_steps += 1
        else:
            self.skipped_steps += 1
        return True

    def check_loss(self, loss) -> bool:
        """Eager loss check (one host read). True -> caller should
        skip."""
        return self.record(bool(tree_not_finite(loss)), where="loss")

    def state_dict(self):
        return {"policy": self.policy, "skipped_steps": self.skipped_steps,
                "zeroed_steps": self.zeroed_steps, "raised": self.raised,
                "checked_steps": self.checked_steps}

    def __repr__(self):
        return (f"AnomalyGuard(policy={self.policy!r}, "
                f"checked={self.checked_steps}, "
                f"skipped={self.skipped_steps}, zeroed={self.zeroed_steps}, "
                f"raised={self.raised})")


# ------------------------------------------------------------- global guard
_current: Optional[AnomalyGuard] = None


def set_anomaly_guard(guard) -> Optional[AnomalyGuard]:
    """Install a process-wide guard (an AnomalyGuard, a policy string,
    or None to disable). Returns the installed guard."""
    global _current
    if isinstance(guard, str):
        guard = AnomalyGuard(guard)
    _current = guard
    return guard


def current_guard() -> Optional[AnomalyGuard]:
    return _current


@contextmanager
def anomaly_guard(policy_or_guard="raise"):
    """Scoped guard: `with anomaly_guard('skip_step') as g: train()`."""
    prev = _current
    g = set_anomaly_guard(policy_or_guard)
    try:
        yield g
    finally:
        set_anomaly_guard(prev)
