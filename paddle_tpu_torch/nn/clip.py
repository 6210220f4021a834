"""Gradient clipping (port of paddle_tpu/nn/clip.py): ClipGradByValue,
ClipGradByNorm, ClipGradByGlobalNorm, their fluid aliases and
clip_grad_norm_.

Each clip has two forms: `clip_arrays` over a list of gradients
(jit.TrainStep's), and a call on (param, grad) pairs (the eager
optimizer's). Entries that are None or whose need_clip is False pass
through, in both forms (ClipGradByValue and ClipGradByNorm read
need_clip on the eager route too, where the JAX package clips every
gradient it is handed: the port applies the rule the global-norm clip
and the reference follow).

ClipGradByGlobalNorm sums squares in f32 (bf16 gradients must not
accumulate their squares in bf16), one partial per tensor and a scalar
sum over them in list order; scale = clip / max(norm, clip) multiplies
every clipped gradient in its own dtype. ClipGradByNorm scales each
gradient by min(clip / max(||g||, 1e-12), 1) on its own; ClipGradByValue
clamps to [min, max] (min defaults to -max). group_name and
auto_skip_clip are accepted and ignored, as in the reference.

clip_grad_norm_ scales the `.grad` of the given parameters in place by
min(max_norm / max(total, 1e-6), 1), total being the p-norm over all of
them (the largest |g| for norm_type inf), and returns total."""
from __future__ import annotations

import torch

from ..core.tensor import box, plain

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm",
           "clip_grad_norm_"]


class ClipGradBase:
    def __call__(self, params_grads):
        grads = [None if g is None or not getattr(p, "need_clip", True)
                 else plain(g) for p, g in params_grads]
        with torch.no_grad():
            clipped = self.clip_arrays(grads)
        return [(p, g if c is None else box(c))
                for (p, g), c in zip(params_grads, clipped)]

    def clip_arrays(self, grads):
        """The clipped gradients (None entries pass through)."""
        raise NotImplementedError


def _need(grads, need_clip):
    return [True] * len(grads) if need_clip is None else need_clip


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def clip_arrays(self, grads, need_clip=None):
        return [g if (g is None or not nc) else g.clamp(self.min, self.max)
                for g, nc in zip(grads, _need(grads, need_clip))]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def clip_arrays(self, grads, need_clip=None):
        out = []
        for g, nc in zip(grads, _need(grads, need_clip)):
            if g is None or not nc:
                out.append(g)
                continue
            n = g.square().sum().sqrt()
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            out.append(g * scale)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def clip_arrays(self, grads, need_clip=None):
        need_clip = _need(grads, need_clip)
        sq = [g.float().square().sum() for g, nc in zip(grads, need_clip)
              if g is not None and nc]
        if not sq:
            return list(grads)
        norm = torch.sqrt(sum(sq))
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [g if (g is None or not nc) else g * scale.to(g.dtype)
                for g, nc in zip(grads, need_clip)]


# legacy fluid aliases
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients in place so their total p-norm is
    at most max_norm; returns the total before scaling.
    error_if_nonfinite is accepted and ignored, as in the JAX package."""
    if torch.is_tensor(parameters):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [plain(p.grad) for p in parameters if p.grad is not None]
    if not grads:
        return box(torch.zeros([]))
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = sum(g.abs().pow(norm_type).sum() for g in grads) \
            .pow(1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return box(total)
