"""Gradient clipping by global norm (port of paddle_tpu/nn/clip.py
`ClipGradByGlobalNorm`, clip.py:72-98).

Squares are summed in f32 (bf16 gradients must not accumulate their
squares in bf16), one partial per tensor and a scalar sum over them in
list order; scale = clip / max(norm, clip) multiplies every clipped
gradient in its own dtype. Entries that are None or whose need_clip is
False pass through. `clip_arrays` is jit.TrainStep's form over a list of
gradients; calling the clip on (param, grad) pairs is the eager
optimizer's (a parameter's need_clip False leaves its gradient alone).
group_name and auto_skip_clip are accepted and ignored, as in the
reference."""
from __future__ import annotations

import torch

from ..core.tensor import box, plain

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def clip_arrays(self, grads, need_clip=None):
        if need_clip is None:
            need_clip = [True] * len(grads)
        sq = [g.float().square().sum() for g, nc in zip(grads, need_clip)
              if g is not None and nc]
        if not sq:
            return list(grads)
        norm = torch.sqrt(sum(sq))
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [g if (g is None or not nc) else g * scale.to(g.dtype)
                for g, nc in zip(grads, need_clip)]

    @torch.no_grad()
    def __call__(self, params_grads):
        grads = [None if g is None or not getattr(p, "need_clip", True)
                 else plain(g) for p, g in params_grads]
        clipped = self.clip_arrays(grads)
        return [(p, g if c is None else box(c))
                for (p, g), c in zip(params_grads, clipped)]
