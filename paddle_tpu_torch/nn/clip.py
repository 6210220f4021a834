"""Gradient clipping by global norm (port of paddle_tpu/nn/clip.py
`ClipGradByGlobalNorm`, clip.py:72-98).

Squares are summed in f32 (bf16 gradients must not accumulate their
squares in bf16), one partial per tensor and a scalar sum over them in
list order; scale = clip / max(norm, clip) multiplies every clipped
gradient in its own dtype. Entries that are None or whose need_clip is
False pass through."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

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
