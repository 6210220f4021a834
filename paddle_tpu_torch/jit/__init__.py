"""TrainStep (port of paddle_tpu/jit/__init__.py `TrainStep`, :379-627).

One call runs the forward and the backward (torch autograd over the
model's trainable parameters), clips the gradients with the optimizer's
grad_clip (over the gradients in sorted-name order, as the JAX step
does), applies the optimizer's update in place (clip and update inside
an `optimizer` profiler range, which tools/train_bench.py --profile
reads), bumps
`optimizer._global_step` and returns the loss (detached, on the model's
device).

Buffers (BN running stats) are updated in place by the model's own
training-mode forward, where the JAX step threads them through the
compiled program and writes them back. The JAX step compiles all of
that into one XLA program with donated buffers. PyTorch runs eagerly, so there is nothing to compile and
donation means nothing. The jaxplan hooks, the obs gauges, the anomaly
guard and MultiStepTrainStep are not ported yet. The parameter set is
read once, at the first call.

Usage:
    step = TrainStep(model, loss_fn, optimizer)
    loss = step(x, y)   # loss_fn(model, x, y) -> scalar (or a tuple
                        # whose first element is the loss)
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._opt_state = None
        self._params = None

    def _collect(self):
        if self._params is None:
            self._params = [(k, p) for k, p in self.model.named_parameters()
                            if p.requires_grad]
        return self._params

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _arg(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        if torch.is_tensor(a):
            return a.to(self._device())
        return a

    def __call__(self, *args):
        params = self._collect()
        if self._opt_state is None:
            self._opt_state = self.optimizer.init_opt_state(
                {k: p for k, p in params})
        out = self.loss_fn(self.model, *(self._arg(a) for a in args))
        loss = out[0] if isinstance(out, (tuple, list)) else out
        grads = torch.autograd.grad(loss, [p for _, p in params],
                                    allow_unused=True)
        grads = {k: g for (k, _), g in zip(params, grads)}
        with torch.profiler.record_function("optimizer"):
            clip = self.optimizer._grad_clip
            if clip is not None:
                names = sorted(grads)
                by_name = dict(params)
                need_clip = [getattr(by_name[k], "need_clip", True)
                             for k in names]
                clipped = clip.clip_arrays([grads[k] for k in names],
                                           need_clip)
                grads = dict(zip(names, clipped))
            self.optimizer.apply_updates({k: p.detach() for k, p in params},
                                         grads, self._opt_state)
        self.optimizer._global_step += 1
        return loss.detach()
