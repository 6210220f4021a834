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
that into one XLA program with donated buffers. PyTorch runs eagerly, so
there is nothing to compile and donation means nothing. The jaxplan
hooks, the obs gauges and the anomaly guard are not ported yet.

The trained parameters are those with `trainable` set and
`stop_gradient` clear (paddle_tpu/jit/__init__.py:509); the rest stay
as they are. The set is read once, at the first call; after freezing or
unfreezing a parameter, `invalidate()` makes the next call read it
again (the optimizer state of parameters that left the set is
dropped, as in the reference). `donate` is accepted and ignored: eager
PyTorch updates the parameters in place and has no buffers to donate.
return_outputs and anomaly_guard are not ported yet (only their
defaults are accepted). The loss comes back as a Tensor.

MultiStepTrainStep (port of :630-691) runs K such steps per call over
batches stacked [K, ...] and returns the [K] losses. The JAX class scans
the K steps inside one compiled program; here they are a plain loop of
TrainStep's body (a CUDA graph of the loop is not ported yet).

Usage:
    step = TrainStep(model, loss_fn, optimizer)
    loss = step(x, y)   # loss_fn(model, x, y) -> scalar (or a tuple
                        # whose first element is the loss)
    multi = MultiStepTrainStep(model, loss_fn, optimizer, steps=K)
    losses = multi(xs, ys)   # xs, ys stacked [K, ...] -> [K] losses
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.tensor import box, plain
from ..core.unported import require_defaults

__all__ = ["TrainStep", "MultiStepTrainStep"]


def _trains(p) -> bool:
    """The reference's rule: trainable and not stop_gradient."""
    return getattr(p, "trainable", True) and p.requires_grad


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, donate: bool = True,
                 return_outputs: bool = False, anomaly_guard=None):
        require_defaults("TrainStep", return_outputs=(return_outputs, False),
                         anomaly_guard=(anomaly_guard, None))
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._opt_state = None
        self._params = None

    def invalidate(self):
        """Drop the cached parameter set: call after flipping a
        parameter's trainable or stop_gradient, or changing the model's
        structure."""
        self._params = None

    def _collect(self):
        if self._params is None:
            self._params = [(k, p) for k, p in self.model.named_parameters()
                            if _trains(p)]
            if self._opt_state is not None:
                names = {k for k, _ in self._params}
                self._opt_state = {k: st for k, st in self._opt_state.items()
                                   if k in names}
        return self._params

    def _device(self) -> torch.device:
        return next(iter(self.model.parameters())).device

    def _arg(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        if torch.is_tensor(a):
            return plain(a).to(self._device())
        return a

    def __call__(self, *args):
        params = self._collect()
        if self._opt_state is None:
            self._opt_state = self.optimizer.init_opt_state(
                {k: p for k, p in params})
        missing = {k: p for k, p in params if k not in self._opt_state}
        if missing:
            self._opt_state.update(self.optimizer.init_opt_state(missing))
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
        return box(plain(loss).detach())


class MultiStepTrainStep(TrainStep):
    """K full optimizer steps per call: step i trains on the i-th slice of
    every argument, each stacked [K, ...]. The result equals K TrainStep
    calls (losses, parameters, optimizer state, `_global_step`).
    `donate` is accepted and ignored: eager PyTorch updates the
    parameters in place and has no buffers to donate."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 steps: int, donate: bool = True):
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        super().__init__(model, loss_fn, optimizer)
        self.steps = int(steps)

    def __call__(self, *args):
        stacked = [self._arg(a) for a in args]
        for a in stacked:
            if not torch.is_tensor(a) or a.shape[:1] != (self.steps,):
                raise ValueError(
                    f"MultiStepTrainStep(steps={self.steps}) needs every "
                    f"batch arg stacked [steps, ...]; got "
                    f"{getattr(a, 'shape', type(a).__name__)}")
        one = super().__call__
        return box(torch.stack([plain(one(*(a[i] for a in stacked)))
                                for i in range(self.steps)]))
