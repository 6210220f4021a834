"""TrainStep (port of paddle_tpu/jit/__init__.py `TrainStep`, :379-627),
MultiStepTrainStep and InputSpec (:36, which paddle.static re-exports).
to_static, save, load, TracedLayer and TranslatedLayer wait for slice
10b (ROADMAP Queue 1 item 8).

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
hooks are not ported yet.

The trained parameters are those with `trainable` set and
`stop_gradient` clear (paddle_tpu/jit/__init__.py:509); the rest stay
as they are. The set is read once, at the first call; after freezing or
unfreezing a parameter, `invalidate()` makes the next call read it
again (the optimizer state of parameters that left the set is
dropped, as in the reference). The step keeps its optimizer state in
the optimizer's own accumulators (one per parameter, made on first
use), where the JAX TrainStep holds a pytree of its own: so
`optimizer.state_dict()`, `Model.save` and AutoCheckpointManager carry
the moments a TrainStep has built, and `set_state_dict` restores them
into it. `donate` is accepted and ignored: eager
PyTorch updates the parameters in place and has no buffers to donate.
The loss comes back as a Tensor; with `return_outputs=True` the call
returns (loss, outputs), outputs being loss_fn's whole result as
detached Tensors (paddle_tpu/jit/__init__.py:620), which hapi's
`train_batch` reads its predictions from.

`anomaly_guard` (a core.anomaly.AnomalyGuard) checks the loss and the
gradients for NaN/Inf on the device, one flag for the step, and applies
its policy there (core/anomaly.py): 'zero_grads' sanitizes the
gradients before clipping; 'skip_step' copies the trained parameters,
the optimizer state and the buffers before the forward and restores
them through `torch.where` on the flag after the update, so a skipped
step leaves them bitwise as they were (the copies cost one read and two
writes of that state a step, only under this policy); 'raise' applies
the update as the JAX step does. One host read of the flag per step
then feeds `guard.record` (which raises under 'raise') and the
`train_anomaly_skips_total` counter, the one read the JAX step makes.

Telemetry as in the JAX step (paddle_tpu/jit/__init__.py:589-620):
`train_step_seconds` observes the interval between consecutive calls
(launches are asynchronous, so the cadence converges on the device's
step time with no added sync; the first call only arms the clock),
`train_tokens_total` and `train_tokens_per_sec` count the batch's
tokens (the first integer argument of rank >= 2, else the first two
dims of the first rank >= 2 argument), and
`train_measured_vs_roofline` divides by a published roofline.

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

import time
from typing import Callable

import numpy as np
import torch

from ..core.anomaly import _leaves, sanitize_tree, tree_not_finite
from ..core.dtypes import convert_dtype
from ..core.tensor import box, plain, plain_dispatch

__all__ = ["InputSpec", "TrainStep", "MultiStepTrainStep"]


class InputSpec:
    """reference: python/paddle/static/input.py InputSpec (the JAX
    package's, paddle_tpu/jit/__init__.py:36): a feed's shape, dtype
    and name."""

    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = list(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, " \
               f"name={self.name})"


def _batch_tokens(args) -> int:
    """Token count of one batch from shapes only
    (paddle_tpu/jit/__init__.py:363-376)."""
    arrs = [a for a in args if torch.is_tensor(a)]
    for a in arrs:
        if a.ndim >= 2 and not a.is_floating_point() \
                and not a.is_complex() and a.dtype != torch.bool:
            return int(a.numel())
    for a in arrs:
        if a.ndim >= 2:
            return int(a.shape[0] * a.shape[1])
    return 0


def _detached(tree):
    if torch.is_tensor(tree):
        return box(plain(tree).detach())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree


def _trains(p) -> bool:
    """The reference's rule: trainable and not stop_gradient."""
    return getattr(p, "trainable", True) and p.requires_grad


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, donate: bool = True,
                 return_outputs: bool = False, anomaly_guard=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.return_outputs = return_outputs
        self._guard = anomaly_guard
        self._opt_state = None
        self._params = None
        self._prev_params = None
        self._prev_call_t = None

    def invalidate(self):
        """Drop the cached parameter set: call after flipping a
        parameter's trainable or stop_gradient, or changing the model's
        structure."""
        self._params = None

    def _collect(self):
        if self._params is None:
            old = {id(p): p for _, p in self._prev_params or ()}
            self._params = [(k, p) for k, p in self.model.named_parameters()
                            if _trains(p)]
            for i in set(old) - {id(p) for _, p in self._params}:
                self.optimizer._accumulators.pop(i, None)
            self._prev_params = self._params
        return self._params

    def _device(self) -> torch.device:
        return next(iter(self.model.parameters())).device

    def _arg(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        if torch.is_tensor(a):
            return plain(a).to(self._device())
        return a

    def _guarded_state(self, params):
        """The tensors a skipped step must leave as they were: trained
        parameters, optimizer state, buffers."""
        out = [p.detach() for _, p in params]
        out += list(_leaves(self._opt_state))
        out += [b for b in self.model.buffers() if b is not None]
        return out

    def _step(self, args):
        """One step; returns (loss, loss_fn's result, not-finite flag or
        None)."""
        params = self._collect()
        # the optimizer's own accumulators (re-read each call: its
        # set_state_dict replaces them)
        state_for = self.optimizer._state_for
        self._opt_state = {k: state_for(p) for k, p in params}
        guard = self._guard
        saved = None
        if guard is not None and guard.policy == "skip_step":
            state = self._guarded_state(params)
            saved = (state, [t.clone() for t in state])
        out = self.loss_fn(self.model, *args)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        grads = torch.autograd.grad(loss, [p for _, p in params],
                                    allow_unused=True)
        grads = {k: g for (k, _), g in zip(params, grads)}
        bad = None
        if guard is not None:
            bad = tree_not_finite([loss.detach()] + [
                g for g in grads.values() if g is not None])
            if guard.policy == "zero_grads":
                grads = {k: None if g is None else sanitize_tree(g)
                         for k, g in grads.items()}
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
            if saved is not None:
                keep = bad.to(saved[0][0].device)
                for t, old in zip(*saved):
                    t.copy_(torch.where(keep, old, t))
        self.optimizer._global_step += 1
        return loss, out, bad

    def _record_call(self, steps, args):
        """The JAX step's obs telemetry (module docstring)."""
        from .. import obs
        now = time.perf_counter()
        prev, self._prev_call_t = self._prev_call_t, now
        if prev is None:
            return
        interval = now - prev
        obs.histogram("train_step_seconds",
                      "per-step train time via inter-dispatch cadence",
                      unit="seconds").observe(interval / steps)
        tokens = _batch_tokens(args)
        if tokens and interval > 0:
            tps = tokens / interval
            obs.counter("train_tokens_total",
                        "tokens consumed by dispatched train steps",
                        unit="tokens").inc(tokens)
            obs.gauge("train_tokens_per_sec",
                      "training throughput over the last dispatch gap",
                      unit="tokens_per_second").set(tps)
            roof = obs.get_roofline("train_step")
            if roof:
                obs.gauge("train_measured_vs_roofline",
                          "measured tokens/s over the jaxcost static "
                          "roofline for train_step").set(tps / roof)

    @plain_dispatch
    def __call__(self, *args):
        args = [self._arg(a) for a in args]
        loss, out, bad = self._step(args)
        self._record_call(1, args)
        if self._guard is not None:
            bad = bool(bad)
            if bad:
                from .. import obs
                obs.counter("train_anomaly_skips_total",
                            "train steps flagged non-finite by the "
                            "anomaly guard").inc()
            self._guard.record(bad, where="train step")
        loss = box(plain(loss).detach())
        if self.return_outputs:
            return loss, _detached(out)
        return loss


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

    @plain_dispatch
    def __call__(self, *args):
        stacked = [self._arg(a) for a in args]
        for a in stacked:
            if not torch.is_tensor(a) or a.shape[:1] != (self.steps,):
                raise ValueError(
                    f"MultiStepTrainStep(steps={self.steps}) needs every "
                    f"batch arg stacked [steps, ...]; got "
                    f"{getattr(a, 'shape', type(a).__name__)}")
        losses = [plain(self._step([a[i] for a in stacked])[0]).detach()
                  for i in range(self.steps)]
        self._record_call(self.steps, stacked)
        return box(torch.stack(losses))
