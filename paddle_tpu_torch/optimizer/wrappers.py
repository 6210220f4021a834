"""Wrapper optimizers (port of paddle_tpu/optimizer/wrappers.py:30-204):
ExponentialMovingAverage, ModelAverage and LookaheadOptimizer
(`Lookahead`).

Each keeps float32 shadow state per parameter, keyed by the parameter's
name, on the parameter's own device, and updates it with the JAX
package's formulas:
- EMA: shadow = decay * shadow + (1 - decay) * param after each step;
  with thres_steps the decay is min(decay, (1 + t) / (10 + t)) at step t;
- ModelAverage: sum_1 accumulates the parameters; once num_accumulates
  reaches min_average_window and min(max_average_window, num_updates *
  average_window_rate), sum_3 = sum_1 + sum_2 and the counters rotate
  into old_num_accumulates; the average is (sum_1 + sum_2 + sum_3) /
  (num_accumulates + old_num_accumulates);
- Lookahead: after every k inner steps, slow += alpha * (fast - slow)
  and fast = slow.
`apply()` (a context manager) copies the shadow into the parameters,
cast to their dtype, and `restore()` copies the saved values back; both
write in place, so the parameters stay the same tensors (an optimizer
or a jit.TrainStep holding them sees the swap). The JAX package swaps
the arrays instead."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from ..core.tensor import box, plain

__all__ = ["ExponentialMovingAverage", "ModelAverage", "LookaheadOptimizer",
           "Lookahead"]


def _named_params(parameters) -> Dict[str, torch.Tensor]:
    return {p.name: p for p in parameters}


def _f32(p) -> torch.Tensor:
    return plain(p).detach().float()


class _Swap:
    """apply() / restore() over a name -> parameter dict."""

    _params: Dict[str, torch.Tensor]
    _backup: Optional[Dict[str, torch.Tensor]] = None

    def _shadow_values(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @contextmanager
    def apply(self, executor=None, need_restore=True):
        """Copy the shadow weights in (evaluation); restore on exit unless
        need_restore is False."""
        with torch.no_grad():
            self._backup = {k: plain(p).detach().clone()
                            for k, p in self._params.items()}
            for k, v in self._shadow_values().items():
                plain(self._params[k]).copy_(v)
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is not None:
            for k, p in self._params.items():
                plain(p).copy_(self._backup[k])
            self._backup = None


class ExponentialMovingAverage(_Swap):
    def __init__(self, decay: float = 0.999, thres_steps=None, name=None,
                 parameters: Optional[List[torch.Tensor]] = None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        self._decay = float(decay)
        self._use_thres = thres_steps is not None
        self._params = _named_params(parameters)
        self._shadow = {k: _f32(p).clone() for k, p in self._params.items()}
        self._step = 0

    @torch.no_grad()
    def update(self):
        """Call after each optimizer step."""
        self._step += 1
        d = min(self._decay, (1 + self._step) / (10 + self._step)) \
            if self._use_thres else self._decay
        for k, p in self._params.items():
            self._shadow[k].mul_(d).add_(_f32(p) * (1.0 - d))

    def _shadow_values(self):
        return self._shadow

    def state_dict(self):
        return {f"{k}_ema": box(v) for k, v in self._shadow.items()} | {
            "ema_step": self._step}

    @torch.no_grad()
    def set_state_dict(self, state):
        self._step = int(state.get("ema_step", 0))
        for k, t in self._shadow.items():
            v = state.get(f"{k}_ema")
            if v is not None:
                t.copy_(plain(v) if torch.is_tensor(v) else
                        torch.as_tensor(v))


class ModelAverage(_Swap):
    def __init__(self, average_window_rate: float = 0.15,
                 parameters: Optional[List[torch.Tensor]] = None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000000, name=None):
        if parameters is None:
            raise ValueError("parameters is required")
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._params = _named_params(parameters)

        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in self._params.items()}
        self._sum1, self._sum2, self._sum3 = zeros(), zeros(), zeros()
        self._num_accumulates = 0
        self._old_num_accumulates = 0
        self._num_updates = 0

    @torch.no_grad()
    def update(self):
        """Accumulate the current parameters (call after each step)."""
        self._num_updates += 1
        self._num_accumulates += 1
        for k, p in self._params.items():
            self._sum1[k].add_(_f32(p))
        if (self._num_accumulates >= self._min_w
                and self._num_accumulates >= min(
                    self._max_w, self._num_updates * self._rate)):
            for k in self._params:
                self._sum3[k] = self._sum1[k] + self._sum2[k]
                self._sum1[k].zero_()
                self._sum2[k].zero_()
            self._old_num_accumulates = self._num_accumulates
            self._num_accumulates = 0

    def _shadow_values(self):
        n = max(self._num_accumulates + self._old_num_accumulates, 1)
        return {k: (self._sum1[k] + self._sum2[k] + self._sum3[k]) / n
                for k in self._params}

    def step(self):
        self.update()


class LookaheadOptimizer:
    """k fast steps of the inner optimizer, then slow += alpha * (fast -
    slow) and fast = slow (Zhang et al. 2019). Other attributes are the
    inner optimizer's."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        if inner_optimizer is None:
            raise ValueError("inner optimizer cannot be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be within [0, 1]")
        if k <= 0:
            raise ValueError("k must be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._steps = 0
        self._params = _named_params(inner_optimizer._parameter_list or [])
        self._slow = {kk: _f32(p).clone() for kk, p in self._params.items()}

    def __getattr__(self, name):
        return getattr(self.inner_optimizer, name)

    def step(self):
        self.inner_optimizer.step()
        self._steps += 1
        if self._steps % self.k == 0:
            with torch.no_grad():
                for kk, p in self._params.items():
                    slow = self._slow[kk]
                    slow.add_(self.alpha * (_f32(p) - slow))
                    plain(p).copy_(slow)

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._params.values()]


Lookahead = LookaheadOptimizer
