"""Optimizer base (port of paddle_tpu/optimizer/optimizer.py: `get_lr`
for a float learning rate, `_multi_precision` master weights, and the
functional bridge `init_opt_state` / `apply_updates`, optimizer.py:45-49,
70-104, 343-370).

Each optimizer implements `_update(param, grad, state, lr)`. The JAX
version is pure and returns new arrays; the port updates the parameter
and its state IN PLACE (no second copy of ~3x the parameter bytes) and
returns them, so `apply_updates` keeps the JAX call shape. Under master
weights (AMP O2) a bf16/fp16 parameter's update runs on its f32
`master` copy, which is then cast back into the parameter.

A float `weight_decay` becomes `L2Decay(weight_decay)` (optimizer.py:
36-39), applied to the gradient as grad + coeff * param before the
update, in the parameter's own dtype (optimizer.py:359-360).

Not ported yet: LR schedulers, L1Decay and per-parameter regularizers,
the eager `step()`/`minimize()` surface and state dicts (the train step
drives `apply_updates`); a learning rate other than a number raises."""
from __future__ import annotations

from typing import Dict

import torch

from ..regularizer import L2Decay

__all__ = ["Optimizer"]

_LOWP = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "only a float learning rate is ported (LR schedulers come "
                "in a later slice)")
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self.regularization = L2Decay(weight_decay) \
            if isinstance(weight_decay, float) else weight_decay
        self._global_step = 0
        # AMP O2 master weights (amp.decorate turns this on)
        self._multi_precision = False

    def get_lr(self) -> float:
        return self._learning_rate

    def _lowp(self, t: torch.Tensor) -> bool:
        return self._multi_precision and t.dtype in _LOWP

    def _fresh_state(self, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Accumulators for one parameter; low-precision parameters under
        master weights also get an f32 `master` copy."""
        if self._lowp(t):
            master = t.detach().float().clone()
            st = self._init_state(master)
            st["master"] = master
            return st
        return self._init_state(t.detach())

    def _apply_one(self, p, g, state, lr):
        if "master" in state:
            self._update(state["master"], g.float(), state, lr)
            p.copy_(state["master"])
            return p, state
        return self._update(p, g, state, lr)

    def _init_state(self, param) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, param, grad, state, lr):
        raise NotImplementedError

    @torch.no_grad()
    def init_opt_state(self, flat_params: Dict[str, torch.Tensor]):
        """{name: state dict} for `apply_updates`."""
        return {k: self._fresh_state(v) for k, v in flat_params.items()}

    @torch.no_grad()
    def apply_updates(self, flat_params, flat_grads, opt_state, lr=None):
        """Update every parameter that has a gradient, in place, over
        name -> tensor dicts; returns (flat_params, opt_state)."""
        lr = self.get_lr() if lr is None else float(lr)
        for k, p in flat_params.items():
            g = flat_grads.get(k)
            if g is None:
                continue
            if self.regularization is not None:
                g = self.regularization.apply(p, g)
            self._apply_one(p, g, opt_state[k], lr)
        return flat_params, opt_state
