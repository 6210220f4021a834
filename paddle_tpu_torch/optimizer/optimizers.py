"""Momentum, Adam and AdamW (port of paddle_tpu/optimizer/optimizers.py:
27-105).

Momentum (momentum_op.h):
  g = rescale_grad * g;  v = mu v + g
  p -= lr v,  or with use_nesterov  p -= lr (g + mu v)

Adam and AdamW:

Paddle's formula, which torch.optim.AdamW does not compute:
  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
  beta1_pow *= b1;  beta2_pow *= b2   (per-parameter state)
  lr_t = lr sqrt(1 - beta2_pow) / (1 - beta1_pow)
  p -= lr_t m / (sqrt(v) + eps)      (eps is not bias-corrected)
AdamW first scales p by (1 - lr coeff) (decoupled decay, every
parameter): coeff is weight_decay when that is a float and 0.01
otherwise (None or an int too), as in the reference.
All of it in place on the parameter (or its f32 master) and its state.

Constructor parameters stay in the reference's order. multi_precision
is accepted and ignored, as in the reference: master weights come from
amp.decorate(level="O2") in both packages; so is AdamW's lr_ratio,
which the reference accepts and never reads. AdamW's
apply_decay_param_fun(name) -> bool chooses the parameters that decay:
the name is the parameter's Paddle name on the eager route and its
structured name under jit.TrainStep, as in the reference. lazy_mode is
not ported yet, so only its default is accepted.
"""
from __future__ import annotations

import torch

from ..core.unported import require_defaults
from .optimizer import Optimizer

__all__ = ["Momentum", "Adam", "AdamW"]


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._rescale_grad = rescale_grad

    def _init_state(self, param):
        return {"velocity": torch.zeros_like(param)}

    def _update(self, p, g, state, lr):
        g = g.to(p.dtype) * self._rescale_grad
        v = state["velocity"].mul_(self._momentum).add_(g)
        if self._use_nesterov:
            p.sub_(lr * (g + self._momentum * v))
        else:
            p.sub_(lr * v)
        return p, state


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        require_defaults(type(self).__name__, lazy_mode=(lazy_mode, False))
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, param):
        return {
            "moment1": torch.zeros_like(param),
            "moment2": torch.zeros_like(param),
            "beta1_pow": torch.ones([], dtype=param.dtype,
                                    device=param.device),
            "beta2_pow": torch.ones([], dtype=param.dtype,
                                    device=param.device),
        }

    def _update(self, p, g, state, lr):
        g = g.to(p.dtype)
        b1, b2 = self._beta1, self._beta2
        m, v = state["moment1"], state["moment2"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        b1p = state["beta1_pow"].mul_(b1)
        b2p = state["beta2_pow"].mul_(b2)
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        p.sub_(lr_t * m / (torch.sqrt(v) + self._epsilon))
        return p, state


class AdamW(Adam):
    """Decoupled weight decay: p *= (1 - lr coeff) before the Adam step,
    for the parameters apply_decay_param_fun admits (all by default)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._coeff = weight_decay if isinstance(weight_decay, float) \
            else 0.01
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, p, g, state, lr):
        decay = True
        if self._apply_decay_param_fun is not None and \
                self._current_param_name is not None:
            decay = self._apply_decay_param_fun(self._current_param_name)
        if decay and self._coeff:
            p.mul_(1.0 - lr * self._coeff)
        return super()._update(p, g, state, lr)
