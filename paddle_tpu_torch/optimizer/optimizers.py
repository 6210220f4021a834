"""The optimizers (port of paddle_tpu/optimizer/optimizers.py): SGD,
Momentum, Adam, AdamW, Adamax, Adadelta, Adagrad, RMSProp, Lamb and
Lars (LarsMomentum). Each is the JAX package's formula, computed in
place on the parameter (or its f32 master) and its state; torch.optim
computes other formulas and is not used.

SGD:  p -= lr g

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

Adamax:  m = b1 m + (1 - b1) g;  u = max(b2 u, |g|);  b1p *= b1
         p -= lr / (1 - b1p) * m / (u + eps)
Adadelta:  Eg = rho Eg + (1 - rho) g^2
           d = -sqrt(Ed + eps) / sqrt(Eg + eps) g
           Ed = rho Ed + (1 - rho) d^2;  p += lr d
Adagrad:  G += g^2;  p -= lr g / (sqrt(G) + eps)   (G starts at
          initial_accumulator_value)
RMSProp:  ms = rho ms + (1 - rho) g^2; centered: mg = rho mg + (1 - rho) g,
          den = sqrt(ms - mg^2 + eps), else den = sqrt(ms + eps);
          mom = momentum mom + lr g / den;  p -= mom
Lamb:  Adam's moments and bias corrections, r = m^ / (sqrt(v^) + eps) +
       wd p, trust = ||p|| / ||r|| (1 where either norm is 0),
       p -= lr trust r; wd is lamb_weight_decay, 0 for a parameter that
       exclude_from_weight_decay_fn(param) admits
Lars:  local_lr = lr coeff ||p|| / (||g|| + wd ||p|| + eps) (lr where
       either norm is 0);  v = momentum v + local_lr (g + wd p);  p -= v;
       wd is lars_weight_decay, 0 for a parameter whose name contains an
       entry of exclude_from_weight_decay
The JAX package accepts Lamb's exclude_from_weight_decay_fn and Lars's
exclude_from_weight_decay without reading them; the port applies them
as the reference does (a call that leaves them None computes the same
in both packages).
"""
from __future__ import annotations

import torch

from ..core.unported import require_defaults
from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adadelta",
           "Adagrad", "RMSProp", "Lamb", "Lars", "LarsMomentum"]


def _scalar_one(param):
    return torch.ones([], dtype=param.dtype, device=param.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, p, g, state, lr):
        p.sub_(lr * g.to(p.dtype))
        return p, state


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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, param):
        return {"moment": torch.zeros_like(param),
                "inf_norm": torch.zeros_like(param),
                "beta1_pow": _scalar_one(param)}

    def _update(self, p, g, state, lr):
        g = g.to(p.dtype)
        m = state["moment"].mul_(self._beta1).add_(g, alpha=1 - self._beta1)
        u = state["inf_norm"]
        torch.maximum(u * self._beta2, g.abs(), out=u)
        b1p = state["beta1_pow"].mul_(self._beta1)
        p.sub_((lr / (1 - b1p)) * m / (u + self._epsilon))
        return p, state


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon

    def _init_state(self, param):
        return {"avg_squared_grad": torch.zeros_like(param),
                "avg_squared_update": torch.zeros_like(param)}

    def _update(self, p, g, state, lr):
        g = g.to(p.dtype)
        rho, eps = self._rho, self._epsilon
        asg = state["avg_squared_grad"].mul_(rho).addcmul_(g, g,
                                                           value=1 - rho)
        asu = state["avg_squared_update"]
        update = -torch.sqrt(asu + eps) / torch.sqrt(asg + eps) * g
        asu.mul_(rho).addcmul_(update, update, value=1 - rho)
        p.add_(lr * update)
        return p, state


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _init_state(self, param):
        return {"moment": torch.full_like(param, self._init_value)}

    def _update(self, p, g, state, lr):
        g = g.to(p.dtype)
        m = state["moment"].addcmul_(g, g)
        p.sub_(lr * g / (torch.sqrt(m) + self._epsilon))
        return p, state


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, param):
        st = {"mean_square": torch.zeros_like(param),
              "momentum": torch.zeros_like(param)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(param)
        return st

    def _update(self, p, g, state, lr):
        g = g.to(p.dtype)
        rho, eps = self._rho, self._epsilon
        ms = state["mean_square"].mul_(rho).addcmul_(g, g, value=1 - rho)
        if self._centered:
            mg = state["mean_grad"].mul_(rho).add_(g, alpha=1 - rho)
            denom = torch.sqrt(ms - mg * mg + eps)
        else:
            denom = torch.sqrt(ms + eps)
        mom = state["momentum"].mul_(self._momentum).add_(lr * g / denom)
        p.sub_(mom)
        return p, state


def _norm(t):
    return t.square().sum().sqrt()


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, param):
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "beta1_pow": _scalar_one(param),
                "beta2_pow": _scalar_one(param)}

    def _update(self, p, g, state, lr):
        g = g.to(p.dtype)
        b1, b2 = self._beta1, self._beta2
        wd = self._lamb_weight_decay
        if self._exclude_fn is not None and self._current_param is not None \
                and self._exclude_fn(self._current_param):
            wd = 0.0
        m = state["moment1"].mul_(b1).add_(g, alpha=1 - b1)
        v = state["moment2"].mul_(b2).addcmul_(g, g, value=1 - b2)
        b1p = state["beta1_pow"].mul_(b1)
        b2p = state["beta2_pow"].mul_(b2)
        r = (m / (1 - b1p)) / (torch.sqrt(v / (1 - b2p)) + self._epsilon) \
            + wd * p
        w_norm, r_norm = _norm(p), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.sub_(lr * trust * r)
        return p, state


class Lars(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._exclude = list(exclude_from_weight_decay or [])
        self._lars_epsilon = epsilon

    def _init_state(self, param):
        return {"velocity": torch.zeros_like(param)}

    def _update(self, p, g, state, lr):
        g = g.to(p.dtype)
        wd = self._lars_weight_decay
        name = self._current_param_name or ""
        if any(e in name for e in self._exclude):
            wd = 0.0
        p_norm, g_norm = _norm(p), _norm(g)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * p_norm
            / (g_norm + wd * p_norm + self._lars_epsilon),
            torch.full_like(p_norm, lr))
        v = state["velocity"].mul_(self._momentum).add_(
            local_lr * (g + wd * p))
        p.sub_(v)
        return p, state


LarsMomentum = Lars
