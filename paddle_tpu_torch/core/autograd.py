"""Eager autograd (port of paddle_tpu/core/autograd.py): `backward`,
`grad`, `no_grad`, `enable_grad`, `set_grad_enabled` and
`is_grad_enabled`.

The JAX package records a tape of jax.vjp closures and replays it. In
the port torch's autograd graph is the tape: these functions put
Paddle's calling conventions over torch.autograd. The differences they
bridge:
- a missing output gradient is ones for any shape (torch wants one for
  a non-scalar output);
- `grad` returns Tensors, takes `no_grad_vars` (whose gradient is
  stopped for this call) and, with allow_unused, answers None for an
  input that does not require grad (torch raises for those).
"""
from __future__ import annotations

import torch

from .tensor import box, plain

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled"]


def no_grad():
    """paddle.no_grad: a context (and decorator) that records no graph."""
    return torch.no_grad()


def enable_grad():
    return torch.enable_grad()


def set_grad_enabled(mode: bool):
    return torch.set_grad_enabled(mode)


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def _ones_for(t):
    return torch.ones_like(plain(t))


def backward(tensor, grad_tensor=None, retain_graph: bool = False):
    """Accumulate d(tensor)/d(leaf) into each leaf's .grad."""
    g = _ones_for(tensor) if grad_tensor is None else plain(grad_tensor)
    torch.autograd.backward(plain(tensor), g, retain_graph=retain_graph)


def _as_list(x):
    if x is None:
        return None
    return list(x) if isinstance(x, (list, tuple)) else [x]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph: bool = False, only_inputs: bool = True,
         allow_unused: bool = False, no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    as a list of Tensors (None for an unused input under allow_unused),
    without touching any .grad. only_inputs is accepted and ignored, as
    in the JAX package."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    grad_outputs = _as_list(grad_outputs) or [None] * len(outputs)
    grad_outputs = [_ones_for(o) if g is None else plain(g)
                    for o, g in zip(outputs, grad_outputs)]
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    if len(live) < len(inputs) and not allow_unused:
        raise RuntimeError(
            "One of the differentiated Tensors does not require grad "
            "(stop_gradient is True). Set allow_unused=True if this is "
            "desired.")
    handles = [v.register_hook(torch.zeros_like)
               for v in (_as_list(no_grad_vars) or [])
               if v.requires_grad]
    try:
        got = torch.autograd.grad(
            [plain(o) for o in outputs], [inputs[i] for i in live],
            grad_outputs, retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=allow_unused) \
            if live else []
    finally:
        for h in handles:
            h.remove()
    out = [None] * len(inputs)
    for i, g in zip(live, got):
        out[i] = box(g)
    return out
