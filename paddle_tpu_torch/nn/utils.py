"""nn.utils (port of paddle_tpu/nn/utils.py): weight_norm,
remove_weight_norm, spectral_norm, parameters_to_vector and
vector_to_parameters.

weight_norm replaces a layer's parameter `name` by a direction
`{name}_v` and a magnitude `{name}_g` (the norm over every axis but
`dim`, kept as size-1 axes) and recomputes name = v / ||v|| * g in a
forward pre-hook, differentiable through ||v|| as in the reference
(the JAX package holds the norm constant in v's gradient);
remove_weight_norm folds them back into one
parameter. spectral_norm moves the parameter to `{name}_orig` and adds
a SpectralNorm sublayer `{name}_sn` whose output becomes `name` before
every forward. The recomputed weight is a plain attribute of the layer,
on the autograd graph of the parameters it came from, as in the JAX
package."""
from __future__ import annotations

import math

import torch

from ..core.tensor import box

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _norm_except(w, dim):
    axes = [i for i in range(w.ndim) if i != dim]
    return w.square().sum(dim=axes, keepdim=True).sqrt()


def _direction(v, dim):
    return v * (1.0 / torch.clamp(_norm_except(v, dim), min=1e-12))


def weight_norm(layer, name="weight", dim=0):
    """w = g * v / ||v||, g and v new parameters of the layer."""
    dim = 0 if dim is None else dim
    with torch.no_grad():
        w = getattr(layer, name).detach()
        g0 = _norm_except(w, dim)
        v0 = w / torch.clamp(g0, min=1e-12)
    g = layer.create_parameter(list(g0.shape),
                               default_initializer=lambda s, d: g0)
    v = layer.create_parameter(list(v0.shape),
                               default_initializer=lambda s, d: v0)
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)
    del layer._parameters[name]
    layer._wn_dim = dim

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, _direction(v, dim) * g)
    layer._wn_hook = layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold {name}_v and {name}_g back into the parameter `name`."""
    v = layer._parameters.pop(name + "_v")
    g = layer._parameters.pop(name + "_g")
    with torch.no_grad():
        w0 = _direction(v.detach(), getattr(layer, "_wn_dim", 0)) * g
    layer.__dict__.pop(name, None)
    w = layer.create_parameter(list(v.shape),
                               default_initializer=lambda s, d: w0)
    layer.add_parameter(name, w)
    if hasattr(layer, "_wn_hook"):
        layer._wn_hook.remove()
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """name = {name}_orig / sigma, recomputed before every forward."""
    from .layer.norm import SpectralNorm
    w = getattr(layer, name)
    sn = SpectralNorm(list(w.shape), axis=0 if dim is None else dim,
                      power_iters=n_power_iterations, epsilon=eps)
    sn.to(device=w.device)
    orig = layer._parameters.pop(name)
    layer.add_parameter(name + "_orig", orig)
    layer.add_sublayer(name + "_sn", sn)

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, sn(orig))
    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and concatenated, in order."""
    return box(torch.cat([p.reshape(-1) for p in parameters], dim=0))


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of vec into the parameters (in place)."""
    offset = 0
    for p in parameters:
        n = math.prod(p.shape)
        p.set_value(vec[offset:offset + n].reshape(p.shape))
        offset += n
