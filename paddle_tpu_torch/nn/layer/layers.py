"""Layer, the base of every port module (port of paddle_tpu/nn/layer/
layers.py), `load_jax_state`, which loads the JAX package's state
into a port module, and `load_jax_scope`, which fills a static Scope
from the JAX package's.

`Layer` is a torch.nn.Module, so torch's module machinery (registration,
`to`, train/eval, autograd over parameters) does the work, with Paddle's
surface on top:
- `create_parameter(shape, attr, dtype, is_bias, default_initializer)`
  (in static mode: a static parameter Variable with its init op in the
  startup program, and `register_buffer` a persistable Variable) draws
  the initial value (attr.initializer, else the default: Constant
  0 for a bias, XavierNormal otherwise) on the CPU from paddle.seed's
  generator, moves it to the default device when set_device chose one,
  and makes an EagerParamBase with Paddle's unique name, trainable,
  learning-rate multiplier, regularizer and need_clip (ParamAttr);
- `parameters()` is a list (torch's is a generator),
  `named_parameters(prefix, include_sublayers)`, `sublayers`,
  `named_sublayers`, `add_sublayer`, `add_parameter`, `full_name`,
  `clear_gradients`;
- forward pre- and post-hooks with Paddle's signatures, removed through
  `HookRemoveHelper`;
- `state_dict()` (parameters and persistable buffers by structured
  name, the JAX package's names) and `set_state_dict`;
- `to(device=, dtype=)` with Paddle's keywords (a torch dtype or device
  as the first argument still works).

`Layer.__call__` is the eager boundary (core/dispatch.py): at the
outermost call, when handed Tensors, it turns them into plain
torch.Tensors, runs the module, and returns Tensors; nested calls, and
calls with plain torch.Tensors (the train steps', the serving
engine's), run the module as torch would. So forward bodies, and the
kernels they reach, see plain tensors. The outermost call runs its body
under plain dispatch either way (core/dispatch.py `inside`), so the
bodies' operations on parameters call no `__torch_function__`.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from ...core import place as _place
from ...core.dispatch import _State, has_tensor, inside, outermost
from ...core.dtypes import convert_dtype, get_default_dtype
from ...core.tensor import EagerParamBase, box, plain
from .base import ParamAttr

__all__ = ["Layer", "HookRemoveHelper", "load_jax_state", "gather_jax_state",
           "load_jax_scope"]

_layer_name_counters: Dict[str, int] = collections.defaultdict(int)


def _static_mode() -> bool:
    from ...static import mode
    return mode._static_mode


class HookRemoveHelper:
    """Handle of a forward hook: remove() unregisters it."""

    def __init__(self, hooks, idx):
        self._hooks = hooks
        self._idx = idx

    def remove(self):
        self._hooks.pop(self._idx, None)


def _param_attr(attr) -> ParamAttr:
    from .. import initializer as I
    if isinstance(attr, ParamAttr):
        return attr
    if isinstance(attr, str):
        return ParamAttr(name=attr)
    if isinstance(attr, I.Initializer):
        return ParamAttr(initializer=attr)
    return ParamAttr()


class Layer(nn.Module):
    def __init__(self, name_scope: str = None, dtype=None):
        super().__init__()
        cls = type(self).__name__.lower()
        _layer_name_counters[cls] += 1
        self._full_name = name_scope or \
            f"{cls}_{_layer_name_counters[cls] - 1}"
        self._dtype = convert_dtype(dtype) or get_default_dtype()

    # ------------------------------------------------------------ call
    def __call__(self, *inputs, **kwargs):
        if _State.depth:
            return nn.Module.__call__(self, *inputs, **kwargs)
        if has_tensor(inputs, kwargs):
            return outermost(nn.Module.__call__, self, *inputs, **kwargs)
        return inside(nn.Module.__call__, self, *inputs, **kwargs)

    # -------------------------------------------------------- creation
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from .. import initializer as I
        attr = _param_attr(attr)
        init = attr.initializer or default_initializer or \
            (I.Constant(0.0) if is_bias else I.XavierNormal())
        if _static_mode():
            # a Variable of the main program, its init op in startup
            # (paddle_tpu/nn/layer/layers.py:69-78)
            from ...static.program import create_parameter
            return create_parameter(
                shape, convert_dtype(dtype) or self._dtype, name=attr.name,
                initializer=init, trainable=attr.trainable,
                regularizer=attr.regularizer,
                learning_rate=attr.learning_rate, need_clip=attr.need_clip,
                do_model_average=attr.do_model_average)
        value = init([int(s) for s in shape],
                     convert_dtype(dtype) or self._dtype)
        value = value.to(_place.resolve_device(None))
        return EagerParamBase(
            value, requires_grad=bool(attr.trainable), name=attr.name,
            trainable=attr.trainable, learning_rate=attr.learning_rate,
            regularizer=attr.regularizer, need_clip=attr.need_clip,
            do_model_average=attr.do_model_average)

    def register_buffer(self, name, tensor, persistable=True, **kwargs):
        """A buffer (persistable ones enter state_dict). In static mode a
        persistable buffer becomes a persistable Variable with its value
        set by the startup program (paddle_tpu/nn/layer/layers.py:96-106).
        torch's keyword `persistent` is accepted for `persistable`."""
        persistable = kwargs.pop("persistent", persistable)
        if _static_mode() and tensor is not None and persistable:
            from ...static.nn import persistable_buffer
            from ...static.program import Variable
            if not isinstance(tensor, Variable):
                tensor = persistable_buffer(
                    plain(tensor), prefix=f"{self._full_name}.{name}")
        super().register_buffer(name, tensor, persistable)
        return tensor

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    # ------------------------------------------------------- iteration
    def parameters(self, include_sublayers=True, **kwargs) -> List:
        recurse = kwargs.pop("recurse", include_sublayers)
        return list(super().parameters(recurse))

    def named_parameters(self, prefix="", include_sublayers=True,
                         include_self=True, **kwargs
                         ) -> Iterator[Tuple[str, EagerParamBase]]:
        recurse = kwargs.pop("recurse", include_sublayers)
        return super().named_parameters(prefix, recurse, **kwargs)

    def sublayers(self, include_self=False) -> List["Layer"]:
        return [m for m in self.modules() if include_self or m is not self]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if include_self or m is not self:
                yield name, m

    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    # ------------------------------------------------------------ hooks
    def register_forward_pre_hook(self, hook):
        """hook(layer, inputs) -> None or new inputs, before forward."""
        h = super().register_forward_pre_hook(hook)
        return HookRemoveHelper(self._forward_pre_hooks, h.id)

    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, output) -> None or a new output."""
        h = super().register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, h.id)

    # -------------------------------------------------------- state i/o
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, **kwargs):
        """{structured name: Tensor} of the parameters and persistable
        buffers (the parameters themselves, not copies). torch's keyword
        form (prefix=, keep_vars=) gets torch's state_dict."""
        if "prefix" in kwargs or "keep_vars" in kwargs:
            return super().state_dict(destination=destination, **kwargs)
        dest = destination if destination is not None \
            else collections.OrderedDict()
        prefix = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(prefix, include_sublayers):
            dest[name] = p
        for lname, layer in self.named_modules(prefix=prefix):
            if not include_sublayers and layer is not self:
                continue
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistent_buffers_set:
                    continue
                dest[f"{lname}.{bname}" if lname else bname] = box(b)
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values (Tensors, torch tensors or numpy arrays) into the
        parameters and buffers of the same names, each keeping its own
        dtype and device. Returns (missing, unexpected) names."""
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        for k, v in state_dict.items():
            if k not in own:
                continue
            src = plain(v) if torch.is_tensor(v) else torch.as_tensor(
                np.asarray(v))
            tgt = plain(own[k])
            if tuple(src.shape) != tuple(tgt.shape):
                raise ValueError(f"state_dict shape mismatch for {k}: "
                                 f"{tuple(src.shape)} vs {tuple(tgt.shape)}")
            tgt.copy_(src.to(tgt.device))
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # ---------------------------------------------------- dtype/device
    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        if isinstance(device, torch.dtype):     # torch's to(dtype)
            device, dtype = None, device
        kw = {}
        if device is not None:
            kw["device"] = _place._as_torch(device)
        if dtype is not None:
            kw["dtype"] = convert_dtype(dtype)
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = kw["dtype"]
        return super().to(**kw, **kwargs) if kw or kwargs else self


@torch.no_grad()
def load_jax_state(module: nn.Module, state: Dict[str, np.ndarray]):
    """Copy `state`, the numpy form of a JAX model's parameters (and BN
    buffers), into `module`'s parameters and buffers, each keeping its
    own dtype and device. Names and shapes must match exactly (the port
    keeps the JAX package's names and layouts: no renaming, no
    transposes), but that a parameter split over a mesh axis (tensor or
    expert parallel) takes the whole JAX array and keeps this rank's
    piece of it. Returns the module."""
    from ...parallel.api import local_piece
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"state names differ: missing {missing}, "
                         f"unexpected {extra}")
    for name, t in own.items():
        src = np.asarray(state[name])
        # through f32 (f64 kept): torch has no counterpart of the JAX
        # package's numpy bf16; copy_ casts to the tensor's own dtype
        wide = np.float64 if src.dtype == np.float64 else np.float32
        src = torch.from_numpy(np.array(src, dtype=wide))
        if tuple(src.shape) == getattr(t, "_whole_shape", None):
            src = local_piece(src, t)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(t.shape)}")
        t.copy_(src)
    return module


@torch.no_grad()
def gather_jax_state(module: nn.Module) -> Dict[str, np.ndarray]:
    """load_jax_state's inverse: every parameter and buffer of `module`
    as a whole numpy array (f32 for low-precision tensors) under its JAX
    name; a parameter split over a mesh axis is all-gathered (every rank
    of the axis calls this)."""
    from ...parallel.api import whole_piece
    out = {}
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        whole = whole_piece(t.detach(), t)
        if whole.dtype in (torch.bfloat16, torch.float16):
            whole = whole.float()
        out[name] = whole.cpu().numpy()
    return out


@torch.no_grad()
def load_jax_scope(scope, state: Dict[str, np.ndarray]):
    """Fill a static Scope (paddle_tpu_torch.static) from the JAX
    package's scope values as numpy, {name: array}, by name: a static
    program of the same model code has the same variable names in both
    packages (their Program.unique_name counters), so the two run from
    the same parameters and accumulators. Values land on the CPU in
    their dtype (bf16 arrives as f32 numpy and stays f32); an Executor
    moves them to its device on first use. Returns the scope."""
    for name, arr in state.items():
        scope.set(name, torch.from_numpy(np.array(arr, copy=True)))
    return scope
