"""Tensor and to_tensor (port of paddle_tpu/core/tensor.py).

The JAX package's Tensor wraps a jax.Array and records a tape of vjp
closures. The port's Tensor IS a torch.Tensor subclass, and torch's
autograd graph is the tape. It adds Paddle's semantics:
- `stop_gradient` (the inverse of requires_grad; True for to_tensor's
  results by default, False for parameters);
- `.grad` is a Tensor, `.shape` a list, `.place` a Place;
- `.numpy()` copies to the host (detaching first), `astype`/`cast`,
  `clear_grad`, `set_value`, `backward(grad_tensor, retain_graph)` and a
  `transpose` that also takes Paddle's permutation list.
Every torch operation on a Tensor returns a Tensor (its
`__torch_function__` boxes plain results), so user code keeps Paddle's
semantics from op to op.

That costs a Python call per operation, so the model code never sees a
Tensor: Layer.__call__ and the registered ops (core/dispatch.py), when
user code hands them Tensors, convert those to plain torch.Tensors once
on the way in (`plain`, an alias that stays on the autograd graph) and
box the result once on the way out (`box`), at the outermost call
only. Module bodies and the kernels see plain tensors; callers that
pass plain torch.Tensors (the train steps, the serving engine) get
plain results and no per-op Python.

Parameters are `EagerParamBase`: a Tensor and a torch.nn.Parameter at
once, with Paddle's name, trainable, need_clip, optimize_attr and
regularizer. At user level an operation on a parameter returns a Tensor,
as on any Tensor (`(p * 2).scale_(2.0)`, `p.clone().numpy()`). Inside
the port the parameters cost nothing per op all the same: the op
boundary, Layer.__call__ and the train steps run under torch's
DisableTorchFunctionSubclass (`plain_dispatch`, core/dispatch.py
`inside`), where torch calls no `__torch_function__`, a parameter acts
as the plain tensor it holds and the op boundary boxes nothing; the
optimizers and the serving engine take parameters through `plain`.

Paddle's methods. ops/__init__.py attaches the JAX package's method
table (paddle_tpu/ops/__init__.py `_attach_tensor_methods`) to this
class, so `x.split(2)`, `x.median()` or `x.max(axis=1)` answer as in
the JAX package wherever Paddle and torch share a name. Five rules keep
that safe:
- torch's own Python calls methods on the subclass. torch's library
  functions written in Python that do so (torch.functional's split and
  norm, torch.nn.functional, torch.distributions) get plain aliases of
  their Tensor arguments from `__torch_function__`, so they meet torch's
  methods; torch's C functions, torch.autograd and torch.Tensor's own
  methods (register_hook, requires_grad_) run on the Tensor itself,
  which they need. `__repr__`, `__reduce_ex__` and
  `__deepcopy__` are this class's own and work on a plain alias, so
  every result prints, pickles and deep-copies; `__format__` formats a
  0-d Tensor as its value, as torch formats a plain one. `real` and
  `imag` are methods here, as in Paddle (torch has properties);
  `numel()` returns a Tensor and `item(*args)` takes a flat or multi
  index, as in the JAX package.
- Parameters (`EagerParamBase`) take the Paddle methods too, except the
  names in `TORCH_ON_PARAMETERS` ("numel", "size"): torch's library and
  the port's module bodies call those on parameters and expect torch's
  answers (an int and a torch.Size).
- The port's own host code (hapi, metric, io collation, the optimizers,
  clipping, save/load, checkpoints) calls torch functions, or methods
  on plain tensors, never a method whose meaning the table changes.
- `tpu()` is the one JAX Tensor name the port leaves out: this card
  has no TPU, and torch's `cuda()` stands in for it.
- `Tensor.size` stays torch's method (the JAX package has a property
  that returns the element count): torch code calls `size()` and
  `size(dim)` on tensors and parameters alike.
"""
from __future__ import annotations

import copy
import functools
import inspect

import numpy as np
import torch

from . import dtypes as _dt
from . import place as _place

__all__ = ["Tensor", "EagerParamBase", "to_tensor", "box", "plain",
           "plain_dispatch", "wrap", "TORCH_ON_PARAMETERS"]

# torch methods that parameters keep over the Paddle method table
TORCH_ON_PARAMETERS = ("numel", "size")

_DIS = torch._C.DisableTorchFunctionSubclass
_TensorBase = torch._C.TensorBase

# process-global counter of the names of Tensors and parameters
# (the JAX package's `_tensor_name_counter`)
_tensor_name_counter = [0]


def _auto_name(prefix="generated_tensor"):
    _tensor_name_counter[0] += 1
    return f"{prefix}_{_tensor_name_counter[0]}"


class _Shape(list):
    """Paddle's list shape that still compares equal to torch.Size and
    tuples, so torch's own shape checks keep working on parameters."""

    __hash__ = None

    def __eq__(self, other):
        if isinstance(other, (list, tuple)):
            return tuple(self) == tuple(other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq


# static/program.py sets this while static capture is on: fn(plain
# tensor) -> the static Variable the tensor aliases, or None
_static_lookup = None


def box(out):
    """Plain torch.Tensor results (also inside a list or tuple) as
    Tensors (a static Variable's alias as that Variable); anything else
    unchanged."""
    if type(out) is torch.Tensor:
        if _static_lookup is not None:
            v = _static_lookup(out)
            if v is not None:
                return v
        return torch.Tensor.as_subclass(out, Tensor)
    if type(out) in (list, tuple):
        return type(out)(box(o) for o in out)
    return out


def plain(t):
    """A Tensor or a parameter as a plain torch.Tensor alias (on the
    autograd graph); anything else unchanged."""
    if isinstance(t, Tensor):
        with _DIS():
            return torch.Tensor.as_subclass(t, torch.Tensor)
    return t


def plain_dispatch(fn):
    """fn run under torch's DisableTorchFunctionSubclass: no
    `__torch_function__` is called inside, Tensors and parameters act as
    the plain tensors they hold, and what torch makes there is plain.
    The port's code that works on parameters runs so, and pays no Python
    call per op."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _DIS():
            return fn(*args, **kwargs)
    return wrapper


def _unbox(a):
    """Tensors and parameters (also inside a list or tuple) as plain
    aliases (call under _DIS)."""
    if isinstance(a, Tensor):
        return torch.Tensor.as_subclass(a, torch.Tensor)
    if type(a) in (list, tuple) and any(isinstance(x, Tensor) for x in a):
        return type(a)(_unbox(x) for x in a)
    return a


# torch's modules of functions written in Python that call methods on
# their tensor arguments (torch.split calls tensor.split); autograd's
# functions are not among them: they need the Tensor itself
_LIBRARY_MODULES = ("torch.functional", "torch.nn.functional",
                    "torch.distributions")


def _library_function(func) -> bool:
    """A torch function written in Python that may call methods on its
    arguments."""
    return inspect.isfunction(func) and \
        (func.__module__ or "").startswith(_LIBRARY_MODULES)


_REPR_TYPES = {}


def _repr(t, tensor_contents=None) -> str:
    """torch's text for t, made from an alias of a plain subclass of the
    same name (torch's printing calls methods on what it prints)."""
    name = type(t).__name__
    cls = _REPR_TYPES.get(name)
    if cls is None:
        cls = _REPR_TYPES[name] = type(name, (torch.Tensor,), {
            "__torch_function__": torch._C._disabled_torch_function_impl})
    with _DIS():
        alias = torch.Tensor.as_subclass(t, cls)
    return torch._tensor_str._str(alias, tensor_contents=tensor_contents)


def _rebuild(t, state):
    """Unpickle a Tensor: the plain tensor boxed, with its attributes."""
    out = torch.Tensor.as_subclass(t, Tensor)
    out.__dict__.update(state)
    return out


class Tensor(torch.Tensor):
    """Paddle's eager tensor over a torch.Tensor (see the module
    docstring). Build one with to_tensor, or Tensor(value,
    stop_gradient=True, name=None, persistable=False)."""

    def __new__(cls, value=None, stop_gradient: bool = True,
                name: str = None, persistable: bool = False):
        t = to_tensor(value if value is not None else [],
                      stop_gradient=stop_gradient)
        if name is not None:
            t.name = name
        t.persistable = persistable
        return t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with _DIS():
            if _library_function(func):
                args = tuple(_unbox(a) for a in args)
                kwargs = {k: _unbox(v) for k, v in kwargs.items()}
            out = func(*args, **kwargs)
        return box(out)

    def __repr__(self, *, tensor_contents=None):
        return _repr(self, tensor_contents)

    def __format__(self, format_spec):
        # torch formats a 0-d tensor as its value only when it is not a
        # subclass: f"{t:.1f}" on a 0-d result (numel(), a mean) works
        if self.dim() == 0:
            return format(self.item(), format_spec)
        return object.__format__(self, format_spec)

    def __reduce_ex__(self, proto):
        with _DIS():
            t = torch.Tensor.as_subclass(self, torch.Tensor)
        return _rebuild, (t, dict(self.__dict__))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        with _DIS():
            t = torch.Tensor.__deepcopy__(
                torch.Tensor.as_subclass(self, torch.Tensor), {})
            out = torch.Tensor.as_subclass(t, type(self))
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = out
        return out

    # the JAX Tensor's own parameter attributes: a Tensor that is not a
    # parameter answers with what the port's optimizers assume for it
    is_parameter = False
    trainable = True
    need_clip = True
    optimize_attr = None
    regularizer = None
    do_model_average = None

    # ------------------------------------------------------------- meta
    @property
    def shape(self):
        with _DIS():
            return _Shape(_TensorBase.size(self))

    @property
    def place(self):
        with _DIS():
            return _place.place_of(_TensorBase.device.__get__(self))

    @property
    def name(self):
        n = self.__dict__.get("_name")
        if n is None:
            n = self.__dict__["_name"] = _auto_name()
        return n

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def persistable(self):
        return self.__dict__.get("_persistable", False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_persistable"] = bool(value)

    # --------------------------------------------------------- autograd
    @property
    def stop_gradient(self) -> bool:
        with _DIS():
            return not _TensorBase.requires_grad.__get__(self)

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        with _DIS():
            if not value or self.is_leaf:
                _TensorBase.requires_grad_(self, not value)
            elif _TensorBase.requires_grad.__get__(self):
                raise RuntimeError(
                    "stop_gradient=True on a non-leaf Tensor: use "
                    "detach() for a Tensor cut from the graph")

    @property
    def grad(self):
        """The accumulated gradient as a Tensor (None before backward).
        The stored gradient itself is made a Tensor on first read, so
        later reads return the same object."""
        with _DIS():
            g = _TensorBase.grad.__get__(self)
            if g is not None and type(g) is torch.Tensor:
                g = torch.Tensor.as_subclass(g, Tensor)
                _TensorBase.grad.__set__(self, g)
        return g

    @grad.setter
    def grad(self, value):
        with _DIS():
            _TensorBase.grad.__set__(self, value)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        """Accumulate d(self)/d(leaf) into every leaf's .grad; a missing
        grad_tensor is ones (Paddle's rule, for any shape)."""
        from .autograd import backward as _backward
        _backward(self, grad_tensor, retain_graph)

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    # ----------------------------------------------------------- convert
    def numpy(self):
        """A host copy (detached; bf16 comes back as float32, numpy has
        no bfloat16)."""
        with _DIS():
            t = _TensorBase.detach(self)
            if t.dtype == torch.bfloat16:
                t = t.float()
            return _TensorBase.numpy(t.cpu())

    def astype(self, dtype):
        return self.to(_dt.convert_dtype(dtype))

    def cast(self, dtype):
        return self.astype(dtype)

    def rank(self):
        """The number of axes (an int, as in the JAX package)."""
        return self.ndim

    def value(self):
        return self

    def get_tensor(self):
        return self

    def retain_grads(self):
        """Keep .grad on a non-leaf Tensor after backward."""
        with _DIS():
            _TensorBase.retain_grad(self)

    def item(self, *args):
        """The value as a Python scalar; args index it as numpy's
        ndarray.item does (one flat index, or one index per axis)."""
        with _DIS():
            t = torch.Tensor.as_subclass(self, torch.Tensor)
            if len(args) == 1 and not isinstance(args[0], tuple):
                t = t.reshape(-1)[args[0]]
            elif args:
                t = t[tuple(args[0]) if len(args) == 1 else args]
            return t.item()

    def set_value(self, value):
        """Overwrite the values in place (shape kept, own dtype). Like
        Paddle's eager set_value this is an in-place write: a graph that
        saved this Tensor refuses to differentiate through it after
        (torch's version counter), rather than use the new value."""
        src = value if torch.is_tensor(value) else torch.as_tensor(
            np.asarray(value))
        if tuple(src.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(src.shape)}"
                             f" vs {tuple(self.shape)}")
        with torch.no_grad(), _DIS():
            _TensorBase.copy_(self, plain(src).to(self.device))
        return self


def _transpose(x, perm=None, *dims, name=None):
    """Paddle's x.transpose(perm) with a permutation list (all axes
    reversed when None), or torch's x.transpose(dim0, dim1). (Bound as
    a method with the reference's first parameter x, as the JAX package
    binds its Tensor methods.)"""
    if dims:
        return torch.Tensor.transpose(x, perm, *dims)
    if perm is None:
        perm = list(reversed(range(x.ndim)))
    return x.permute(*perm)


Tensor.transpose = _transpose


class EagerParamBase(Tensor, torch.nn.Parameter):
    """A parameter: a leaf Tensor with stop_gradient False (unless made
    not trainable), registered on a Layer like a torch.nn.Parameter."""

    def __new__(cls, data, requires_grad: bool = True, **attrs):
        return torch.Tensor._make_subclass(cls, plain(data).detach(),
                                           requires_grad)

    def __init__(self, data, requires_grad: bool = True, name=None,
                 trainable: bool = True, learning_rate: float = 1.0,
                 regularizer=None, need_clip: bool = True,
                 do_model_average: bool = False):
        self.name = name or _auto_name()
        self.persistable = True
        self.is_parameter = True
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": learning_rate}
        self.regularizer = regularizer
        self.need_clip = need_clip
        self.do_model_average = do_model_average

    __reduce_ex__ = torch.nn.Parameter.__reduce_ex__

    def __repr__(self, *, tensor_contents=None):
        return "Parameter containing:\n" + _repr(self, tensor_contents)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        with torch.no_grad():
            out = type(self)(self.detach().clone(), self.requires_grad)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = out
        return out


for _name in TORCH_ON_PARAMETERS:
    setattr(EagerParamBase, _name, getattr(torch.Tensor, _name))


def wrap(x, like=None):
    """x as a tensor: a torch tensor as it is, anything else (a number,
    a list, an ndarray) through to_tensor, on `like`'s device when like
    is a tensor, else on the default device (the JAX package's
    `_wrap`)."""
    if torch.is_tensor(x):
        return x
    return to_tensor(x, place=like.device if torch.is_tensor(like)
                     else None)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new leaf Tensor on `place` (the default device
    when None; see core/place.py). Python floats (and lists of them)
    take the default float dtype; a float64 ndarray keeps float64."""
    dtype = _dt.convert_dtype(dtype)
    device = _place.resolve_device(place)
    if torch.is_tensor(data):
        t = plain(data).detach()
    else:
        a = np.asarray(data)
        if dtype is None and a.dtype == np.float64 \
                and not isinstance(data, np.ndarray):
            dtype = _dt.get_default_dtype()
        if a.dtype == object:
            raise TypeError(f"to_tensor: cannot convert {type(data)}")
        t = torch.from_numpy(np.array(a, copy=True))
    t = t.to(device=device, dtype=dtype or t.dtype, copy=True)
    # Paddle lets an integer Tensor have stop_gradient False; torch has
    # no gradient for it, so it stays a constant
    grad = not stop_gradient and (t.is_floating_point() or t.is_complex())
    return torch.Tensor._make_subclass(Tensor, t, grad)
