"""Static graph IR: Program / Block / Variable and the op capture (port
of paddle_tpu/static/program.py).

A Program records one OpDesc per framework op: the op's Paddle type
(the JAX package's: "linear", "reshape", "elementwise_add", ...), the
names of its input and output Variables, and a closure that computes it
from the input tensors. The Executor (static/executor.py) replays the
closures eagerly on its device.

Capture. The JAX package captures in its op dispatcher, which every
Tensor method reaches. The port's module bodies instead call torch
directly on plain tensors (under DisableTorchFunctionSubclass, with the
`@op` wrappers calling their functions directly inside a Layer). So
while static mode is on, two hooks record:
- the `@op` wrapper (core/dispatch.py `_State.capture`) records one
  OpDesc under its op type whenever an argument is a Variable, at any
  depth, and does not look inside;
- a TorchFunctionMode (modes fire under DisableTorchFunctionSubclass)
  records every other torch function that meets a Variable under the
  Paddle type of the same math (`_TORCH_OP_TYPES`: `x + y` is
  "elementwise_add", `w[:, a:b]` "getitem", `x.transpose(1, 2)`
  "transpose"), passes metadata reads (shape, dtype, size()) through,
  treats dtype-preserving conversions (`.long()` of an int64,
  `contiguous()`) as the Variable itself, and raises for anything else:
  a torch call it cannot record, or a read of a Variable's value
  (`item()`, `bool()`, `numpy()`).
A torch call that meets no Variable runs at once (constant folding, as
in the JAX package); one that asks for the meta device (a layer built
in static mode has no device) runs on the CPU, and the result enters
the Program as a constant (`const_N`) where an op uses it.

Variables are Tensors over meta tensors: shapes and dtypes flow, no
memory is held. Shape inference runs each recorded function on the
inputs' meta tensors (the port's kernels register meta versions:
the custom ops of ops/kernels/flash_attention.py and packed_flash.py),
the analogue of the JAX package's jax.eval_shape. A Variable is found again from any plain
alias of its meta tensor (module bodies see aliases) through its
storage. Dims declared None / -1 are 1 in the meta tensor, as in the
JAX package's shape inference; a module body that reads such a dim
bakes the 1 into what it records (the JAX package reads -1 there).

Layers built in static mode take parameters that are Variables
(`ParamVariable`, also an nn.Parameter, so the module's naming sees
them) with an init op in the startup program, and their persistable
buffers become persistable Variables (nn/layer/layers.py).

Left out: install_capture_hook is enable_static (the port has no
dispatcher hook to install).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import Callable, Dict, List

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from ..core import dtypes as _dt
from ..core import place as _place
from ..core import tensor as _tensor
from ..core.dispatch import _State
from ..core.tensor import Tensor, _DIS, _Shape
from . import mode as _mode

__all__ = ["Variable", "ParamVariable", "OpDesc", "Block", "Program",
           "default_main_program", "default_startup_program",
           "set_default_programs", "program_guard", "data",
           "create_parameter", "install_capture_hook"]

_DISALL = torch._C.DisableTorchFunction
_META = torch.device("meta")
_CPU = torch.device("cpu")
_tls = threading.local()

# storage of a Variable's meta tensor -> the Variable (plain aliases of
# the meta tensor share the storage)
_VARS: "weakref.WeakValueDictionary[int, Variable]" = \
    weakref.WeakValueDictionary()


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _is_meta(t: torch.Tensor) -> bool:
    with _DISALL():
        return torch._C.TensorBase.device.__get__(t).type == "meta"


def _var_of(t):
    """The Variable that tensor t is (or aliases), else None."""
    if isinstance(t, Variable):
        return t
    if not isinstance(t, torch.Tensor) or not _is_meta(t):
        return None
    with _DISALL():
        key = torch._C.TensorBase.untyped_storage(t)._cdata
    return _VARS.get(key)


class Variable(Tensor):
    """A symbolic tensor of a Program (reference: framework.py Variable;
    paddle_tpu/static/program.py:28). It holds a meta tensor of its
    shape and dtype, so the Tensor surface answers shape and dtype,
    while reading a value (numpy(), item(), bool()) raises."""

    def __new__(cls, shape, dtype, name: str, block: "Block",
                persistable: bool = False, stop_gradient: bool = True,
                is_data: bool = False):
        dtype = _dt.convert_dtype(dtype) or _dt.get_default_dtype()
        declared = [(-1 if d is None or (isinstance(d, int) and d < 0)
                     else int(d)) for d in shape]
        with _DISALL():
            meta = torch.empty([1 if d == -1 else d for d in declared],
                               dtype=dtype, device=_META)
            v = torch.Tensor._make_subclass(cls, meta, False)
            key = torch._C.TensorBase.untyped_storage(v)._cdata
        v.__dict__.update(
            _static_meta=meta, _declared_shape=declared, _name=name,
            _persistable=bool(persistable), _stop_gradient=stop_gradient,
            block=block, is_data=is_data, is_parameter=False,
            trainable=not stop_gradient)
        _VARS[key] = v
        return v

    def __init__(self, *args, **kwargs):
        pass

    @property
    def shape(self):
        return _Shape(self._declared_shape)

    @property
    def stop_gradient(self) -> bool:
        return self.__dict__["_stop_gradient"]

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self.__dict__["_stop_gradient"] = bool(value)

    def _no_value(self, *args, **kwargs):
        raise RuntimeError(
            f"Variable '{self.name}' has no value at graph-build time; "
            "fetch it through Executor.run (reference: static Variables "
            "are symbolic, framework.py:938)")

    numpy = item = tolist = __bool__ = __float__ = __int__ = __index__ = \
        __array__ = _no_value

    def __repr__(self, *, tensor_contents=None):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={_dtype_name(self.dtype)}, "
                f"persistable={self.persistable})")

    __str__ = __repr__

    def __reduce_ex__(self, proto):
        raise TypeError(f"Variable '{self.name}' cannot be pickled: save "
                        "the Program's values with paddle.static.save")

    def __deepcopy__(self, memo):
        return self


class ParamVariable(Variable, torch.nn.Parameter):
    """A static parameter: a persistable Variable that an nn.Module
    registers as a parameter (its value lives in the Scope)."""

    def __new__(cls, shape, dtype, name, block, persistable=True,
                stop_gradient=False, is_data=False):
        v = Variable.__new__(cls, shape, dtype, name, block, persistable,
                             stop_gradient, is_data)
        v.is_parameter = True
        return v

    __repr__ = Variable.__repr__
    __reduce_ex__ = Variable.__reduce_ex__
    __deepcopy__ = Variable.__deepcopy__


class OpDesc:
    """One recorded op (reference: framework.py Operator / C++ OpDesc).

    kind:
      'op'       - fn computes the outputs from the input tensors
      'init'     - fn(device) makes a persistable's startup value
      'backward' - payload (loss_name, param_names), or ("vjp", target
                   names, input names, target-gradient names, no-grad
                   names) for gradients(); the Executor takes
                   torch.autograd.grad of the forward it already ran
    """

    __slots__ = ("kind", "op_type", "fn", "input_names", "output_names",
                 "payload")

    def __init__(self, kind, op_type, fn, input_names, output_names,
                 payload=None):
        self.kind = kind
        self.op_type = op_type
        self.fn = fn
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self.payload = payload

    @property
    def type(self):
        return self.op_type

    def __repr__(self):
        return (f"{{{self.op_type}: ({', '.join(self.input_names)}) -> "
                f"({', '.join(self.output_names)})}}")


class Block:
    """Op and Variable container (reference: framework.py Block). A
    program has one block; control flow records sub-programs
    (static/nn.py cond)."""

    def __init__(self, program: "Program", idx: int = 0):
        self.program = program
        self.idx = idx
        self.ops: List[OpDesc] = []
        self.vars: Dict[str, Variable] = collections.OrderedDict()

    def create_var(self, name=None, shape=(), dtype="float32",
                   persistable=False, stop_gradient=True, is_data=False):
        name = name or self.program.unique_name("tmp")
        v = Variable(shape, dtype, name, self, persistable=persistable,
                     stop_gradient=stop_gradient, is_data=is_data)
        self.vars[name] = v
        return v

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"Variable {name} not found in block {self.idx}")
        return v

    def has_var(self, name):
        return name in self.vars

    def append_op(self, od: OpDesc):
        self.ops.append(od)
        self.program._version += 1
        return od

    def all_parameters(self):
        return [v for v in self.vars.values() if v.is_parameter]


class Program:
    """An op list and its symbol table (reference: framework.py Program /
    ProgramDesc)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self._version = 0
        self._name_counter = collections.defaultdict(int)
        # constants (CPU tensors) that ops read by name
        self._consts: Dict[str, torch.Tensor] = {}
        # host scalars read at every Executor.run (scheduled learning
        # rates), so a new value needs no new analysis
        self._runtime_scalars: Dict[str, Callable[[], float]] = {}
        self.random_seed = 0
        # py_reader queues (static/rnn_shims.py) the Executor drains
        self._py_readers: list = []

    @property
    def global_block(self):
        return self.blocks[0]

    def block(self, idx=0):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[-1]

    @property
    def ops(self):
        return self.global_block.ops

    def unique_name(self, prefix="tmp"):
        self._name_counter[prefix] += 1
        return f"{prefix}_{self._name_counter[prefix]}"

    def all_parameters(self):
        return self.global_block.all_parameters()

    def list_vars(self):
        return list(self.global_block.vars.values())

    def add_const(self, value) -> str:
        name = self.unique_name("const")
        self._consts[name] = value
        return name

    def add_runtime_scalar(self, prefix: str, fn: Callable) -> str:
        name = self.unique_name(prefix)
        self._runtime_scalars[name] = fn
        return name

    def clone(self, for_test: bool = False) -> "Program":
        """reference: Program.clone. for_test=True keeps the ops before
        the first backward or optimizer op. Ops keep the behaviour they
        were recorded with (dropout masks, batch statistics)."""
        p = Program()
        p._name_counter = collections.Counter(self._name_counter)
        p._consts = dict(self._consts)
        p._runtime_scalars = dict(self._runtime_scalars)
        blk = p.global_block
        ops = self.global_block.ops
        if for_test:
            cut = len(ops)
            for i, od in enumerate(ops):
                if od.kind == "backward" or od.op_type.startswith("optimize"):
                    cut = i
                    break
            ops = ops[:cut]
        blk.ops = list(ops)
        for name, v in self.global_block.vars.items():
            nv = Variable(v.shape, v.dtype, name, blk,
                          persistable=v.persistable,
                          stop_gradient=v.stop_gradient, is_data=v.is_data)
            nv.is_parameter = v.is_parameter
            nv.trainable = getattr(v, "trainable", True)
            blk.vars[name] = nv
        return p

    def __repr__(self):
        lines = [f"Program(ops={len(self.ops)})"]
        for od in self.ops:
            lines.append("  " + repr(od))
        return "\n".join(lines)

    __str__ = __repr__


# ------------------------------------------------------------------ defaults
_default_main_program = Program()
_default_startup_program = Program()
_program_stack: List[tuple] = []


def default_main_program() -> Program:
    return _default_main_program


def default_startup_program() -> Program:
    return _default_startup_program


def set_default_programs(main, startup):
    global _default_main_program, _default_startup_program
    _default_main_program = main
    _default_startup_program = startup


class program_guard:
    """reference: framework.py program_guard."""

    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        global _default_main_program, _default_startup_program
        _program_stack.append((_default_main_program,
                               _default_startup_program))
        _default_main_program = self.main
        if self.startup is not None:
            _default_startup_program = self.startup
        return self

    def __exit__(self, *exc):
        global _default_main_program, _default_startup_program
        _default_main_program, _default_startup_program = _program_stack.pop()
        return False


def data(name: str, shape, dtype="float32", lod_level=0):
    """Feed placeholder (reference: python/paddle/static/input.py data)."""
    blk = default_main_program().current_block()
    if blk.has_var(name):
        return blk.var(name)
    return blk.create_var(name=name, shape=shape, dtype=dtype,
                          persistable=False, stop_gradient=True,
                          is_data=True)


# ------------------------------------------------------------------- capture
@contextlib.contextmanager
def _inert():
    """Run torch code with capture off: a recorded function's shape
    inference on meta tensors and the Executor's replay (nested ops
    call their functions directly, parameters act as plain tensors)."""
    _tls.off = getattr(_tls, "off", 0) + 1
    _State.depth += 1
    try:
        with _DIS():
            yield
    finally:
        _State.depth -= 1
        _tls.off -= 1


@contextlib.contextmanager
def _paused():
    """Take the capture's TorchFunctionMode off the stack for a while
    (the Executor's replay, torch.export of an inference program), so
    torch calls there pay nothing for it."""
    mode = _capture_state.get("mode")
    stack = torch.overrides._get_current_function_mode_stack()
    if mode is None or not stack or stack[-1] is not mode:
        yield  # not this thread's mode (the stack is per thread)
        return
    mode.__exit__(None, None, None)
    try:
        yield
    finally:
        mode.__enter__()


def _capturing() -> bool:
    return _mode._static_mode and not getattr(_tls, "off", 0)


def _user_level() -> bool:
    """A call from user code (not a module body or an op): Variables
    come back as Variables, else as their plain meta aliases."""
    return _State.depth == 0 and torch._C._is_torch_function_enabled()


def _is_meta_device(x) -> bool:
    return (isinstance(x, torch.device) and x.type == "meta") or \
        (isinstance(x, str) and x == "meta")


def _record(op_type: str, fn, args, kwargs, differentiable=True):
    """Append fn(*args, **kwargs) as one OpDesc of `op_type` to the
    current block and return its outputs as new Variables."""
    prog = default_main_program()
    blk = prog.current_block()
    flat, spec = pytree.tree_flatten((args, kwargs))
    slots, names, metas, stops, dev_slots = [], [], [], [], []
    for i, x in enumerate(flat):
        if _is_meta_device(x):
            dev_slots.append(i)
            continue
        if not isinstance(x, torch.Tensor):
            continue
        v = _var_of(x)
        if v is not None:
            names.append(v.name)
            metas.append(v._static_meta)
            stops.append(v.stop_gradient)
        else:
            if _is_meta(x):
                raise RuntimeError(
                    f"static capture of {op_type}: an argument is a meta "
                    "tensor that belongs to no Program")
            with _DISALL():
                c = x.detach()
                metas.append(torch.empty_strided(
                    c.shape, c.stride(), dtype=c.dtype, device=_META))
            names.append(prog.add_const(c))
            stops.append(not x.requires_grad)
        slots.append(i)

    def pure(*ins, _flat=tuple(flat), _spec=spec, _slots=tuple(slots),
             _dev=tuple(dev_slots), _fn=fn):
        ll = list(_flat)
        for i, a in zip(_slots, ins):
            ll[i] = a
        if _dev and ins:
            for i in _dev:
                ll[i] = ins[0].device
        a2, k2 = pytree.tree_unflatten(ll, _spec)
        return _fn(*a2, **k2)

    with _inert():
        out = pure(*metas)
    out_flat, out_spec = pytree.tree_flatten(out)
    stop = (not differentiable) or all(stops)
    user = _user_level()
    ret, out_names = [], []
    for o in out_flat:
        if isinstance(o, torch.Tensor):
            v = blk.create_var(name=prog.unique_name(f"{op_type}.out"),
                               shape=tuple(o.shape), dtype=o.dtype,
                               stop_gradient=stop)
            out_names.append(v.name)
            ret.append(v if user else v._static_meta)
        else:
            ret.append(o)
    blk.append_op(OpDesc("op", op_type, pure, names, out_names))
    return pytree.tree_unflatten(ret, out_spec)


def _has_variable(args, kwargs) -> bool:
    for x in pytree.tree_leaves((args, kwargs)):
        if isinstance(x, torch.Tensor) and _var_of(x) is not None:
            return True
    return False


def _capture_op(op_type, fn, args, kwargs, differentiable=True):
    """core/dispatch.py's `_State.capture`: record an `@op` call that
    meets a Variable (NotImplemented: run it as usual)."""
    if not _capturing() or not _has_variable(args, kwargs):
        return NotImplemented
    return _record(op_type, fn, args, kwargs, differentiable)


# torch functions on Variables, by name, and the Paddle op types of the
# same math (the JAX package's dunders and methods, paddle_tpu/ops/
# __init__.py:172-201 and the ops' registered names)
_TORCH_OP_TYPES = {}
for _names, _type in (
        (("add", "__add__", "__radd__"), "elementwise_add"),
        (("sub", "subtract", "__sub__", "__rsub__", "rsub"),
         "elementwise_sub"),
        (("mul", "multiply", "__mul__", "__rmul__"), "elementwise_mul"),
        (("div", "divide", "true_divide", "__truediv__", "__rtruediv__",
          "__div__"), "elementwise_div"),
        (("floor_divide", "__floordiv__", "__rfloordiv__"),
         "elementwise_floordiv"),
        (("remainder", "fmod", "__mod__", "__rmod__"), "elementwise_mod"),
        (("pow", "__pow__", "__rpow__"), "elementwise_pow"),
        (("maximum",), "elementwise_max"), (("minimum",), "elementwise_min"),
        (("matmul", "__matmul__", "__rmatmul__", "mm", "bmm"), "matmul_v2"),
        (("neg", "negative", "__neg__"), "neg"), (("__abs__",), "abs"),
        (("eq", "__eq__"), "equal"), (("ne", "__ne__"), "not_equal"),
        (("lt", "less", "__lt__"), "less_than"),
        (("le", "less_equal", "__le__"), "less_equal"),
        (("gt", "greater", "__gt__"), "greater_than"),
        (("ge", "greater_equal", "__ge__"), "greater_equal"),
        (("__and__", "__rand__"), "bitwise_and"),
        (("__or__", "__ror__"), "bitwise_or"),
        (("__xor__", "__rxor__"), "bitwise_xor"),
        (("__invert__", "bitwise_not"), "bitwise_not"),
        (("__getitem__",), "getitem"),
        (("reshape", "view", "view_as", "reshape_as"), "reshape"),
        (("transpose", "permute", "swapaxes", "t"), "transpose"),
        (("cat", "concat", "concatenate"), "concat"),
        (("sum",), "reduce_sum"), (("mean",), "reduce_mean"),
        (("squeeze",), "squeeze"), (("unsqueeze",), "unsqueeze"),
        (("flatten",), "flatten"), (("expand", "expand_as"), "expand"),
        (("where",), "where"), (("clamp", "clip"), "clip"),
        (("index_select",), "index_select"), (("gather",), "gather"),
        (("masked_fill",), "masked_fill"), (("tril",), "tril"),
        (("triu",), "triu"), (("split", "chunk"), "split"),
        (("unbind",), "unstack"), (("softmax",), "softmax"),
        (("log_softmax",), "log_softmax"), (("relu",), "relu"),
        (("sigmoid",), "sigmoid"), (("silu",), "silu"), (("gelu",), "gelu"),
        (("linear",), "linear"), (("embedding",), "lookup_table_v2"),
        (("layer_norm",), "layer_norm"), (("einsum",), "einsum"),
        (("zeros_like",), "zeros_like"), (("ones_like",), "ones_like"),
        (("full_like",), "full_like"), (("repeat",), "tile"),
        (("roll",), "roll"), (("flip",), "flip"), (("sqrt",), "sqrt"),
        (("rsqrt",), "rsqrt"), (("exp",), "exp"), (("log",), "log"),
        (("tanh",), "tanh"), (("abs",), "abs"), (("square",), "square"),
        (("amax",), "amax"), (("amin",), "amin"), (("max",), "max"),
        (("min",), "min"), (("argmax",), "argmax"), (("argmin",), "argmin"),
        (("cumsum",), "cumsum"), (("stack",), "stack"),
        (("topk",), "top_k_v2"), (("sort",), "sort"),
        (("logical_not",), "logical_not"), (("logical_and",), "logical_and"),
        (("logical_or",), "logical_or"), (("isnan",), "isnan"),
        (("isinf",), "isinf"), (("isfinite",), "isfinite"),
        (("erf",), "erf"), (("sin",), "sin"), (("cos",), "cos"),
        (("floor",), "floor"), (("ceil",), "ceil"), (("round",), "round"),
        (("sign",), "sign"), (("reciprocal",), "reciprocal"),
        (("lerp",), "lerp"), (("logsumexp",), "logsumexp"),
        (("prod",), "reduce_prod"), (("all",), "all"), (("any",), "any"),
        (("outer",), "outer"), (("dropout",), "dropout"),
        (("pad",), "pad_nd"), (("narrow",), "slice"),
        (("select",), "getitem"), (("clone",), "assign")):
    for _n in _names:
        _TORCH_OP_TYPES[_n] = _type

# metadata the capture passes through (no op, no value read)
_PASS = set()
for _n in ("shape", "dtype", "device", "ndim", "requires_grad", "is_leaf",
           "layout", "is_cuda", "is_meta", "is_sparse", "is_quantized",
           "grad_fn", "names", "grad", "data", "itemsize", "nbytes"):
    if hasattr(torch.Tensor, _n):
        _PASS.add(getattr(torch.Tensor, _n).__get__)
for _n in ("size", "dim", "stride", "numel", "nelement", "element_size",
           "is_floating_point", "is_complex", "is_contiguous",
           "untyped_storage", "storage_offset", "data_ptr", "get_device",
           "__len__", "__format__", "is_signed", "__hash__", "ndimension",
           "requires_grad_", "retain_grad", "register_hook", "__setstate__",
           "_is_view", "dim_order"):
    if hasattr(torch.Tensor, _n):
        _PASS.add(getattr(torch.Tensor, _n))
_PASS.add(torch.is_tensor)

# reads of a value, which a Variable has not at graph-build time
_VALUE_READS = {"item", "tolist", "numpy", "__bool__", "__int__",
                "__float__", "__index__", "__array__", "__complex__",
                "__iter__", "__reduce_ex__"}

_CONVERSIONS = {"float": torch.float32, "double": torch.float64,
                "half": torch.float16, "bfloat16": torch.bfloat16,
                "long": torch.int64, "int": torch.int32, "bool": torch.bool}


def _conversion_dtype(name, args, kwargs):
    """The dtype a conversion asks for (None: keep), or False when
    `name` is no conversion."""
    if name in _CONVERSIONS:
        return _CONVERSIONS[name]
    if name in ("contiguous", "cpu", "cuda", "detach"):
        return None
    if name in ("to", "type", "as_tensor"):
        dtype = kwargs.get("dtype")
        for a in args[1:]:
            if isinstance(a, torch.dtype):
                dtype = a
            elif isinstance(a, torch.Tensor) and name == "to":
                dtype = a.dtype
        return dtype
    return False


def _capture_torch(func, args, kwargs):
    flat = pytree.tree_leaves((args, kwargs))
    has_var = False
    for x in flat:
        if isinstance(x, torch.Tensor):
            if _var_of(x) is not None:
                has_var = True
                break
            if _is_meta(x):
                raise RuntimeError(
                    "static capture: a meta tensor that belongs to no "
                    f"Program reached {getattr(func, '__name__', func)}")
    if not has_var:
        # constant folding; a request for the meta device (a layer built
        # in static mode) computes the constant on the CPU
        if any(_is_meta_device(x) for x in flat):
            args, kwargs = pytree.tree_map(
                lambda x: _CPU if _is_meta_device(x) else x, (args, kwargs))
        return func(*args, **kwargs)
    name = getattr(func, "__name__", str(func))
    if name in _VALUE_READS:
        raise RuntimeError(
            f"Variable has no value at graph-build time ({name}); fetch it "
            "through Executor.run")
    conv = _conversion_dtype(name, args, kwargs)
    if conv is not False:
        x = args[0]
        if conv is None or conv == x.dtype:
            return x
        return _record("cast", lambda t, _d=conv: t.to(_d), (x,), {})
    if (name.endswith("_") and not name.endswith("__")) or \
            name.startswith("__i"):
        raise RuntimeError(
            f"static capture: in-place {name!r} on a Variable; record "
            "the write with static.nn.static_assign")
    op_type = _TORCH_OP_TYPES.get(name)
    if op_type is None:
        raise RuntimeError(
            f"static capture: torch function {name!r} met a Variable and "
            "has no Paddle op type to record it under; call the paddle "
            "op instead")
    return _record(op_type, func, args, kwargs)


class _CaptureMode(TorchFunctionMode):
    """Static capture of torch functions (module docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_tls, "off", 0) or func in _PASS:
            return func(*args, **kwargs)
        return _capture_torch(func, args, kwargs)


def _lookup_for_box(t):
    """core.tensor.box's hook: the Variable a plain meta alias stands
    for (at the outermost Layer call)."""
    return _var_of(t) if _is_meta(t) else None


_capture_state = {"mode": None, "place": None}


def _start_capture():
    mode = _CaptureMode()
    mode.__enter__()
    _capture_state["mode"] = mode
    _State.capture = _capture_op
    _tensor._static_lookup = _lookup_for_box
    _place._capture_device = _META


def _stop_capture():
    mode = _capture_state.pop("mode", None)
    _capture_state["mode"] = None
    if mode is not None:
        mode.__exit__(None, None, None)
    _State.capture = None
    _tensor._static_lookup = None
    _place._capture_device = None


# ------------------------------------------------------------- parameters
def create_parameter(shape, dtype, name=None, initializer=None,
                     trainable=True, regularizer=None, learning_rate=1.0,
                     need_clip=True, do_model_average=None):
    """A parameter Variable in the default main program with its init
    op in the startup program (reference: layer_helper_base.py
    create_parameter; paddle_tpu/static/program.py:337-378). The init
    op draws from the initializer when the startup program runs."""
    from ..nn import initializer as I
    main = default_main_program()
    startup = default_startup_program()
    dtype = _dt.convert_dtype(dtype) or _dt.get_default_dtype()
    name = name or main.unique_name("param")
    blk = main.global_block
    v = ParamVariable(shape, dtype, name, blk, persistable=True,
                      stop_gradient=not trainable)
    blk.vars[name] = v
    v.trainable = trainable
    v.optimize_attr = {"learning_rate": learning_rate}
    v.regularizer = regularizer
    v.need_clip = need_clip
    v.do_model_average = do_model_average
    init = initializer or I.XavierNormal()
    shape_t = [int(s) for s in shape]

    def init_fn(device, _init=init, _shape=shape_t, _dtype=dtype):
        val = _init(_shape, _dtype)
        return _tensor.plain(val).to(device)

    startup.global_block.append_op(
        OpDesc("init", "fill_parameter", init_fn, [], [name]))
    sv = startup.global_block.create_var(
        name=name, shape=shape, dtype=dtype, persistable=True)
    sv.is_parameter = True
    return v


def set_initial_value(var: Variable, value: torch.Tensor,
                      program: Program = None):
    """Make the startup program's init op of persistable `var` give
    `value` (a CPU tensor) instead of its initializer's draw: a model
    that draws its own weights from a seed (models/gpt.py) starts the
    same in static mode as eagerly."""
    program = program or default_startup_program()
    value = _tensor.plain(value).detach().clone()
    for od in program.global_block.ops:
        if od.kind == "init" and od.output_names == [var.name]:
            od.fn = lambda device, _v=value: _v.to(device)
            return
    raise ValueError(f"{var.name} has no init op in the startup program")


def install_capture_hook():
    """The JAX package's name for turning the capture on
    (enable_static calls it)."""
    _mode.enable_static()
