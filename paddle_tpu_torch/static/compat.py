"""paddle.static's long tail (port of paddle_tpu/static/compat.py):
name, scope and device guards, places, program state and persistables
serialization, per-variable save/load, and the ParallelExecutor and
WeightNormParamAttr shims; static/__init__.py re-exports the metric op
`accuracy` and `py_func` beside them.

cuda_places lists the visible CUDA devices (the JAX package lists its
accelerators). ParallelExecutor runs the ordinary Executor on the
first card, as the JAX package runs one program.

Left out: `auc` (the port has no batch-AUC op; paddle.metric.Auc
streams it); ParallelExecutor's strategies and trainer counts are
accepted and ignored.
"""
from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from ..nn.layer.base import ParamAttr
from .executor import Scope, global_scope, _swap_global_scope
from .program import default_main_program

__all__ = [
    "name_scope", "scope_guard", "device_guard", "cpu_places",
    "cuda_places", "xpu_places", "save_vars", "load_vars",
    "save_to_file", "load_from_file", "serialize_persistables",
    "deserialize_persistables", "load_program_state",
    "set_program_state", "ParallelExecutor", "WeightNormParamAttr",
]

_NAME_SCOPE: list = []
_DEVICE_SCOPE: list = []


@contextlib.contextmanager
def name_scope(prefix="my_scope"):
    """reference fluid/framework.py name_scope: a debug-name prefix
    (cosmetic there too)."""
    _NAME_SCOPE.append(str(prefix))
    try:
        yield "/".join(_NAME_SCOPE)
    finally:
        _NAME_SCOPE.pop()


def current_name_scope() -> str:
    return "/".join(_NAME_SCOPE)


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """reference fluid/executor.py scope_guard: swap the global Scope
    that Executor.run reads and writes persistables through."""
    old = _swap_global_scope(scope)
    try:
        yield
    finally:
        _swap_global_scope(old)


@contextlib.contextmanager
def device_guard(device=None):
    """reference fluid/framework.py device_guard: marks ops for a device
    (read by a pipeline planner; a one-device program ignores it)."""
    _DEVICE_SCOPE.append(device)
    try:
        yield
    finally:
        _DEVICE_SCOPE.pop()


def current_device_scope():
    return _DEVICE_SCOPE[-1] if _DEVICE_SCOPE else None


def cpu_places(device_count=None):
    """reference framework.py cpu_places: CPU_NUM (default 1) places."""
    from ..core.place import CPUPlace
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """The visible CUDA devices' places (reference cuda_places)."""
    from ..core.place import CUDAPlace
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


xpu_places = cuda_places


def _persistable_names(program):
    return [v.name for v in program.list_vars()
            if getattr(v, "persistable", False)]


def _host(value) -> np.ndarray:
    if torch.is_tensor(value):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


def load_program_state(model_path, var_list=None):
    """reference fluid/io.py load_program_state: a saved params file (or
    save_vars' per-variable directory) as {name: ndarray}."""
    path = model_path if os.path.exists(model_path) \
        else model_path + ".pdparams"
    if os.path.isdir(path):
        state = {}
        for fn in sorted(os.listdir(path)):
            fp = os.path.join(path, fn)
            if os.path.isfile(fp):
                with open(fp, "rb") as f:
                    state.update(pickle.load(f))
    else:
        with open(path, "rb") as f:
            state = pickle.load(f)
    if var_list is not None:
        names = {v if isinstance(v, str) else v.name for v in var_list}
        state = {k: v for k, v in state.items() if k in names}
    return {k: np.asarray(v) for k, v in state.items()}


def set_program_state(program, state_dict):
    """reference fluid/io.py set_program_state: ndarrays into the scope
    slots of the program's persistables (shape-checked)."""
    scope = global_scope()
    for name in _persistable_names(program):
        if name not in state_dict:
            continue
        arr = np.asarray(state_dict[name])
        cur = scope.find_var(name)
        if cur is not None and tuple(cur.shape) != arr.shape:
            raise ValueError(
                f"shape mismatch for {name}: program has "
                f"{tuple(cur.shape)}, state has {arr.shape}")
        scope.set(name, torch.from_numpy(np.array(arr, copy=True)))


def serialize_persistables(feed_vars, fetch_vars, executor=None,
                           program=None):
    """reference static/io.py serialize_persistables: the persistable
    values of the (default) main program as bytes."""
    program = program or default_main_program()
    scope = global_scope()
    state = {}
    for name in _persistable_names(program):
        v = scope.find_var(name)
        if v is not None:
            state[name] = _host(v)
    return pickle.dumps(state, protocol=2)


def deserialize_persistables(program, data, executor=None):
    """Inverse of serialize_persistables into the global scope."""
    set_program_state(program, pickle.loads(data))


def save_to_file(path, content):
    """reference static/io.py save_to_file (bytes to a file)."""
    if not isinstance(content, bytes):
        raise TypeError("save_to_file expects bytes content")
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def _selected(program, vars, predicate):
    if vars is not None:
        return vars
    return [v for v in program.list_vars()
            if getattr(v, "persistable", False)
            and (predicate is None or predicate(v))]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """reference fluid/io.py save_vars: chosen persistables under
    dirname, one file each, or all in one `filename`."""
    program = main_program or default_main_program()
    scope = global_scope()
    state = {}
    for v in _selected(program, vars, predicate):
        name = v if isinstance(v, str) else v.name
        val = scope.find_var(name)
        if val is None:
            raise ValueError(f"save_vars: {name} has no value in scope")
        state[name] = _host(val)
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        with open(os.path.join(dirname, filename), "wb") as f:
            pickle.dump(state, f, protocol=2)
    else:
        for name, arr in state.items():
            with open(os.path.join(dirname, name), "wb") as f:
                pickle.dump({name: arr}, f, protocol=2)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """reference fluid/io.py load_vars: save_vars' inverse."""
    program = main_program or default_main_program()
    vars = _selected(program, vars, predicate)
    scope = global_scope()
    if filename is not None:
        with open(os.path.join(dirname, filename), "rb") as f:
            state = pickle.load(f)
    else:
        state = {}
        for v in vars:
            name = v if isinstance(v, str) else v.name
            with open(os.path.join(dirname, name), "rb") as f:
                state.update(pickle.load(f))
    for v in vars:
        name = v if isinstance(v, str) else v.name
        if name not in state:
            raise ValueError(f"load_vars: {name} not found in {dirname}")
        scope.set(name, torch.from_numpy(np.array(state[name], copy=True)))


class WeightNormParamAttr(ParamAttr):
    """reference fluid/param_attr.py WeightNormParamAttr: a ParamAttr
    asking for weight normalisation along `dim`."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable,
                         need_clip=need_clip)
        self.dim = dim


class ParallelExecutor:
    """reference fluid/parallel_executor.py: keeps the construction API
    and runs the program through the ordinary Executor, on the first
    card with use_cuda, else on the CPU."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from ..core.place import CPUPlace, CUDAPlace
        from .executor import Executor
        self._program = main_program or default_main_program()
        self._exe = Executor(CUDAPlace(0) if use_cuda else CPUPlace())

    def run(self, fetch_list=None, feed=None, feed_dict=None,
            return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(self._program, feed=feed,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)
