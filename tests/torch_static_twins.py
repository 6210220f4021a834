"""Shared harness of the static-graph twin tests (tests/test_torch_static*.py,
test_torch_proto_io.py, test_torch_transpiler.py,
test_torch_rnn_shims.py): one scenario function runs on each package
in static mode, the JAX package first; the port's Scope takes the JAX
scope's values after each startup run, by name, so both programs run
from the same parameters.
"""
import contextlib

import numpy as np
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.nn.layer.layers import load_jax_scope


class Pkg:
    """One package as the scenarios see it: `p` is the package,
    `exe()` an Executor (the port's on the CPU), `startup(exe, prog)`
    runs a startup program and aligns the port's scope with the JAX
    one."""

    def __init__(self, mod, shared):
        self.p = mod
        self.static = mod.static
        self.port = mod is paddle_tpu_torch
        self._shared = shared

    def exe(self):
        if self.port:
            return self.static.Executor(paddle_tpu_torch.CPUPlace())
        return self.static.Executor()

    def startup(self, exe, program=None, scope=None):
        program = program or self.static.default_startup_program()
        scope = scope or self.static.global_scope()
        exe.run(program, scope=scope)
        names = [v.name for v in program.list_vars() if v.persistable]
        if not self.port:
            self._shared.update({n: np.asarray(scope.find_var(n))
                                 for n in names})
        else:
            load_jax_scope(scope, {n: self._shared[n] for n in names
                                   if n in self._shared})

    def value(self, name, scope=None):
        v = (scope or self.static.global_scope()).find_var(name)
        if torch.is_tensor(v):
            return v.detach().float().numpy() if v.dtype == torch.bfloat16 \
                else v.detach().numpy()
        return np.asarray(v)


@contextlib.contextmanager
def static_mode(mod, fresh=True):
    """The JAX tests' autouse fixture for one package: fresh default
    programs, an empty global scope and name counters, static mode."""
    static = mod.static
    main, startup = static.Program(), static.Program()
    static.global_scope().drop_kids()
    with mod.utils.unique_name.guard():
        mod.enable_static()
        try:
            with static.program_guard(main, startup):
                yield main, startup
        finally:
            mod.disable_static()


def run_both(scenario, *args, fresh_programs=True):
    """scenario(Pkg, *args) on the JAX package, then on the port; returns
    (jax result, port result). Both run without a global mesh (a test
    of the sharded paths may leave one set in the process: the JAX GPT
    would then shard its static program over the CPU devices)."""
    from paddle_tpu.parallel import mesh as jmesh
    from paddle_tpu_torch.parallel import mesh as tmesh
    shared = {}
    out = []
    prev = _place._default
    prev_meshes = jmesh.get_global_mesh(), tmesh._global_mesh
    jmesh.set_global_mesh(None)
    tmesh.set_global_mesh(None)
    paddle_tpu_torch.set_device("cpu")
    try:
        for mod in (paddle_tpu, paddle_tpu_torch):
            P = Pkg(mod, shared)
            if fresh_programs:
                with static_mode(mod):
                    out.append(scenario(P, *args))
            else:
                mod.static.global_scope().drop_kids()
                with mod.utils.unique_name.guard():
                    mod.enable_static()
                    try:
                        out.append(scenario(P, *args))
                    finally:
                        mod.disable_static()
    finally:
        _place._default = prev
        jmesh.set_global_mesh(prev_meshes[0])
        tmesh.set_global_mesh(prev_meshes[1])
    return tuple(out)


def assert_close(a, b, rtol=1e-5, atol=1e-6):
    """Results (arrays, floats, or lists / tuples / dicts of them) held
    equal to rtol / atol."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_close(a[k], b[k], rtol, atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_close(x, y, rtol, atol)
    else:
        np.testing.assert_allclose(np.asarray(b, dtype=np.float64),
                                   np.asarray(a, dtype=np.float64),
                                   rtol=rtol, atol=atol)
