"""The core op corpus's names, op types and device rules, on the CPU.

- Every callable that paddle_tpu exports at its top level from the
  eight modules of the corpus (ops/{math, logic, search, manipulation,
  creation, linalg, random_ops, array_ops}.py) exists at
  paddle_tpu_torch's top level, but array_ops' two LoD functions.
- The port registers every op type those JAX modules register, so the
  AMP lists key off the same names.
- The eight modules copy device values to the host (.cpu(), .numpy(),
  .tolist(), .item()) only in the functions that
  paddle_tpu_torch.ops.HOST_READS names, each where the JAX op reads a
  host value itself; an AST scan holds them to that list.
"""
import ast
import importlib
from pathlib import Path

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.dispatch import get_op, registered_ops
from paddle_tpu_torch.core.dispatch import registered_ops as port_ops
from paddle_tpu_torch.ops import HOST_READS

SLICE = ("math", "logic", "search", "manipulation", "creation", "linalg",
         "random_ops", "array_ops")
WAITS = {"array_to_lod_tensor", "lod_tensor_to_array"}
HOST_CALLS = {"cpu", "numpy", "tolist", "item"}
_PORT = Path(paddle_tpu_torch.__file__).parent / "ops"


def test_top_level_has_every_slice_callable():
    mods = {f"paddle_tpu.ops.{m}" for m in SLICE}
    names = {n for n in dir(paddle_tpu) if not n.startswith("_")
             and callable(getattr(paddle_tpu, n))
             and getattr(getattr(paddle_tpu, n), "__module__", "") in mods}
    assert len(names) > 200, len(names)
    missing = sorted(n for n in names - WAITS
                     if not hasattr(paddle_tpu_torch, n))
    assert not missing, missing
    assert paddle_tpu_torch.linalg is paddle_tpu_torch.ops.linalg


def test_registered_ops_cover_the_slice_op_types():
    mods = {f"paddle_tpu.ops.{m}" for m in SLICE}
    want = {t for t in registered_ops()
            if get_op(t).raw_fn.__module__ in mods}
    assert len(want) > 150, len(want)
    missing = sorted(want - set(port_ops()))
    assert not missing, missing


def _host_reads(module):
    """(function, call) for every host-read call in the module, by the
    innermost function that contains it."""
    tree = ast.parse((_PORT / f"{module}.py").read_text())
    found = []

    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in HOST_CALLS:
            found.append((func, node.func.attr, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, func)
    visit(tree, None)
    return found


def test_host_reads_only_at_the_named_allowlist():
    seen = set()
    for module in SLICE:
        for func, call, line in _host_reads(module):
            assert (module, func) in HOST_READS, \
                f"ops/{module}.py:{line} {func}() calls .{call}()"
            seen.add((module, func))
    assert seen == set(HOST_READS), sorted(set(HOST_READS) - seen)


def test_no_op_falls_back():
    """No function of the eight modules catches an exception to run
    another implementation (a try in the op corpus is a fallback)."""
    for module in SLICE:
        tree = ast.parse((_PORT / f"{module}.py").read_text())
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, (module, tries)


def test_every_module_imports():
    for module in SLICE:
        importlib.import_module(f"paddle_tpu_torch.ops.{module}")


def test_small_names_of_ported_packages():
    """amp.amp_guard, amp.white_list / black_list and nn.weight_norm_hook
    exist as in the JAX package: the context, the reference's lists and
    the nn.utils module under its other name."""
    import paddle_tpu.amp as jamp
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch import amp, nn
    assert amp.amp_guard is amp.auto_cast
    assert set(amp.white_list) == set(jamp.white_list)
    assert set(amp.black_list) == set(jamp.black_list)
    assert nn.weight_norm_hook is nn.utils
    for name in ("weight_norm", "remove_weight_norm", "spectral_norm"):
        assert callable(getattr(jnn.weight_norm_hook, name)) and \
            callable(getattr(nn.weight_norm_hook, name)), name
