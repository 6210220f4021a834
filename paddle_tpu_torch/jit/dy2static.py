"""dygraph_to_static AST transformation (port of
paddle_tpu/jit/dy2static.py).

Reference: python/paddle/fluid/dygraph/dygraph_to_static/ (~25
transformer files: ifelse_transformer.py rewrites `if` on tensors into
cond(...) with true/false closures over the assigned names;
loop_transformer.py rewrites `while` into while_loop with an explicit
loop-vars tuple; convert_operators.py picks Python control flow when
the predicate is a concrete bool and the op form when it is a
Variable).

The same two layers as the JAX package's, the AST part unchanged:
- Compile time: `convert_to_static(fn)` rewrites the function's AST:
  `if` / `while` statements become calls to the runtime converters
  below, with generated branch / body functions over the names each
  branch assigns and reads.
- Run time: `convert_ifelse` / `convert_while` inspect the predicate.
  A concrete Tensor or Python bool runs real Python control flow (the
  eager semantics, on the device the tensors are on); a static Variable
  while a capture runs (the JAX package's jax Tracer) lowers through
  ops.control_flow.cond / while_loop to the "conditional_block" and
  "while" ops of the Program being captured.

An `if` that assigns a name in one branch only leaves `_UNDEF` in it
when the other branch runs; using it raises UnboundLocalError, and
jit.StaticFunction raises the same when `_UNDEF` would be returned.

Scope (the reference's core transformer set): `if`/`if-else` and `while`
with tensor predicates, free of break/continue/return-in-branch.
Anything else is left untouched and runs as written; closures, other
decorators and functions without source (with a warning) come back
unchanged.

Left out: nothing of the JAX module.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
from typing import Callable, List, Set

import torch

from ..core.tensor import plain

__all__ = ["convert_to_static", "convert_ifelse", "convert_while"]


class _Undef:
    """Loud sentinel: a name assigned in only the untaken branch must fail
    on USE like dygraph's UnboundLocalError would — not flow silently."""

    def __repr__(self):
        return "<undefined>"

    def _boom(self, *a, **k):
        raise UnboundLocalError(
            "variable assigned only in an untaken to_static branch was "
            "used (dygraph would raise UnboundLocalError here too)")

    __bool__ = __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = _boom
    __rmul__ = __truediv__ = __call__ = __iter__ = __len__ = _boom
    __getitem__ = __lt__ = __le__ = __gt__ = __ge__ = _boom

    def __getattr__(self, name):
        self._boom()


_UNDEF = _Undef()


# paddle.jit.set_code_level stores the level here; non-None prints
# each transformed function's source at conversion time
CODE_LEVEL = None

def _is_traced(x) -> bool:
    """A static Variable (or its alias) while a capture runs: the JAX
    package's jax Tracer."""
    from ..static import program as _prog
    return (isinstance(x, torch.Tensor) and _prog._capturing()
            and _prog._var_of(x) is not None)


def _as_bool(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(plain(x).detach().reshape(()).item())
    return bool(x)


# ------------------------------------------------------------ runtime layer
def convert_ifelse(pred, true_fn, false_fn, names: List[str], cur_vals):
    """reference: convert_operators.convert_ifelse. Branch fns take the
    pre-statement values of `names` (assigned AND read names) as
    parameters; under capture their tensors become explicit cond operands,
    so gradients reach every tensor the branches touch (the reference's
    conditional_block registers its inputs the same way)."""
    if not _is_traced(pred):
        return true_fn(*cur_vals) if _as_bool(pred) else false_fn(*cur_vals)
    from ..ops import control_flow as cf
    t_idx = [i for i, v in enumerate(cur_vals)
             if isinstance(v, torch.Tensor)]
    t_vals = [cur_vals[i] for i in t_idx]

    def mk(branch):
        def g(*tensors):
            full = list(cur_vals)
            for i, t in zip(t_idx, tensors):
                full[i] = t
            return branch(*full)
        return g

    try:
        return cf.cond(pred, mk(true_fn), mk(false_fn), operands=t_vals)
    except (NameError, TypeError) as e:
        undef = [n for n, v in zip(names, cur_vals) if v is _UNDEF]
        if undef:
            raise ValueError(
                f"to_static if-else on a traced predicate: variables "
                f"{undef} must be defined before the `if` or assigned in "
                "BOTH branches (reference ifelse_transformer "
                "constraint).") from e
        raise


def convert_while(test_fn, body_fn, names: List[str], cur_vals):
    """reference: convert_operators.convert_while_loop.

    On the captured ("while" op) path, loop CARRIES are the assigned
    names already defined before the loop; names first assigned inside the
    body are body-local temporaries (the reference's loop_transformer makes
    the same live-in/live-out split) — they don't survive the loop. On the
    EAGER path all body-assigned names keep their last-iteration value,
    matching plain-Python/dygraph semantics."""
    vals = list(cur_vals)
    carry_idx = [i for i, v in enumerate(vals) if v is not _UNDEF]

    def rebuild(carry):
        full = list(vals)
        for i, v in zip(carry_idx, carry):
            full[i] = v
        return full

    def test2(*carry):
        return test_fn(*rebuild(carry))

    def body2(*carry):
        out = body_fn(*rebuild(carry))
        return [out[i] for i in carry_idx]

    carry = [vals[i] for i in carry_idx]
    probe = test2(*carry)
    if not _is_traced(probe) and not any(
            _is_traced(v) for v in carry):
        while _as_bool(test_fn(*vals)):
            vals = list(body_fn(*vals))
        return tuple(vals)
    from ..ops import control_flow as cf
    out = cf.while_loop(test2, lambda *a: list(body2(*a)), carry)
    return tuple(rebuild(out))


# ------------------------------------------------------- compile-time layer
class _AssignCollector(ast.NodeVisitor):
    def __init__(self):
        self.names: Set[str] = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.names.add(node.id)

    def visit_FunctionDef(self, node):
        self.names.add(node.name)  # a nested def binds its name; stop there

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


def _assigned_names(nodes) -> Set[str]:
    c = _AssignCollector()
    for n in nodes:
        c.visit(n)
    return c.names


class _LoadCollector(ast.NodeVisitor):
    def __init__(self):
        self.names: Set[str] = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.names.add(node.id)


def _loaded_names(nodes) -> Set[str]:
    c = _LoadCollector()
    for n in nodes:
        c.visit(n)
    return c.names


def _getter_def(uid: int, names: List[str]) -> str:
    """A nested function reading the current values of `names` from the
    enclosing scope, mapping unbound → _UNDEF."""
    lines = [f"def __jst_vals_{uid}():"]
    for i, n in enumerate(names):
        lines += [f"    try:",
                  f"        __v{i} = {n}",
                  f"    except (NameError, UnboundLocalError):",
                  f"        __v{i} = __jst_undef"]
    tup = ", ".join(f"__v{i}" for i in range(len(names)))
    lines.append(f"    return ({tup},)")
    return "\n".join(lines)


class _CtrlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self.counter = 0

    def _bails(self, nodes) -> bool:
        """Escape statements at THIS statement level (a Return inside a
        nested def — including ones a previous rewrite generated — does
        not escape the enclosing if/while)."""
        def walk_same_scope(n):
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return
            for child in ast.iter_child_nodes(n):
                yield from walk_same_scope(child)

        for n in nodes:
            for sub in walk_same_scope(n):
                if isinstance(sub, (ast.Break, ast.Continue, ast.Return,
                                    ast.Yield, ast.YieldFrom, ast.Global,
                                    ast.Nonlocal)):
                    return True
        return False

    def visit_If(self, node: ast.If):
        self.generic_visit(node)
        if self._bails(node.body) or self._bails(node.orelse):
            return node
        assigned = sorted(n for n in (_assigned_names(node.body)
                                      | _assigned_names(node.orelse))
                          if not n.startswith("__"))
        if not assigned:
            return node
        # read names become branch parameters too: their tensors ride the
        # cond as operands so gradients flow (convert_ifelse)
        loads = sorted(n for n in (_loaded_names(node.body)
                                   | _loaded_names(node.orelse))
                       if not n.startswith("__") and n not in assigned)
        names = assigned + loads
        self.counter += 1
        uid = self.counter
        tup = ", ".join(names)
        out_tup = ", ".join(assigned)
        tmpl = "\n".join([
            _getter_def(uid, names),
            f"def __jst_true_{uid}({tup}):",
            f"    pass",
            f"def __jst_false_{uid}({tup}):",
            f"    pass",
            f"({out_tup},) = __jst_ifelse(__jst_pred_{uid}, "
            f"__jst_true_{uid}, __jst_false_{uid}, {names!r}, "
            f"__jst_vals_{uid}())",
        ])
        new = ast.parse(tmpl).body
        ret = ast.parse(f"return ({out_tup},)").body[0]
        new[1].body = (node.body or [ast.Pass()]) + [ret]
        new[2].body = (node.orelse or [ast.Pass()]) + [ret]
        # bind the predicate once, before the branches
        pred_assign = ast.parse(f"__jst_pred_{uid} = 0").body[0]
        pred_assign.value = node.test
        out = [pred_assign] + new
        return [ast.fix_missing_locations(ast.copy_location(n, node))
                for n in out]

    def visit_While(self, node: ast.While):
        self.generic_visit(node)
        if self._bails(node.body) or node.orelse:
            return node
        names = sorted(n for n in _assigned_names(node.body)
                       if not n.startswith("__"))
        if not names:
            return node
        self.counter += 1
        uid = self.counter
        tup = ", ".join(names)
        tmpl = "\n".join([
            _getter_def(uid, names),
            f"def __jst_test_{uid}({tup}):",
            f"    pass",
            f"def __jst_body_{uid}({tup}):",
            f"    pass",
            f"({tup},) = __jst_while(__jst_test_{uid}, __jst_body_{uid}, "
            f"{names!r}, __jst_vals_{uid}())",
        ])
        new = ast.parse(tmpl).body
        new[1].body = [ast.Return(value=node.test)]
        ret = ast.parse(f"return ({tup},)").body[0]
        new[2].body = node.body + [ret]
        return [ast.fix_missing_locations(ast.copy_location(n, node))
                for n in new]


def convert_to_static(fn: Callable) -> Callable:
    """AST-rewrite `fn` (reference: ProgramTranslator → DygraphToStaticAst).
    Returns fn unchanged when no rewrite applies or the source is
    unavailable: it then runs as written."""
    bound_self = None
    if inspect.ismethod(fn):
        bound_self = fn.__self__
        fn = fn.__func__
    if getattr(fn, "_not_to_static", False) or fn.__closure__:
        return fn if bound_self is None else fn.__get__(bound_self)
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError) as e:
        import warnings
        warnings.warn(
            f"to_static: source for {getattr(fn, '__qualname__', fn)} is "
            f"unavailable ({type(e).__name__}); python if/while on tensors "
            "will run as written instead of being converted to static "
            "control flow (REPL/exec-defined functions hit this — "
            "define the function in a file to enable conversion)",
            stacklevel=3)
        return fn if bound_self is None else fn.__get__(bound_self)
    func_def = tree.body[0]
    if not isinstance(func_def, ast.FunctionDef):
        return fn if bound_self is None else fn.__get__(bound_self)
    # Only to_static-ish decorators can be safely dropped from the
    # recompiled source. Anything else would either RE-EXECUTE at
    # conversion time (duplicate side effects) or change semantics
    # (@staticmethod): bail, so the original decorated function stays
    # intact.
    others = [d for d in func_def.decorator_list
              if "to_static" not in ast.unparse(d)]
    if others:
        return fn if bound_self is None else fn.__get__(bound_self)
    func_def.decorator_list = []
    tr = _CtrlFlowTransformer()
    new_tree = tr.visit(tree)
    if tr.counter == 0:
        return fn if bound_self is None else fn.__get__(bound_self)
    ast.fix_missing_locations(new_tree)
    if CODE_LEVEL is not None:
        # paddle.jit.set_code_level: print the transformed source
        # (reference dygraph_to_static logging_utils.set_code_level)
        print(f"--- to_static transformed code for {fn.__qualname__} "
              f"(code level {CODE_LEVEL}) ---")
        print(ast.unparse(new_tree))
    try:
        code = compile(new_tree, f"<to_static {fn.__name__}>", "exec")
    except (SyntaxError, ValueError):
        return fn if bound_self is None else fn.__get__(bound_self)
    # exec against the LIVE module globals (a snapshot would miss helpers
    # defined after decoration / monkeypatches); the injected names use the
    # reserved __jst_ prefix
    glb = fn.__globals__
    glb["__jst_ifelse"] = convert_ifelse
    glb["__jst_while"] = convert_while
    glb["__jst_undef"] = _UNDEF
    loc: dict = {}
    exec(code, glb, loc)
    out = loc[func_def.name]
    out.__defaults__ = fn.__defaults__
    out.__kwdefaults__ = fn.__kwdefaults__
    functools.update_wrapper(out, fn)
    if bound_self is not None:
        return out.__get__(bound_self)
    return out
