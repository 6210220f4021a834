"""Static-graph Executor and Scope (port of paddle_tpu/static/
executor.py).

The JAX Executor traces a whole Program into one jitted function and
donates the persistables to it. The port replays the recorded ops
eagerly on its device, with PyTorch's kernels and the port's own
(K1 runs inside the `scaled_dot_product_attention` op):
- `Executor(place)`: CUDAPlace or None is the card, CPUPlace the CPU;
  with no GPU, None raises;
- the ops before a program's last backward op run once, on an autograd
  graph over the parameters (and the inputs gradients() asks for); a
  backward op is torch.autograd.grad on that graph; later ops
  (optimizer updates) run under no_grad;
- persistables are read from the Scope and written back to it; the
  optimizer ops update parameters and accumulators in place, so their
  device buffers are reused from step to step (the analogue of the JAX
  Executor's donated state);
- runtime scalars (a scheduled learning rate) are read at every run;
- the program analysis is cached per (program, version, feed shapes,
  fetches).

Left out: train_from_dataset and infer_from_dataset, which need the
native datafeed (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import place as _place
from ..core.tensor import Tensor, box, plain
from ..core.unported import not_ported
from .program import (OpDesc, Program, _inert, _paused,
                      default_main_program)

__all__ = ["Scope", "global_scope", "Executor"]


class Scope:
    """name -> tensor storage of the persistables (reference:
    framework/scope.h)."""

    def __init__(self):
        self._vars: Dict[str, torch.Tensor] = {}

    def var(self, name):
        return self._vars.setdefault(name, None)

    def find_var(self, name):
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value

    def keys(self):
        return self._vars.keys()

    def drop_kids(self):
        self._vars.clear()


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def _swap_global_scope(scope: Scope) -> Scope:
    """Install `scope` as the global scope and return the previous one
    (static.scope_guard)."""
    global _global_scope
    old = _global_scope
    _global_scope = scope
    return old


def _as_tensor(value, device) -> torch.Tensor:
    if torch.is_tensor(value):
        t = plain(value).detach()
    else:
        t = torch.from_numpy(np.array(np.asarray(value), copy=True))
    return t.to(device)


def _interpret(ops: List[OpDesc], env: Dict[str, object], device,
               stop=(), grad=None):
    """Run the op list over the environment (module docstring): the ops
    before the last backward op with autograd on, the rest without; or,
    with `grad` given (a control-flow op's sub-program, static/nn.py),
    every op in that grad mode, so the outer program's backward reaches
    through it."""
    last_bw = max((i for i, od in enumerate(ops) if od.kind == "backward"),
                  default=-1)
    wrt = set()
    for od in ops:
        if od.kind == "backward":
            wrt.update(od.payload[2] if od.payload[0] == "vjp"
                       else od.payload[1])
            if od.payload[0] == "vjp":
                stop = set(stop) | set(od.payload[4])
    wrt -= set(stop)
    for n in wrt:
        t = env.get(n)
        if torch.is_tensor(t) and (t.is_floating_point() or t.is_complex()):
            env[n] = t.detach().requires_grad_(True)
    for n in stop:
        if torch.is_tensor(env.get(n)):
            env[n] = env[n].detach()
    for i, od in enumerate(ops):
        with torch.set_grad_enabled(i < last_bw if grad is None else grad):
            if od.kind == "init":
                env[od.output_names[0]] = od.fn(device)
            elif od.kind == "backward":
                _backward(od, env, retain=i < last_bw)
            else:
                out = od.fn(*[env[n] for n in od.input_names])
                outs = [o for o in pytree.tree_leaves(out)
                        if isinstance(o, torch.Tensor)]
                for n, v in zip(od.output_names, outs):
                    if n in stop:
                        v = v.detach()
                    elif n in wrt and not v.requires_grad and \
                            v.is_floating_point():
                        v = v.detach().requires_grad_(True)
                    env[n] = v
    return env


def _grads(outs, ins, cots, retain):
    pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    if not pairs:
        return [torch.zeros_like(x) for x in ins]
    got = torch.autograd.grad([o for o, _ in pairs], ins,
                              [c for _, c in pairs], retain_graph=retain,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, ins)]


def _backward(od: OpDesc, env, retain: bool):
    if od.payload[0] == "vjp":
        # gradients(): several, possibly non-scalar targets with
        # optional cotangents (reference backward.py calc_gradient)
        _, tnames, inames, tg_names, _stop = od.payload
        outs = [env[t] for t in tnames]
        cots = [env[tg] if tg is not None else torch.ones_like(o)
                for tg, o in zip(tg_names, outs)]
        grads = _grads(outs, [env[n] for n in inames], cots, retain)
    else:
        loss_name, pnames = od.payload
        loss = env[loss_name]
        if loss.ndim != 0:
            raise ValueError(
                f"append_backward loss '{loss_name}' must be a scalar, got "
                f"shape {tuple(loss.shape)} (reference: backward.py "
                "append_backward, same requirement)")
        grads = _grads([loss], [env[p] for p in pnames],
                       [torch.ones_like(loss)], retain)
    for n, g in zip(od.output_names, grads):
        env[n] = g


def _analyze_program(program: Program):
    """(persistable reads, persistable writes, feed names needed). A
    persistable read is one consumed before the program produces it."""
    persistable = {name for name, v in program.global_block.vars.items()
                   if v.persistable}
    produced = set(program._consts)
    reads, writes, feeds = [], [], []
    for od in program.ops:
        for n in od.input_names:
            if n in produced:
                continue
            if n in persistable:
                if n not in reads:
                    reads.append(n)
                produced.add(n)
            elif n in program._runtime_scalars:
                produced.add(n)
            else:
                v = program.global_block.vars.get(n)
                if v is not None and v.is_data and n not in feeds:
                    feeds.append(n)
                    produced.add(n)
        if od.kind == "backward":
            pnames = od.payload[2] if od.payload[0] == "vjp" \
                else od.payload[1]
            for p in pnames:
                if p in persistable and p not in reads and p not in writes:
                    reads.append(p)
        for n in od.output_names:
            produced.add(n)
            if n in persistable and n not in writes:
                writes.append(n)
    return reads, writes, feeds


class Executor:
    """reference: executor.py Executor. `place`: CUDAPlace (or None)
    runs the program on the card, CPUPlace on the CPU."""

    def __init__(self, place=None):
        self.place = place
        self._cache = {}
        self._consts = {}

    def close(self):
        self._cache.clear()
        self._consts.clear()

    @property
    def device(self) -> torch.device:
        # never resolve None: in static mode that is the meta device
        return _place.resolve_device(
            "cuda" if self.place is None else self.place)

    def _device_consts(self, program: Program, device):
        # the cache holds the program, so its id is not reused meanwhile
        key = (id(program), len(program._consts), str(device))
        got = self._consts.get(key)
        if got is None:
            got = self._consts[key] = (program, {
                k: v.to(device) for k, v in program._consts.items()})
        return got[1]

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, scope=None, return_numpy: bool = True,
            **kwargs):
        """reference: executor.py run (feed dict in, fetched ndarrays
        out; Tensors with return_numpy=False)."""
        from ..distributed.transpiler import (_PServerProgram,
                                              _TrainerProgram)
        if isinstance(program, _PServerProgram):
            # reference: exe.run(pserver_program) is listen_and_serv
            return program.serve(block=True)
        if isinstance(program, _TrainerProgram):
            return program.run_step(self, feed, fetch_list,
                                    scope or global_scope())
        program = program if program is not None else default_main_program()
        program = getattr(program, "_program_for_executor", program)
        scope = scope or global_scope()
        device = self.device
        feed = feed or {}
        fetch_names = [f.name if isinstance(f, Tensor) else str(f)
                       for f in fetch_list or []]

        feeds = {k: _as_tensor(v, device) for k, v in feed.items()}
        # py_reader (static/rnn_shims.py): once started it supplies the
        # feeds the dict lacks; EOFError propagates at exhaustion
        for reader in getattr(program, "_py_readers", []):
            if reader._q is not None and any(
                    n not in feeds for n in reader.names):
                for k, v in reader.next_feed().items():
                    feeds.setdefault(k, _as_tensor(v, device))
        key = (id(program), program._version,
               tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in feeds.items())),
               tuple(fetch_names))
        plan = self._cache.get(key)
        if plan is None:
            plan = self._cache[key] = (program, _analyze_program(program))
        reads, writes, feed_needed = plan[1]

        lacking = [n for n in feed_needed if n not in feeds]
        if lacking:
            raise ValueError(
                f"feed is missing required data variables {lacking} "
                "(reference: executor.py feed check)")
        missing = [n for n in reads if scope.find_var(n) is None]
        if missing:
            raise RuntimeError(
                f"Variables {missing} are not initialized; run the startup "
                "program first: exe.run(paddle.static.default_startup_"
                "program()) (reference: executor.py var-init check)")

        env = dict(self._device_consts(program, device))
        for k in reads:
            v = scope.find_var(k)
            if not torch.is_tensor(v) or v.device != device:
                v = _as_tensor(v, device)
                scope.set(k, v)
            env[k] = v
        env.update({k: fn() for k, fn in program._runtime_scalars.items()})
        env.update(feeds)
        with _paused(), _inert():
            _interpret(program.ops, env, device)
        for k in writes:
            scope.set(k, env[k].detach())
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [_numpy(v) for v in fetches]
        return [box(v.detach()) for v in fetches]

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        not_ported("Executor.train_from_dataset (it reads the native "
                   "datafeed)", "ROADMAP Queue 1 item 8")

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        not_ported("Executor.infer_from_dataset (it reads the native "
                   "datafeed)", "ROADMAP Queue 1 item 8")


def _numpy(v) -> np.ndarray:
    v = plain(v).detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.cpu().numpy()
