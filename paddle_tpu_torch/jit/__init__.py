"""paddle.jit (port of paddle_tpu/jit/__init__.py): to_static,
save / load, TracedLayer, TrainStep, MultiStepTrainStep and InputSpec
(:36, which paddle.static re-exports).

to_static (function or Layer; a Layer gets its `forward` replaced by
the StaticFunction and `_static_function` set, :210-227). The JAX
package's to_static exists to compile: jax.jit with a cache per input
signature. PyTorch runs eagerly, so a StaticFunction call runs the
dy2static-converted function (jit/dy2static.py) eagerly on the tensors'
device: its outputs keep autograd (`loss.backward()` and
`paddle.grad(create_graph=True)` inside work, and gradients reach the
layer's parameters, where the JAX StaticFunction calls its compiled
function outside the eager tape and leaves `weight.grad` None), and
buffers update in place. A graph is captured where a graph is the
product: `concrete_program(*args)` captures a static Program
(static/program.py) with the Layer's parameters and buffers bound as
persistable Variables over their live tensors, in place of the JAX
package's HLO text; and a to_static function called under
static.program_guard records into that program. There the converters
lower a Variable predicate to the "conditional_block" / "while" ops.
ProgramTranslator().enable(False) (enable_to_static(False)) runs the
raw function.

save / load / TranslatedLayer (:230-333): the forward exported with
torch.export, with the state as inputs (torch.func.functional_call),
as the JAX artifact calls `exported.call(state, *arrays)`. A dim of the
input spec given as -1 / None is a torch.export.Dim, shared by position
across the inputs ("b" for dim 0, "d<j>" beyond) and exported at
example size 2 (torch.export specialises a dim whose example is 0 or
1); if that export fails, the dims are pinned to 1 with the JAX code's
warning. The layer is exported in eval() and put back in its mode.
`<path>.pdmodel` is the exported graph (without its example inputs)
and `<path>.pdiparams` the pickled {"params", "buffers"} of numpy
arrays (bfloat16 as float32, with each entry's dtype under "dtypes")
and the "device" it was exported on; load runs it there. The port's
kernels reach the graph as registered custom ops (K1, K2), each one
node. The port reads its own artifacts only. TranslatedLayer runs the
artifact under no_grad (an inference artifact).

TracedLayer (:694-726): trace(layer, inputs) returns (outputs, traced);
its save_inference_model goes through save, warning when feed / fetch
are given, as the JAX code does.

One TrainStep call runs the forward and the backward (torch autograd over the
model's trainable parameters), clips the gradients with the optimizer's
grad_clip (over the gradients in sorted-name order, as the JAX step
does), applies the optimizer's update in place (clip and update inside
an `optimizer` profiler range, which tools/train_bench.py --profile
reads), bumps
`optimizer._global_step` and returns the loss (detached, on the model's
device).

Buffers (BN running stats) are updated in place by the model's own
training-mode forward, where the JAX step threads them through the
compiled program and writes them back. The JAX step compiles all of
that into one XLA program with donated buffers. PyTorch runs eagerly, so
there is nothing to compile and donation means nothing. The jaxplan
hooks are not ported yet.

The trained parameters are those with `trainable` set and
`stop_gradient` clear (paddle_tpu/jit/__init__.py:509); the rest stay
as they are. The set is read once, at the first call; after freezing or
unfreezing a parameter, `invalidate()` makes the next call read it
again (the optimizer state of parameters that left the set is
dropped, as in the reference). The step keeps its optimizer state in
the optimizer's own accumulators (one per parameter, made on first
use), where the JAX TrainStep holds a pytree of its own: so
`optimizer.state_dict()`, `Model.save` and AutoCheckpointManager carry
the moments a TrainStep has built, and `set_state_dict` restores them
into it. `donate` is accepted and ignored: eager
PyTorch updates the parameters in place and has no buffers to donate.
The loss comes back as a Tensor; with `return_outputs=True` the call
returns (loss, outputs), outputs being loss_fn's whole result as
detached Tensors (paddle_tpu/jit/__init__.py:620), which hapi's
`train_batch` reads its predictions from.

`anomaly_guard` (a core.anomaly.AnomalyGuard) checks the loss and the
gradients for NaN/Inf on the device, one flag for the step, and applies
its policy there (core/anomaly.py): 'zero_grads' sanitizes the
gradients before clipping; 'skip_step' copies the trained parameters,
the optimizer state and the buffers before the forward and restores
them through `torch.where` on the flag after the update, so a skipped
step leaves them bitwise as they were (the copies cost one read and two
writes of that state a step, only under this policy); 'raise' applies
the update as the JAX step does. One host read of the flag per step
then feeds `guard.record` (which raises under 'raise') and the
`train_anomaly_skips_total` counter, the one read the JAX step makes.

Telemetry as in the JAX step (paddle_tpu/jit/__init__.py:589-620):
`train_step_seconds` observes the interval between consecutive calls
(launches are asynchronous, so the cadence converges on the device's
step time with no added sync; the first call only arms the clock),
`train_tokens_total` and `train_tokens_per_sec` count the batch's
tokens (the first integer argument of rank >= 2, else the first two
dims of the first rank >= 2 argument), and
`train_measured_vs_roofline` divides by a published roofline.

MultiStepTrainStep (port of :630-691) runs K such steps per call over
batches stacked [K, ...] and returns the [K] losses. The JAX class scans
the K steps inside one compiled program; here they are a plain loop of
TrainStep's body (a CUDA graph of the loop is not ported yet).

Usage:
    step = TrainStep(model, loss_fn, optimizer)
    loss = step(x, y)   # loss_fn(model, x, y) -> scalar (or a tuple
                        # whose first element is the loss)
    multi = MultiStepTrainStep(model, loss_fn, optimizer, steps=K)
    losses = multi(xs, ys)   # xs, ys stacked [K, ...] -> [K] losses

Left out: to_static's per-signature compile cache and Python-scalar
specialisation (nothing is compiled), the jaxplan hooks of TrainStep,
gradients through a TranslatedLayer (it runs under no_grad), and an
export of a data-dependent `if` / `while` (torch.export needs
torch.cond; the JAX export likewise needs lax control flow).
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import os
import pickle
import time
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.anomaly import _leaves, sanitize_tree, tree_not_finite
from ..core.dtypes import convert_dtype
from ..core.tensor import box, plain, plain_dispatch
from ..nn.layer.layers import Layer

__all__ = ["InputSpec", "StaticFunction", "to_static", "TranslatedLayer",
           "save", "load", "not_to_static", "ProgramTranslator",
           "enable_to_static", "TrainStep", "MultiStepTrainStep",
           "TracedLayer", "set_code_level", "set_verbosity"]


class InputSpec:
    """reference: python/paddle/static/input.py InputSpec (the JAX
    package's, paddle_tpu/jit/__init__.py:36): a feed's shape, dtype
    and name."""

    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = list(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, " \
               f"name={self.name})"


def _check_defined(out):
    """Raise as dygraph would where a name that only an untaken branch
    assigned (dy2static's _UNDEF) is returned."""
    from .dy2static import _UNDEF
    for leaf in pytree.tree_leaves(out):
        if leaf is _UNDEF:
            raise UnboundLocalError(
                "to_static: a variable assigned only in an untaken branch "
                "is returned (dygraph would raise UnboundLocalError)")


def _arg_names(fn, n: int):
    """Names for n positional inputs: fn's parameter names, else x<i>."""
    try:
        params = [p.name for p in inspect.signature(fn).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    except (TypeError, ValueError):
        params = []
    return [params[i] if i < len(params) else f"x{i}" for i in range(n)]


@contextlib.contextmanager
def _state_as_variables(layer, main, startup):
    """Bind the layer's parameters and buffers as persistable Variables
    of `main` (named as the parameters, the buffers by their path),
    each with an init op in `startup` that reads the live tensor, for
    the length of the block; the tensors come back after it."""
    from ..static.program import OpDesc, ParamVariable
    if layer is None:
        yield
        return
    swapped = []
    made = {}
    blk = main.global_block
    for mod_name, mod in layer.named_modules():
        for slot, store, kind in (
                [(k, mod._parameters, "p") for k in mod._parameters]
                + [(k, mod._buffers, "b") for k in mod._buffers]):
            t = store[slot]
            if t is None:
                continue
            v = made.get(id(t))
            if v is None:
                full = f"{mod_name}.{slot}" if mod_name else slot
                name = getattr(t, "name", None) if kind == "p" else None
                name = name or full
                if kind == "p":
                    v = ParamVariable(t.shape, t.dtype, name, blk,
                                      stop_gradient=not t.requires_grad)
                    v.trainable = getattr(t, "trainable", True)
                    blk.vars[name] = v
                else:
                    v = blk.create_var(name=name, shape=tuple(t.shape),
                                       dtype=t.dtype, persistable=True)
                startup.global_block.create_var(
                    name=name, shape=tuple(t.shape), dtype=t.dtype,
                    persistable=True)
                startup.global_block.append_op(OpDesc(
                    "init", "fill_parameter" if kind == "p" else
                    "fill_buffer",
                    lambda device, _t=t: plain(_t).detach().to(device),
                    [], [name]))
                made[id(t)] = v
            swapped.append((store, slot, t))
            store[slot] = v
    try:
        yield
    finally:
        for store, slot, t in swapped:
            store[slot] = t


class StaticFunction:
    """The to_static wrapper (reference: program_translator.StaticFunction;
    paddle_tpu/jit/__init__.py:141-207): the dy2static-converted
    function run eagerly (module docstring)."""

    def __init__(self, fn, layer=None, input_spec=None):
        from .dy2static import convert_to_static
        self._converted = convert_to_static(fn)
        self._input_spec = input_spec
        self._raw_fn = fn
        self._layer = layer
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        if not ProgramTranslator.get_instance().enabled:
            return self._raw_fn(*args, **kwargs)  # dygraph fallback
        out = self._converted(*args, **kwargs)
        _check_defined(out)
        return out

    @property
    def forward_fn(self):
        return self._raw_fn

    def concrete_program(self, *args):
        """The function captured as a static Program over its inputs (the
        JAX package returns the lowered HLO text): a Tensor or an
        InputSpec argument becomes a `static.data` Variable named as the
        function's parameter (the spec's name if it has one), anything
        else is passed as it is. The Layer's parameters and buffers are
        persistable Variables; the program's `startup_program` fills them
        from the live tensors, `inputs` holds the data Variables and
        `outputs` the function's result."""
        from ..static import mode, program as P
        main, startup = P.Program(), P.Program()
        names = _arg_names(self._raw_fn, len(args))
        was_static = mode.in_static_mode()
        with P.program_guard(main, startup):
            mode.enable_static()
            try:
                inputs = []
                for name, a in zip(names, args):
                    if isinstance(a, InputSpec):
                        a = P.data(a.name or name, a.shape, a.dtype)
                    elif torch.is_tensor(a):
                        a = P.data(name, list(a.shape), a.dtype)
                    inputs.append(a)
                with _state_as_variables(self._layer, main, startup):
                    out = self._converted(*inputs)
            finally:
                if not was_static:
                    mode.disable_static()
        _check_defined(out)
        main.startup_program = startup
        main.inputs = [a for a in inputs if isinstance(a, P.Variable)]
        main.outputs = out
        return main


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """paddle.jit.to_static, as a decorator or a call, on a function or a
    Layer (module docstring; paddle_tpu/jit/__init__.py:210-227)."""
    def decorate(fn):
        if isinstance(fn, Layer):
            layer = fn
            static = StaticFunction(layer.forward, layer, input_spec)
            layer.forward = static
            layer._static_function = static
            return layer
        # plain function (may still close over layers)
        return StaticFunction(fn, None, input_spec)
    if function is not None:
        return decorate(function)
    return decorate


class TranslatedLayer(Layer):
    """A loaded jit.save artifact (reference: fluid/dygraph/io.py
    TranslatedLayer): its exported program and state, on the device it
    was exported on."""

    def __init__(self, exported, state):
        super().__init__()
        self._exported = exported
        self._module = exported.module()
        self._state = state
        self._device = next(iter(state["params"].values())).device \
            if state["params"] else None

    def forward(self, *args):
        arrs = []
        for a in args:
            t = plain(a) if torch.is_tensor(a) else \
                torch.from_numpy(np.array(np.asarray(a), copy=True))
            arrs.append(t if self._device is None else t.to(self._device))
        with torch.no_grad():
            return self._module(self._state["params"],
                                self._state["buffers"], *arrs)


class _StateCall(torch.nn.Module):
    """The layer's forward over (params, buffers, *inputs): what save
    exports. The layer is no submodule of it, so its tensors enter the
    graph as inputs and not as the program's own state."""

    def __init__(self, layer):
        super().__init__()
        self.__dict__["_layer"] = layer

    def forward(self, params, buffers, *args):
        return torch.func.functional_call(self._layer, (params, buffers),
                                          args)


def _spec_dims(input_spec):
    """Per input, {dim: torch.export.Dim} for its -1 / None dims, one Dim
    per position across the inputs ("b" for dim 0, "d<j>" beyond)."""
    dims, out = {}, []
    for sp in input_spec:
        d = {}
        for j, n in enumerate(sp.shape):
            if n in (-1, None):
                name = "b" if j == 0 else f"d{j}"
                if name not in dims:
                    dims[name] = torch.export.Dim(name, min=1)
                d[j] = dims[name]
        out.append(d or None)
    return out


def _host_state(tensors):
    arrays, dtypes = {}, {}
    for k, t in tensors.items():
        t = plain(t).detach()
        dtypes[k] = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        arrays[k] = t.cpu().numpy()
    return arrays, dtypes


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save (reference: fluid/dygraph/jit.py:507; the JAX
    package's :247-323): the artifact of the module docstring."""
    if input_spec is None:
        raise ValueError("paddle.jit.save requires input_spec")
    params = {k: plain(p).detach() for k, p in layer.named_parameters()}
    buffers = {k: plain(b).detach() for k, b in layer.named_buffers()
               if b is not None}
    device = next(iter(params.values())).device if params else \
        torch.device("cpu")
    dynamic = _spec_dims(input_spec)
    examples = tuple(torch.zeros([2 if n in (-1, None) else n
                                  for n in sp.shape], dtype=sp.dtype,
                                 device=device) for sp in input_spec)
    fn = layer.__dict__.get("forward")
    was_training = layer.training
    layer.eval()
    if isinstance(fn, StaticFunction):
        del layer.forward  # the raw forward, as the JAX save reads it
    module = _StateCall(layer)
    state_spec = ({k: None for k in params}, {k: None for k in buffers})
    try:
        with torch.no_grad():
            try:
                ep = torch.export.export(
                    module, (params, buffers, *examples),
                    dynamic_shapes=(*state_spec, tuple(dynamic)),
                    strict=False)
            except torch._dynamo.exc.UserError:
                if not any(dynamic):
                    raise
                import warnings
                warnings.warn(
                    "jit.save: symbolic-batch export failed (a shape-"
                    "dependent op in the model); re-exporting with dynamic "
                    "dims pinned to 1 — the artifact will only serve that "
                    "batch size", stacklevel=2)
                examples = tuple(torch.zeros(
                    [1 if n in (-1, None) else n for n in sp.shape],
                    dtype=sp.dtype, device=device) for sp in input_spec)
                ep = torch.export.export(module, (params, buffers,
                                                  *examples), strict=False)
    finally:
        if isinstance(fn, StaticFunction):
            layer.forward = fn
        if was_training:
            layer.train()
    ep.example_inputs = None  # the weights go to .pdiparams once
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(ep, f)
    p_arrays, p_dtypes = _host_state(params)
    b_arrays, b_dtypes = _host_state(buffers)
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({"params": p_arrays, "buffers": b_arrays,
                     "dtypes": {**p_dtypes, **b_dtypes},
                     "device": str(device)}, f)


def _load_artifact(path, blob=None):
    """(exported program, {"params", "buffers"} tensors on the device it
    was exported on) of a save artifact; `blob` is its .pdiparams when
    the caller has read it already."""
    from ..core import place as _place
    # the kernels' custom ops, which the graph names
    from ..ops.kernels import flash_attention, packed_flash  # noqa: F401
    with open(path + ".pdmodel", "rb") as f:
        exported = torch.export.load(f)
    if blob is None:
        with open(path + ".pdiparams", "rb") as f:
            blob = pickle.load(f)
    device = _place.resolve_device(blob["device"])
    state = {group: {k: torch.from_numpy(np.array(a, copy=True)).to(
        device=device, dtype=getattr(torch, blob["dtypes"][k]))
        for k, a in blob[group].items()} for group in ("params", "buffers")}
    return exported, state


def load(path, **configs):
    """paddle.jit.load (reference: fluid/dygraph/jit.py:787): a
    TranslatedLayer over a save artifact."""
    return TranslatedLayer(*_load_artifact(path))


def not_to_static(fn):
    fn._not_to_static = True
    return fn


class ProgramTranslator:
    """The reference's switch (program_translator.py:756): disabled,
    StaticFunction runs the raw function."""
    _instance = None
    enabled = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static):
        self.enabled = enable_to_static


def enable_to_static(flag=True):
    ProgramTranslator.get_instance().enable(flag)


def _batch_tokens(args) -> int:
    """Token count of one batch from shapes only
    (paddle_tpu/jit/__init__.py:363-376)."""
    arrs = [a for a in args if torch.is_tensor(a)]
    for a in arrs:
        if a.ndim >= 2 and not a.is_floating_point() \
                and not a.is_complex() and a.dtype != torch.bool:
            return int(a.numel())
    for a in arrs:
        if a.ndim >= 2:
            return int(a.shape[0] * a.shape[1])
    return 0


def _detached(tree):
    if torch.is_tensor(tree):
        return box(plain(tree).detach())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree


def _trains(p) -> bool:
    """The reference's rule: trainable and not stop_gradient."""
    return getattr(p, "trainable", True) and p.requires_grad


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, donate: bool = True,
                 return_outputs: bool = False, anomaly_guard=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.return_outputs = return_outputs
        self._guard = anomaly_guard
        self._opt_state = None
        self._params = None
        self._prev_params = None
        self._prev_call_t = None

    def invalidate(self):
        """Drop the cached parameter set: call after flipping a
        parameter's trainable or stop_gradient, or changing the model's
        structure."""
        self._params = None

    def _collect(self):
        if self._params is None:
            old = {id(p): p for _, p in self._prev_params or ()}
            self._params = [(k, p) for k, p in self.model.named_parameters()
                            if _trains(p)]
            for i in set(old) - {id(p) for _, p in self._params}:
                self.optimizer._accumulators.pop(i, None)
            self._prev_params = self._params
        return self._params

    def _device(self) -> torch.device:
        return next(iter(self.model.parameters())).device

    def _arg(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        if torch.is_tensor(a):
            return plain(a).to(self._device())
        return a

    def _guarded_state(self, params):
        """The tensors a skipped step must leave as they were: trained
        parameters, optimizer state, buffers."""
        out = [p.detach() for _, p in params]
        out += list(_leaves(self._opt_state))
        out += [b for b in self.model.buffers() if b is not None]
        return out

    def _step(self, args):
        """One step; returns (loss, loss_fn's result, not-finite flag or
        None)."""
        params = self._collect()
        # the optimizer's own accumulators (re-read each call: its
        # set_state_dict replaces them)
        state_for = self.optimizer._state_for
        self._opt_state = {k: state_for(p) for k, p in params}
        guard = self._guard
        saved = None
        if guard is not None and guard.policy == "skip_step":
            state = self._guarded_state(params)
            saved = (state, [t.clone() for t in state])
        out = self.loss_fn(self.model, *args)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        grads = torch.autograd.grad(loss, [p for _, p in params],
                                    allow_unused=True)
        grads = {k: g for (k, _), g in zip(params, grads)}
        bad = None
        if guard is not None:
            bad = tree_not_finite([loss.detach()] + [
                g for g in grads.values() if g is not None])
            if guard.policy == "zero_grads":
                grads = {k: None if g is None else sanitize_tree(g)
                         for k, g in grads.items()}
        with torch.profiler.record_function("optimizer"):
            clip = self.optimizer._grad_clip
            if clip is not None:
                names = sorted(grads)
                by_name = dict(params)
                need_clip = [getattr(by_name[k], "need_clip", True)
                             for k in names]
                clipped = clip.clip_arrays([grads[k] for k in names],
                                           need_clip)
                grads = dict(zip(names, clipped))
            self.optimizer.apply_updates({k: p.detach() for k, p in params},
                                         grads, self._opt_state)
            if saved is not None:
                keep = bad.to(saved[0][0].device)
                for t, old in zip(*saved):
                    t.copy_(torch.where(keep, old, t))
        self.optimizer._global_step += 1
        return loss, out, bad

    def _record_call(self, steps, args):
        """The JAX step's obs telemetry (module docstring)."""
        from .. import obs
        now = time.perf_counter()
        prev, self._prev_call_t = self._prev_call_t, now
        if prev is None:
            return
        interval = now - prev
        obs.histogram("train_step_seconds",
                      "per-step train time via inter-dispatch cadence",
                      unit="seconds").observe(interval / steps)
        tokens = _batch_tokens(args)
        if tokens and interval > 0:
            tps = tokens / interval
            obs.counter("train_tokens_total",
                        "tokens consumed by dispatched train steps",
                        unit="tokens").inc(tokens)
            obs.gauge("train_tokens_per_sec",
                      "training throughput over the last dispatch gap",
                      unit="tokens_per_second").set(tps)
            roof = obs.get_roofline("train_step")
            if roof:
                obs.gauge("train_measured_vs_roofline",
                          "measured tokens/s over the jaxcost static "
                          "roofline for train_step").set(tps / roof)

    @plain_dispatch
    def __call__(self, *args):
        args = [self._arg(a) for a in args]
        loss, out, bad = self._step(args)
        self._record_call(1, args)
        if self._guard is not None:
            bad = bool(bad)
            if bad:
                from .. import obs
                obs.counter("train_anomaly_skips_total",
                            "train steps flagged non-finite by the "
                            "anomaly guard").inc()
            self._guard.record(bad, where="train step")
        loss = box(plain(loss).detach())
        if self.return_outputs:
            return loss, _detached(out)
        return loss


class MultiStepTrainStep(TrainStep):
    """K full optimizer steps per call: step i trains on the i-th slice of
    every argument, each stacked [K, ...]. The result equals K TrainStep
    calls (losses, parameters, optimizer state, `_global_step`).
    `donate` is accepted and ignored: eager PyTorch updates the
    parameters in place and has no buffers to donate."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 steps: int, donate: bool = True):
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        super().__init__(model, loss_fn, optimizer)
        self.steps = int(steps)

    @plain_dispatch
    def __call__(self, *args):
        stacked = [self._arg(a) for a in args]
        for a in stacked:
            if not torch.is_tensor(a) or a.shape[:1] != (self.steps,):
                raise ValueError(
                    f"MultiStepTrainStep(steps={self.steps}) needs every "
                    f"batch arg stacked [steps, ...]; got "
                    f"{getattr(a, 'shape', type(a).__name__)}")
        losses = [plain(self._step([a[i] for a in stacked])[0]).detach()
                  for i in range(self.steps)]
        self._record_call(self.steps, stacked)
        return box(torch.stack(losses))


class TracedLayer:
    """reference fluid/dygraph/jit.py:1047 TracedLayer: trace a dygraph
    layer with example inputs; `trace` returns (outputs, traced), the
    traced object calls the layer and saves it as a jit.save artifact
    (paddle_tpu/jit/__init__.py:694-726)."""

    def __init__(self, layer, input_spec):
        self._layer = layer
        self._input_spec = input_spec

    @classmethod
    def trace(cls, layer, inputs):
        inputs = list(inputs)
        out = layer(*inputs)
        spec = [InputSpec(shape=list(i.shape), dtype=i.dtype)
                for i in inputs]
        return out, cls(layer, spec)

    def __call__(self, *args):
        return self._layer(*args)

    def save_inference_model(self, path, feed=None, fetch=None, **cfg):
        if feed is not None or fetch is not None:
            import warnings
            warnings.warn(
                "TracedLayer.save_inference_model: feed/fetch slicing of "
                "the traced program is not supported on the exported "
                "artifact — the FULL traced signature is exported "
                "(reference jit.py:1047 slices the ProgramDesc by these "
                "indices). Wrap the layer to expose the wanted subset "
                "instead.", stacklevel=2)
        save(self._layer, path, input_spec=self._input_spec, **cfg)


def set_code_level(level=100):
    """reference jit/dy2static logging knob: print transformed code at or
    below `level` (stored on dy2static for its transformer)."""
    from . import dy2static
    dy2static.CODE_LEVEL = int(level)


def set_verbosity(level=0, also_to_stdout=False):
    """reference jit logging verbosity (python logging for the
    paddle_tpu_torch.jit logger)."""
    import logging
    logging.getLogger("paddle_tpu_torch.jit").setLevel(
        logging.DEBUG if level > 0 else logging.WARNING)


from . import dy2static  # noqa: F401,E402
