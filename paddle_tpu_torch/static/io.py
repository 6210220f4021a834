"""paddle.static's save / load, the inference artifact and program
persistence (port of paddle_tpu/static/io.py; reference:
fluid/io.py save_vars / save_inference_model / load_inference_model
and framework/io.py's static paths).

- save / load: the parameters pickled as {name: ndarray} in .pdparams
  and the other persistables (optimizer accumulators, statistics) in
  .pdopt, as the JAX package writes them.
- save_inference_model: the program's forward (cut before its first
  backward or optimizer op) pruned to the fetch targets, with the
  persistables it reads, exported with torch.export (the JAX package
  exports StableHLO through jax.export). Dims declared -1 are
  exported as dynamic dims. The port's kernels reach the exported graph
  as registered custom ops (K1: ops/kernels/flash_attention.py), so the
  loaded artifact launches them on the card. The artifact is the
  port's own format: the port does not read the JAX package's
  artifacts, nor it the port's.
- load_inference_model: (callable, feed names, fetch names); the
  callable runs the artifact on the device it was saved from.
- serialize_program / deserialize_program (JSON), save_program /
  load_program in the JSON or the proto format (static/proto_io.py,
  the bytes the JAX package writes for the same program): a program
  rebuilt from the same model code is checked against the saved
  structure and takes the saved persistables.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import List

import numpy as np
import torch

from .executor import _analyze_program, global_scope
from .program import (Program, Variable, _inert, _paused,
                      default_main_program)

__all__ = ["save", "load", "save_inference_model", "load_inference_model",
           "serialize_program", "deserialize_program", "save_program",
           "load_program"]


def _persistables(program: Program):
    return [v for v in program.global_block.vars.values() if v.persistable]


def _host(value) -> np.ndarray:
    if torch.is_tensor(value):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


def save(program: Program, model_path: str, protocol: int = 4):
    """reference: paddle.static.save: parameters to .pdparams, the other
    persistables to .pdopt."""
    scope = global_scope()
    params, others = {}, {}
    for v in _persistables(program):
        val = scope.find_var(v.name)
        if val is None:
            continue
        (params if v.is_parameter else others)[v.name] = _host(val)
    d = os.path.dirname(model_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(params, f, protocol=protocol)
    with open(model_path + ".pdopt", "wb") as f:
        pickle.dump(others, f, protocol=protocol)


def load(program: Program, model_path: str, executor=None, var_list=None):
    """reference: paddle.static.load (values land in the global scope
    on the CPU; an Executor moves them to its device)."""
    scope = global_scope()
    want = {v.name for v in (var_list or _persistables(program))}
    for suffix in (".pdparams", ".pdopt"):
        path = model_path + suffix
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            blob = pickle.load(f)
        for name, arr in blob.items():
            if name in want:
                scope.set(name, torch.from_numpy(np.array(arr, copy=True)))


def _forward_ops(program: Program, fetch_names):
    """The ops before the training tail (as clone(for_test) cuts) that
    the fetch targets depend on (reference: save_inference_model prunes
    the program to its targets)."""
    ops = []
    for od in program.ops:
        if od.kind == "backward" or od.op_type.startswith("optimize"):
            break
        ops.append(od)
    needed, kept = set(fetch_names), []
    for od in reversed(ops):
        if needed.intersection(od.output_names):
            kept.append(od)
            needed.update(od.input_names)
    return kept[::-1]


class _InferenceModule(torch.nn.Module):
    """The program's forward over its persistables (buffers), feeds in,
    fetches out: what save_inference_model exports."""

    def __init__(self, ops, feed_names, fetch_names, state, consts, rt):
        super().__init__()
        self._ops = ops
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._slots = {}
        for i, (name, value) in enumerate({**consts, **state}.items()):
            self.register_buffer(f"v{i}", value)
            self._slots[name] = f"v{i}"
        self._rt = dict(rt)

    def forward(self, *feeds):
        env = {name: getattr(self, slot) for name, slot in
               self._slots.items()}
        env.update(self._rt)
        env.update(zip(self._feed_names, feeds))
        with _inert():
            for od in self._ops:
                if od.kind == "init":
                    raise ValueError("an inference program holds no init op")
                out = od.fn(*[env[n] for n in od.input_names])
                leaves = [o for o in torch.utils._pytree.tree_leaves(out)
                          if isinstance(o, torch.Tensor)]
                env.update(zip(od.output_names, leaves))
        return tuple(env[n] for n in self._fetch_names)


def save_inference_model(path_prefix: str, feed_vars: List[Variable],
                         fetch_vars, executor=None, program=None):
    """reference: fluid/io.py save_inference_model: the program's forward
    to the fetch targets and the persistables it reads, exported with
    torch.export on the device the Scope holds them on (module
    docstring)."""
    program = program or default_main_program()
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    feed_names = [v.name for v in feed_vars]
    fetch_names = [v.name for v in fetch_vars]
    scope = global_scope()
    ops = _forward_ops(program, fetch_names)
    probe = Program()
    probe.global_block.ops = ops
    probe.global_block.vars = program.global_block.vars
    probe._consts = program._consts
    reads, _, _ = _analyze_program(probe)
    state = {}
    for n in reads:
        val = scope.find_var(n)
        if val is None:
            raise RuntimeError(f"save_inference_model: persistable {n} not "
                               "initialized (run startup + training first)")
        state[n] = val.detach() if torch.is_tensor(val) else \
            torch.from_numpy(np.array(val, copy=True))
    device = next(iter(state.values())).device if state else \
        torch.device("cpu")
    consts = {k: v.to(device) for k, v in program._consts.items()}
    rt = {k: fn() for k, fn in program._runtime_scalars.items()}
    module = _InferenceModule(ops, feed_names, fetch_names, state, consts,
                              rt)
    examples = tuple(
        torch.zeros([2 if d == -1 else d for d in v.shape], dtype=v.dtype,
                    device=device) for v in feed_vars)
    dynamic = (tuple(
        {j: torch.export.Dim(f"b{i}_{j}") for j, d in enumerate(v.shape)
         if d == -1} or None for i, v in enumerate(feed_vars)),)
    with torch.no_grad(), _paused():
        try:  # a dynamic batch, else (the program fixed it) the shapes
            ep = torch.export.export(module, examples,
                                     dynamic_shapes=dynamic, strict=False)
        except torch._dynamo.exc.UserError:
            examples = tuple(torch.zeros(
                [1 if d == -1 else d for d in v.shape], dtype=v.dtype,
                device=device) for v in feed_vars)
            ep = torch.export.export(module, examples, strict=False)
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path_prefix + ".pdmodel", "wb") as f:
        torch.export.save(ep, f)
    with open(path_prefix + ".pdiparams", "wb") as f:
        pickle.dump({"feed_names": feed_names, "fetch_names": fetch_names,
                     "device": str(device)}, f)


class _InferenceProgram:
    """A loaded inference artifact: call it with the feeds (arrays or
    tensors) in feed_names' order; it returns the fetches' tensors."""

    def __init__(self, exported, meta):
        self._module = exported.module()
        self.feed_names = meta["feed_names"]
        self.fetch_names = meta["fetch_names"]
        self.device = torch.device(meta["device"])

    def __call__(self, *arrays):
        args = [a.to(self.device) if torch.is_tensor(a) else
                torch.from_numpy(np.array(np.asarray(a), copy=True)).to(
                    self.device) for a in arrays]
        with torch.no_grad():
            return self._module(*args)


def load_inference_model(path_prefix: str, executor=None):
    """(program_like, feed_names, fetch_names): program_like runs the
    artifact save_inference_model wrote."""
    from ..ops.kernels import flash_attention  # noqa: F401 (K1's ops)
    with open(path_prefix + ".pdmodel", "rb") as f:
        exported = torch.export.load(f)
    with open(path_prefix + ".pdiparams", "rb") as f:
        meta = pickle.load(f)
    prog = _InferenceProgram(exported, meta)
    return prog, prog.feed_names, prog.fetch_names


# ---------------------------------------------------------------------------
# Program persistence: the structure (vars with shape, dtype and flags,
# ops with type and input/output names) as JSON or proto, and the
# persistables beside it; load_program checks a program rebuilt from
# the same model code against the saved structure, then loads.
# ---------------------------------------------------------------------------
def serialize_program(program: Program) -> bytes:
    desc = {
        "version": 1,
        "vars": [
            {"name": v.name, "shape": list(v.shape),
             "dtype": str(v.dtype).replace("torch.", ""),
             "persistable": bool(v.persistable),
             "is_parameter": bool(v.is_parameter),
             "stop_gradient": bool(v.stop_gradient),
             "is_data": bool(getattr(v, "is_data", False))}
            for v in program.global_block.vars.values()
        ],
        "ops": [
            {"kind": od.kind, "type": od.op_type,
             "inputs": list(od.input_names),
             "outputs": list(od.output_names)}
            for od in program.ops
        ],
        "runtime_scalars": sorted(program._runtime_scalars),
    }
    return json.dumps(desc, indent=1).encode()


def deserialize_program(data: bytes) -> dict:
    """A serialized program's structure, for inspection and checks (it
    runs through a program rebuilt from the model code)."""
    desc = json.loads(data.decode())
    if desc.get("version") != 1:
        raise ValueError(f"unsupported program desc version: "
                         f"{desc.get('version')}")
    return desc


def _desc_signature(desc: dict):
    return ([(o["kind"], o["type"], tuple(o["inputs"]),
              tuple(o["outputs"])) for o in desc["ops"]],
            {v["name"]: (tuple(v["shape"]), v["dtype"], v["persistable"])
             for v in desc["vars"]})


def save_program(program: Program, path_prefix: str,
                 format: str = "json"):
    """The program's structure and its persistables. format='proto'
    writes the reference's proto2 `__model__` wire format
    (static/proto_io.py); 'json' the fuller structural schema."""
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    if format == "proto":
        from .proto_io import serialize_program_desc
        blob = serialize_program_desc(program)
    else:
        blob = serialize_program(program)
    with open(path_prefix + ".pdmodel", "wb") as f:
        f.write(blob)
    save(program, path_prefix)


def _read_desc(path_prefix: str) -> dict:
    """The saved structure, JSON ('{') or proto2 (a blocks field)."""
    with open(path_prefix + ".pdmodel", "rb") as f:
        raw = f.read()
    if raw[:1] == b"{":
        return deserialize_program(raw)
    from .proto_io import parse_program_desc
    blk = parse_program_desc(raw)["blocks"][0]
    return {
        "version": 1,
        "vars": [{"name": v["name"], "shape": v["shape"],
                  "dtype": v["dtype"], "persistable": v["persistable"],
                  "is_parameter": False, "stop_gradient": True,
                  "is_data": v["is_data"]} for v in blk["vars"]],
        "ops": [{"kind": o["kind"], "type": o["type"],
                 "inputs": o["inputs"], "outputs": o["outputs"]}
                for o in blk["ops"]],
        "runtime_scalars": [],
        "_proto": True,
    }


def load_program(program: Program, path_prefix: str, strict: bool = True):
    """Check `program` (rebuilt from the same model code) against the
    saved structure, then load its persistables. Returns the saved
    structure."""
    desc = _read_desc(path_prefix)
    if strict:
        saved_sig = _desc_signature(desc)
        live_sig = _desc_signature(
            deserialize_program(serialize_program(program)))
        if saved_sig != live_sig:
            for i, (a, b) in enumerate(zip(saved_sig[0], live_sig[0])):
                if a != b:
                    raise ValueError(
                        f"program structure mismatch at op {i}: saved "
                        f"{a} vs rebuilt {b}; the model code that "
                        "produced the checkpoint differs")
            raise ValueError(
                "program structure mismatch (op count or var table "
                "differs from the saved desc)")
    load(program, path_prefix)
    return desc
