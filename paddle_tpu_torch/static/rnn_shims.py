"""Static-graph RNN authoring and py_reader (port of paddle_tpu/static/
rnn_shims.py).

StaticRNN (fixed-length time-major [T, ...] sequences) and DynamicRNN
(padded batch-major [B, T, ...] sequences with a lengths vector) record
their step into a sub-program inside `with rnn.step():` / `block()`,
and one op of the outer program runs it. The JAX package lowers that op
to a lax.scan; the port's op runs the step's ops once per time step,
eagerly on the device, and stacks the step outputs. DynamicRNN holds a
row's memory and zeroes its outputs past the row's length (the
reference's LoD-bucketed execution, row for row), as the JAX package's
mask does. py_reader is a bounded host queue that Executor.run drains
when its feed dict lacks the reader's variables, raising EOFError at
the generator's end.

Left out: LoD inputs (the padded form and a lengths vector stand in,
as in the JAX package); py_reader's lod_levels and use_double_buffer
are accepted and ignored.
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .program import (OpDesc, Program, Variable, default_main_program,
                      program_guard)

__all__ = ["StaticRNN", "DynamicRNN", "py_reader", "read_file"]


class _RNNBase:
    """The capture of one step as a sub-program, lowered to one op."""

    def __init__(self):
        self._sub: Optional[Program] = None
        self._guard = None
        self._seq_inputs: List[tuple] = []   # (outer_name, inner_var)
        self._static_inputs: List[tuple] = []
        self._memories: List[dict] = []      # {inner, init_name, update}
        self._outputs: List[Variable] = []
        self._built = False
        self._out_vars = None

    class _StepGuard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            rnn = self.rnn
            rnn._sub = Program()
            rnn._guard = program_guard(rnn._sub)
            rnn._guard.__enter__()
            return rnn

        def __exit__(self, *exc):
            self.rnn._guard.__exit__(*exc)
            self.rnn._guard = None
            return False

    def step(self):
        """with rnn.step(): ... (reference StaticRNN.step)."""
        return self._StepGuard(self)

    block = step  # DynamicRNN spells it block()

    def _inner(self, name, shape, dtype):
        return self._sub.global_block.create_var(
            name=self._sub.unique_name(name), shape=shape, dtype=dtype)

    def static_input(self, x: Variable) -> Variable:
        """A loop-invariant input visible at every step."""
        iv = self._inner("rnn.static", x.shape, x.dtype)
        self._static_inputs.append((x.name, iv))
        return iv

    def update_memory(self, mem: Variable, new: Variable):
        for m in self._memories:
            if m["inner"] is mem:
                m["update"] = new
                return
        raise ValueError("update_memory: not a memory var of this RNN")

    def _scan_op(self, blk, prog, seq_axis_len_of, mask_names=()):
        from .executor import _interpret
        sub = self._sub
        ops = list(sub.global_block.ops)
        consts = dict(sub._consts)
        seq_names = [outer for outer, _ in self._seq_inputs]
        in_names = [iv.name for _, iv in self._seq_inputs]
        stat_names = [outer for outer, _ in self._static_inputs]
        stat_inner = [iv.name for _, iv in self._static_inputs]
        mem_inner = [m["inner"].name for m in self._memories]
        upd_names = [m["update"].name if m["update"] is not None else None
                     for m in self._memories]
        init_names = [m["init_name"] for m in self._memories]
        out_names = [v.name for v in self._outputs]
        if any(u is None for u in upd_names):
            raise ValueError("every memory needs an update_memory() call")

        produced = set(consts) | set(in_names) | set(stat_inner) \
            | set(mem_inner)
        free = []
        for od in ops:
            for n in od.input_names:
                if n not in produced and n not in free:
                    free.append(n)
            produced.update(od.output_names)
        n_seq, n_init, n_stat = len(seq_names), len(init_names), \
            len(stat_names)
        n_mask = len(mask_names)

        def scan_fn(*args):
            seqs = args[:n_seq]
            mask = args[n_seq] if n_mask else None
            rest = args[n_seq + n_mask:]
            carry = list(rest[:n_init])
            stats = rest[n_init:n_init + n_stat]
            frees = rest[n_init + n_stat:]
            device = seqs[0].device
            base = {k: v.to(device) for k, v in consts.items()}
            base.update(zip(free, frees))
            base.update(zip(stat_inner, stats))
            ys = []
            for t in range(seqs[0].shape[0]):
                env = dict(base)
                env.update(zip(mem_inner, carry))
                env.update(zip(in_names, (s[t] for s in seqs)))
                _interpret(ops, env, device)
                new = [env[u] for u in upd_names]
                step_ys = [env[o] for o in out_names]
                if mask is not None:
                    # past a row's length: hold the memory, zero the
                    # output (the reference's LoD bucketing stops there)
                    def keep(v, m=mask[t]):
                        return m.reshape((-1,) + (1,) * (v.ndim - 1)).to(
                            v.dtype)
                    new = [n * keep(n) + o * (1 - keep(n))
                           for n, o in zip(new, carry)]
                    step_ys = [y * keep(y) for y in step_ys]
                carry = new
                ys.append(step_ys)
            return tuple(torch.stack([y[i] for y in ys])
                         for i in range(len(out_names)))

        op_inputs = seq_names + list(mask_names) + init_names \
            + stat_names + free
        out_vars = [blk.create_var(name=prog.unique_name("rnn.out"),
                                   shape=(seq_axis_len_of,) + tuple(v.shape),
                                   dtype=v.dtype)
                    for v in self._outputs]
        blk.append_op(OpDesc("op", "static_rnn_scan", scan_fn, op_inputs,
                             [v.name for v in out_vars]))
        return out_vars


class StaticRNN(_RNNBase):
    """reference: fluid.layers.StaticRNN: a fixed-length [T, ...]
    sequence, block-style step authoring."""

    def step_input(self, x: Variable) -> Variable:
        """x: a [T, ...] time-major sequence; returns one step's slice."""
        iv = self._inner("rnn.in", tuple(x.shape[1:]), x.dtype)
        self._seq_inputs.append((x.name, iv))
        return iv

    def memory(self, init: Variable = None, shape=None, value=0.0,
               dtype="float32", batch_ref: Variable = None):
        if init is not None:
            iv = self._inner("rnn.mem", init.shape, init.dtype)
            init_name = init.name
        else:
            if shape is None:
                raise ValueError("memory() needs init= or shape=")
            from .nn import persistable_buffer
            if self._guard is None:
                raise RuntimeError(
                    "StaticRNN.memory() must be called inside "
                    "`with rnn.step():` (reference StaticRNN contract)")
            # the initial memory lives in the OUTER program: step out of
            # the sub-program's guard for it
            self._guard.__exit__(None, None, None)
            try:
                zed = persistable_buffer(
                    np.full(tuple(shape), value, np.dtype(str(dtype))),
                    prefix="rnn.mem0")
            finally:
                self._guard.__enter__()
            iv = self._inner("rnn.mem", tuple(shape), str(dtype))
            init_name = zed.name
        self._memories.append({"inner": iv, "init_name": init_name,
                               "update": None})
        return iv

    def step_output(self, o: Variable):
        self._outputs.append(o)

    def output(self, *outs):
        for o in outs:
            self.step_output(o)

    def __call__(self):
        if self._built:
            return self._out_vars
        if not self._seq_inputs:
            raise ValueError("StaticRNN needs at least one step_input")
        prog = default_main_program()
        blk = prog.current_block()
        seq_len = int(prog.global_block.vars[
            self._seq_inputs[0][0]].shape[0])
        self._out_vars = self._scan_op(blk, prog, seq_len)
        self._built = True
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars


class DynamicRNN(_RNNBase):
    """reference: fluid.layers.DynamicRNN: variable-length sequences as
    a padded [B, T, ...] batch and lengths [B]."""

    def __init__(self):
        super().__init__()
        self._lengths_name = None
        self._maxlen = None

    def step_input(self, x: Variable, lengths: Variable = None,
                   level=0) -> Variable:
        """x: [B, T, ...] padded batch-major sequences; lengths [B]."""
        if lengths is not None:
            self._lengths_name = lengths.name
        self._maxlen = int(x.shape[1])
        iv = self._inner("drnn.in", (x.shape[0],) + tuple(x.shape[2:]),
                         x.dtype)
        self._seq_inputs.append((x.name, iv))
        return iv

    memory = StaticRNN.memory
    output = StaticRNN.output
    step_output = StaticRNN.step_output

    def __call__(self):
        if self._built:
            return self._out_vars
        if self._lengths_name is None:
            raise ValueError("DynamicRNN.step_input needs lengths= "
                             "(padded [B,T,...] + lengths form)")
        prog = default_main_program()
        blk = prog.current_block()
        T = self._maxlen
        lens = prog.global_block.vars[self._lengths_name]

        def mask_fn(length, _T=T):
            t = torch.arange(_T, device=length.device)[:, None]
            return (t < length.reshape(1, -1)).to(torch.float32)

        mask_v = blk.create_var(name=prog.unique_name("drnn.mask"),
                                shape=(T, int(lens.shape[0])),
                                dtype="float32")
        blk.append_op(OpDesc("op", "drnn_mask", mask_fn,
                             [self._lengths_name], [mask_v.name]))
        # each padded input to time-major for the steps
        new_seq = []
        for outer, iv in self._seq_inputs:
            ov = prog.global_block.vars[outer]
            perm = (1, 0) + tuple(range(2, len(ov.shape)))
            tv = blk.create_var(
                name=prog.unique_name("drnn.tm"),
                shape=tuple(np.asarray(ov.shape)[list(perm)]),
                dtype=ov.dtype)
            blk.append_op(OpDesc("op", "drnn_time_major",
                                 lambda a, p=perm: a.permute(p),
                                 [outer], [tv.name]))
            new_seq.append((tv.name, iv))
        self._seq_inputs = new_seq
        outs = self._scan_op(blk, prog, T, mask_names=[mask_v.name])
        # back to batch-major [B, T, ...]
        final = []
        for ov in outs:
            perm = (1, 0) + tuple(range(2, len(ov.shape)))
            bv = blk.create_var(
                name=prog.unique_name("drnn.out"),
                shape=tuple(np.asarray(ov.shape)[list(perm)]),
                dtype=ov.dtype)
            blk.append_op(OpDesc("op", "drnn_batch_major",
                                 lambda a, p=perm: a.permute(p),
                                 [ov.name], [bv.name]))
            final.append(bv)
        self._out_vars = final
        self._built = True
        return final[0] if len(final) == 1 else final


class _PyReader:
    """A bounded feed queue (reference: create_py_reader +
    BufferedReader): decorate_batch_generator gives a callable returning
    an iterable of feed tuples, start() launches the producer thread,
    the Executor takes one batch per run() that lacks the reader's
    feeds, and exhaustion raises EOFError (the reference's
    EOFException)."""

    def __init__(self, capacity: int, shapes, dtypes, names):
        self.capacity = int(capacity)
        self.names = list(names)
        self._gen = None
        self._q: Optional[_queue.Queue] = None
        self._thread = None
        self._stop = threading.Event()
        prog = default_main_program()
        blk = prog.current_block()
        self.vars = []
        for name, shape, dtype in zip(self.names, shapes, dtypes):
            v = blk.create_var(name=name, shape=tuple(shape),
                               dtype=str(dtype))
            v.is_data = True
            self.vars.append(v)
        prog._py_readers.append(self)

    def decorate_batch_generator(self, gen):
        self._gen = gen
        return self

    decorate_sample_list_generator = decorate_batch_generator
    decorate_paddle_reader = decorate_batch_generator

    def start(self):
        if self._gen is None:
            raise RuntimeError("py_reader: decorate_batch_generator first")
        self._stop.clear()
        q = _queue.Queue(self.capacity)
        self._q = q

        def fill(q=q):
            # the queue is bound locally: reset() clears self._q, and the
            # producer's end marker goes to the queue it started with
            try:
                for batch in self._gen():
                    if self._stop.is_set():
                        return
                    q.put(batch)
            finally:
                q.put(None)

        self._thread = threading.Thread(target=fill, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        if self._q is not None:
            try:  # drain so that the producer unblocks
                while True:
                    self._q.get_nowait()
            except _queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._q = None

    def next_feed(self) -> Dict[str, np.ndarray]:
        if self._q is None:
            raise RuntimeError("py_reader: start() before exe.run()")
        item = self._q.get()
        if item is None:
            self._q = None
            raise EOFError("py_reader exhausted (reference: EOFException "
                           "- call reset()/start() for the next epoch)")
        if isinstance(item, dict):
            return item
        return dict(zip(self.names, item))


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """reference: fluid.layers.py_reader (reader.py create_py_reader)."""
    prog = default_main_program()
    names = [prog.unique_name(f"{name or 'py_reader'}.v{i}")
             for i in range(len(shapes))]
    return _PyReader(capacity, shapes, dtypes, names)


def read_file(reader: _PyReader):
    """reference: fluid.layers.read_file: the reader's data vars."""
    vs = reader.vars
    return vs[0] if len(vs) == 1 else vs
