"""DistributeTranspiler, the legacy parameter-server transpile API (port
of paddle_tpu/distributed/transpiler.py; reference: python/paddle/
fluid/transpiler/distribute_transpiler.py).

transpile() splits a recorded static Program at its backward op over
the port's parameter server (distributed/ps):
- the trainer program keeps the forward, the backward and the gradient
  clip (the `optimize.update` ops go); each Executor.run of it pulls
  the parameters from the pservers into the Scope, runs the program on
  the Executor's device, fetches the gradients and pushes them (scaled
  by 1 / trainers in sync mode, the reference's scale op);
- each pserver program hosts the dense tables routed to its endpoint
  (table_id % endpoints, the client's rule) with server-side SGD at the
  program's learning rate; Executor.run of it serves (block=False in
  serve() serves from host threads).
Trainer 0 seeds the tables from its initialized Scope. `rpc_stats` of
the trainer program counts each step's pulls and pushes and their
bytes.

Left out: the reference's row-sliced sends and optimizers other than
SGD on the pservers (the JAX package's tables run SGD too);
DistributeTranspilerConfig's knobs are recorded only.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["DistributeTranspilerConfig", "DistributeTranspiler"]


class DistributeTranspilerConfig:
    """reference: the transpiler's config knobs. slice_var_up and the
    split sizes concern the reference's row-sliced send; tables here
    route whole parameters, so they are recorded only."""

    def __init__(self):
        self.slice_var_up = True
        self.min_block_size = 8192
        self.split_method = None
        self.sync_mode = True


class _PServerProgram:
    """The pserver side: Executor.run() on it serves forever (like
    exe.run(pserver_program) on the reference's listen_and_serv)."""

    def __init__(self, endpoint: str, tables: Dict[int, dict]):
        self.endpoint = endpoint
        self.tables = tables
        self._server = None

    def serve(self, block: bool = True):
        from .ps import ParameterServer
        host, port = self.endpoint.rsplit(":", 1)
        self._server = ParameterServer(host=host, port=int(port))
        for tid, spec in self.tables.items():
            self._server.add_dense_table(
                tid, spec["shape"], optimizer=spec["optimizer"],
                lr=spec["lr"])
        self._server.start()
        if block:
            import threading
            threading.Event().wait()  # listen_and_serv never returns
        return self._server

    def stop(self):
        if self._server is not None:
            self._server.stop()


class _TrainerProgram:
    """The trainer side: the forward and backward program and the
    pull / push protocol the Executor drives around each step."""

    def __init__(self, program, param_names: List[str],
                 grad_names: List[str], endpoints: List[str],
                 trainer_id: int, trainers: int, sync_mode: bool):
        self.program = program            # update ops stripped
        self.param_names = param_names
        self.grad_names = grad_names
        self.endpoints = endpoints
        self.trainer_id = trainer_id
        self.trainers = trainers
        self.sync_mode = sync_mode
        self._client = None
        self.rpc_stats = {"pulls": 0, "pushes": 0, "bytes": 0}

    def _ensure_client(self, scope):
        if self._client is not None:
            return self._client
        from .ps import PsClient
        self._client = PsClient(self.endpoints)
        if self.trainer_id == 0:
            # the tables start from trainer 0's initialized Scope (the
            # reference runs the startup program on the pserver)
            for tid, name in enumerate(self.param_names):
                self._client.set_dense(tid, _host(scope.find_var(name)))
        if self.trainers > 1:
            self._client.barrier(self.trainers)
        return self._client

    def run_step(self, executor, feed, fetch_list, scope):
        client = self._ensure_client(scope)
        for tid, name in enumerate(self.param_names):
            val = client.pull_dense(tid)
            self.rpc_stats["pulls"] += 1
            self.rpc_stats["bytes"] += val.nbytes
            cur = scope.find_var(name)
            if torch.is_tensor(cur) and tuple(cur.shape) == val.shape:
                cur.copy_(torch.from_numpy(np.asarray(val)))
            else:
                scope.set(name, torch.from_numpy(np.array(val, copy=True)))
        if self.sync_mode and self.trainers > 1:
            # the end-of-pull barrier (reference: recv barrier): no
            # trainer's push of step N may race another's pull of step N
            client.barrier(self.trainers)
        fetch_list = list(fetch_list or [])
        outs = executor.run(self.program, feed=feed,
                            fetch_list=fetch_list + self.grad_names,
                            scope=scope)
        user_outs, grads = outs[:len(fetch_list)], outs[len(fetch_list):]
        # sync mode: the pserver applies one SGD step per push, so each
        # trainer pushes grad / trainers (reference: the scale
        # 1/trainer_num op, distribute_transpiler.py:2237)
        scale = (1.0 / self.trainers
                 if (self.sync_mode and self.trainers > 1) else 1.0)
        for tid, g in enumerate(grads):
            g = np.asarray(g) * scale if scale != 1.0 else np.asarray(g)
            client.push_dense(tid, g)
            self.rpc_stats["pushes"] += 1
            self.rpc_stats["bytes"] += g.nbytes
        if self.sync_mode and self.trainers > 1:
            client.barrier(self.trainers)
        return user_outs


def _host(value) -> np.ndarray:
    if torch.is_tensor(value):
        return value.detach().float().cpu().numpy() \
            if value.dtype == torch.bfloat16 else \
            value.detach().cpu().numpy()
    return np.asarray(value)


class DistributeTranspiler:
    """reference: distribute_transpiler.py DistributeTranspiler."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._trainer_prog = None
        self._tables = None
        self._endpoints = None

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, startup_program=None,
                  current_endpoint=None):
        from ..static.program import default_main_program
        program = program or default_main_program()
        endpoints = [e.strip() for e in pservers.split(",") if e.strip()]
        if not endpoints:
            raise ValueError("transpile needs pserver endpoints "
                             "(pservers='ip:port,ip:port')")
        backward_ops = [od for od in program.ops
                        if od.kind == "backward" and od.payload[0] != "vjp"]
        if not backward_ops:
            raise ValueError(
                "transpile: the program has no backward op; call "
                "optimizer.minimize(loss) first (the reference transpiler "
                "has the same requirement)")
        bw = backward_ops[-1]
        _loss, param_names = bw.payload
        grad_names = list(bw.output_names)

        # the tables run SGD at the program's learning rate (the
        # reference moves the optimizer ops to the pserver)
        lr = 0.01
        for key, fn in program._runtime_scalars.items():
            if key.startswith("learning_rate"):
                lr = float(fn())
                break
        shapes = {name: tuple(int(d) for d in
                              program.global_block.vars[name].shape)
                  for name in param_names}

        trainer = program.clone()
        trainer.global_block.ops = [
            od for od in trainer.global_block.ops
            if not od.op_type.startswith("optimize.update")]

        self._endpoints = endpoints
        self._tables = {
            tid: {"shape": shapes[name], "optimizer": "sgd", "lr": lr,
                  "param": name}
            for tid, name in enumerate(param_names)}
        self._trainer_prog = _TrainerProgram(
            trainer, list(param_names), grad_names, endpoints,
            int(trainer_id), int(trainers), bool(sync_mode))
        return self

    def get_trainer_program(self, wait_port=True):
        if self._trainer_prog is None:
            raise RuntimeError("call transpile() first")
        return self._trainer_prog

    def get_pserver_program(self, endpoint):
        if self._tables is None:
            raise RuntimeError("call transpile() first")
        idx = self._endpoints.index(endpoint)
        mine = {tid: spec for tid, spec in self._tables.items()
                if tid % len(self._endpoints) == idx}
        return _PServerProgram(endpoint, mine)

    def get_pserver_programs(self, endpoint):
        return self.get_pserver_program(endpoint), \
            self.get_startup_program(endpoint)

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None):
        from ..static.program import Program
        return Program()  # the tables initialize server-side
