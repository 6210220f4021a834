"""The parallel environment and DataParallel (port of
paddle_tpu/distributed/parallel.py).

`ParallelEnv` reads the launcher's env contract: PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS, PADDLE_CURRENT_ENDPOINT
and FLAGS_selected_gpus (the JAX package reads FLAGS_selected_tpus
first; the port's launchers set FLAGS_selected_gpus, and give each rank
the card of its rank through CUDA_VISIBLE_DEVICES).

`init_parallel_env()` brings up torch.distributed, where the JAX
package brings up its coordination service: the rendezvous is a TCP
store at the first trainer endpoint (for a world of one without
endpoints, a free local port), the backend NCCL on CUDA, the port's
default device, and gloo when the caller asked for the CPU
(`paddle.set_device("cpu")`). A failed bootstrap raises: a run that
quietly went on as one rank would corrupt an experiment. It then sets
a global mesh over every rank on the dp axis, unless one is set.

DataParallel passes the forward through, as in the JAX package: the
data-parallel gradient mean lives in parallel.ShardedTrainStep (and
the fleet's distributed_train_step), over flat buckets of gradients.
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from ..core import place as _place
from ..nn.layer.layers import Layer
from ..parallel import mesh as _mesh

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank",
           "get_world_size", "DataParallel"]

# how long a rank waits for its peers at the rendezvous and in a
# collective before it raises
TIMEOUT_S = 300


class ParallelEnv:
    """reference: distributed/parallel.py ParallelEnv (the env contract
    set by the launcher, distributed/utils.py:406-409)."""

    def __init__(self):
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._device_id = int(os.environ.get("FLAGS_selected_gpus", "0"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT",
                                                "")

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    # legacy names
    local_rank = rank
    nranks = world_size
    dev_id = device_id


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_parallel_env():
    """reference: distributed/parallel.py:57. Joins the job's process
    group (once per process) and sets the global mesh; returns the
    ParallelEnv."""
    env = ParallelEnv()
    if not dist.is_initialized():
        device = _place.resolve_device(None)
        backend = "nccl" if device.type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(env.device_id
                                  if env.device_id < torch.cuda.device_count()
                                  else 0)
        if env.trainer_endpoints:
            master = env.trainer_endpoints[0]
        elif env.world_size == 1:
            master = f"127.0.0.1:{free_port()}"
        else:
            raise RuntimeError(
                f"init_parallel_env: PADDLE_TRAINERS_NUM="
                f"{env.world_size} but no PADDLE_TRAINER_ENDPOINTS")
        dist.init_process_group(
            backend, init_method=f"tcp://{master}",
            world_size=env.world_size, rank=env.rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if _mesh.get_global_mesh() is None:
        _mesh.set_global_mesh(_mesh.build_mesh(dp=dist.get_world_size()))
    return env


def get_rank(group=None):
    return _mesh.world_rank()


def get_world_size(group=None):
    return _mesh.world_size()


class DataParallel(Layer):
    """reference: fluid/dygraph/parallel.py:321. The forward passes
    through; train with parallel.ShardedTrainStep (or the fleet's
    distributed_train_step), which takes the gradient mean over the
    data-parallel ranks."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """reference: parallel.py:505. The step's mean over the global
        batch already holds the 1/nranks factor."""
        return loss

    def apply_collective_grads(self):
        """reference: parallel.py:514. The step reduces the gradients."""

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)
