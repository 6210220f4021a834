"""Role makers (port of paddle_tpu/distributed/fleet/role_maker.py;
reference: distributed/fleet/base/role_maker.py).

A worker's identity is the launcher's env contract (PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS); the rendezvous is
init_parallel_env's process group, over which `_barrier` and
`_all_gather` run.
"""
from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._is_collective = False

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        return 0

    def worker_num(self):
        return 1

    def server_num(self):
        return 0

    def get_trainer_endpoints(self):
        return []

    def get_pserver_endpoints(self):
        return []


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = eps.split(",") if eps else []
        pseps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = pseps.split(",") if pseps else []
        self._role = Role.WORKER
        if os.environ.get("TRAINING_ROLE", "TRAINER") == "PSERVER":
            self._role = Role.SERVER

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def worker_index(self):
        return self._rank

    def worker_num(self):
        return self._size

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def _barrier(self, comm_world=None):
        from .. import collective
        collective.barrier()

    def _all_gather(self, obj, comm_world=None):
        from .. import collective
        return collective.all_gather_object([], obj)


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        super().__init__(is_collective=is_collective)
        self._rank = kwargs.get("current_id", self._rank)
        self._size = kwargs.get("worker_num", self._size)
        if "worker_endpoints" in kwargs:
            self._worker_endpoints = kwargs["worker_endpoints"]
