"""PS client and the geo-async worker (port of
paddle_tpu/distributed/ps/client.py; reference:
distributed/service/brpc_ps_client.cc, pull/push RPCs with tables
partitioned across servers, and service/communicator.cc's
GeoCommunicator: k local steps, then a delta push).
"""
from __future__ import annotations

import socket
import threading
from typing import Dict, List

import numpy as np

from .server import recv_msg, send_msg

__all__ = ["PsClient", "GeoWorker"]


class PsClient:
    """Connects to one or more servers; tables are partitioned by
    table_id % nservers (the reference shards ROWS across servers; table
    granularity keeps the transport identical with less bookkeeping)."""

    def __init__(self, endpoints: List[str]):
        self._socks = []
        self._lock = threading.Lock()
        for ep in endpoints:
            host, port = ep.rsplit(":", 1)
            s = socket.create_connection((host, int(port)), timeout=30)
            self._socks.append(s)

    def _sock(self, table_id: int) -> socket.socket:
        return self._socks[table_id % len(self._socks)]

    def _rpc(self, table_id: int, msg):
        with self._lock:
            s = self._sock(table_id)
            send_msg(s, msg)
            out = recv_msg(s)
        if out is None or out.get("status") != "ok":
            raise RuntimeError(f"PS rpc failed: {out}")
        return out.get("value")

    # ------------------------------------------------------------- dense
    def pull_dense(self, table_id: int) -> np.ndarray:
        return self._rpc(table_id, {"cmd": "pull_dense", "table": table_id})

    def push_dense(self, table_id: int, grad: np.ndarray):
        self._rpc(table_id, {"cmd": "push_dense", "table": table_id,
                             "grad": np.asarray(grad, np.float32)})

    def set_dense(self, table_id: int, value: np.ndarray):
        self._rpc(table_id, {"cmd": "set_dense", "table": table_id,
                             "value": np.asarray(value, np.float32)})

    # ------------------------------------------------------------ sparse
    def pull_sparse(self, table_id: int, ids) -> np.ndarray:
        return self._rpc(table_id, {"cmd": "pull_sparse",
                                    "table": table_id,
                                    "ids": np.asarray(ids, np.int64)})

    def push_sparse(self, table_id: int, ids, grads):
        self._rpc(table_id, {"cmd": "push_sparse", "table": table_id,
                             "ids": np.asarray(ids, np.int64),
                             "grads": np.asarray(grads, np.float32)})

    def set_sparse(self, table_id: int, ids, values, states=None):
        """Direct row assignment (device-cache flush, PSGPU EndPass);
        optionally carries per-row optimizer state."""
        msg = {"cmd": "set_sparse", "table": table_id,
               "ids": np.asarray(ids, np.int64),
               "values": np.asarray(values, np.float32)}
        if states is not None:
            msg["states"] = np.asarray(states, np.float32)
        self._rpc(table_id, msg)

    def pull_sparse_state(self, table_id: int, ids) -> np.ndarray:
        """Per-row optimizer state (adagrad g2sum analogue)."""
        return self._rpc(table_id, {"cmd": "pull_sparse_state",
                                    "table": table_id,
                                    "ids": np.asarray(ids, np.int64)})

    # ------------------------------------------------------------- misc
    def barrier(self, world: int):
        """reference: ps barrier (service/communicator barrier_worker)."""
        for i in range(len(self._socks)):
            self._rpc(i, {"cmd": "barrier", "world": world})

    def stats(self) -> Dict:
        """Fan out: each table reported by its OWNING server (tables are
        partitioned table_id % nservers)."""
        out: Dict = {}
        n = len(self._socks)
        for i in range(n):
            for tid, st in self._rpc(i, {"cmd": "stats"}).items():
                if int(tid) % n == i:
                    out[int(tid)] = st
        return out

    def save(self) -> Dict:
        """Fan out like stats — server 0's copies of tables it doesn't own
        were never updated and must not land in the checkpoint."""
        out: Dict = {}
        n = len(self._socks)
        for i in range(n):
            for tid, val in self._rpc(i, {"cmd": "save"}).items():
                if int(tid) % n == i:
                    out[int(tid)] = val
        return out

    def stop_server(self):
        for i in range(len(self._socks)):
            try:
                self._rpc(i, {"cmd": "stop"})
            except (RuntimeError, OSError):
                pass

    def close(self):
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass


class GeoWorker:
    """Geo-async dense training (reference: GeoCommunicator,
    communicator.cc + sparse_geo_table.cc): the worker trains on a LOCAL
    copy and every k steps pushes the accumulated delta, pulling the
    merged global value back."""

    def __init__(self, client: PsClient, table_id: int, k_steps: int = 4):
        self._client = client
        self._table = table_id
        self._k = k_steps
        self._i = 0
        self.value = client.pull_dense(table_id)
        self._base = self.value.copy()

    def local_update(self, grad: np.ndarray, lr: float):
        self.value -= lr * np.asarray(grad, np.float32)
        self._i += 1
        if self._i % self._k == 0:
            self._sync()

    def _sync(self):
        delta = self.value - self._base
        # server-side table for geo mode uses the 'sum' rule: += delta
        self._client.push_dense(self._table, delta)
        self.value = self._client.pull_dense(self._table)
        self._base = self.value.copy()
