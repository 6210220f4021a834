"""PS server: the RPC endpoint hosting the tables (port of
paddle_tpu/distributed/ps/server.py; reference:
distributed/service/brpc_ps_server.cc, the pull_dense / push_dense /
pull_sparse / push_sparse / barrier / stop_server handlers, and
fleet/runtime/the_one_ps.py run_server).

Transport: length-prefixed pickle frames (an 8-byte little-endian
length, then pickle protocol 4 of a plain dict of numbers, strings and
numpy arrays) over TCP, one thread per connection: the JAX package's
wire format, so a port client talks to a JAX server and the other way
round. A frame is read into one preallocated buffer (linear in its
size, where the JAX package's loop is quadratic).
"""
from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
from typing import Dict

from .table import DenseTable, SparseTable

__all__ = ["ParameterServer"]


def send_msg(sock: socket.socket, obj):
    blob = pickle.dumps(obj, protocol=4)
    sock.sendall(struct.pack("<Q", len(blob)) + blob)


def recv_msg(sock: socket.socket):
    hdr = _recv_exact(sock, 8)
    if hdr is None:
        return None
    (n,) = struct.unpack("<Q", hdr)
    blob = _recv_exact(sock, n)
    return pickle.loads(blob) if blob is not None else None


def _recv_exact(sock, n):
    # into one preallocated buffer: growing a bytes object chunk by chunk
    # (the JAX package's loop) copies quadratically, minutes for a
    # frame of a few hundred MB
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


class ParameterServer:
    """Hosts dense/sparse tables; serves pull/push/barrier/save RPCs."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 barrier_timeout: float = 60.0):
        self._tables: Dict[int, object] = {}
        self._barrier_waiting = 0
        self._barrier_gen = 0
        self._barrier_timeout = barrier_timeout
        self._barrier_cv = threading.Condition()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    msg = recv_msg(self.request)
                    if msg is None:
                        return
                    try:
                        out = outer._dispatch(msg)
                    except Exception as e:  # report to client, keep serving
                        out = {"status": "error", "error": repr(e)}
                    send_msg(self.request, out)
                    if msg.get("cmd") == "stop":
                        return

        class Srv(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Srv((host, port), Handler)
        self.endpoint = "%s:%d" % self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    # --------------------------------------------------------------- tables
    def add_dense_table(self, table_id: int, shape, optimizer="sgd",
                        lr=0.01, initializer=None):
        self._tables[table_id] = DenseTable(table_id, shape, optimizer, lr,
                                            initializer)

    def add_sparse_table(self, table_id: int, dim: int, optimizer="sgd",
                         lr=0.01, initializer=None):
        self._tables[table_id] = SparseTable(table_id, dim, optimizer, lr,
                                             initializer)

    # ------------------------------------------------------------------ rpc
    def _dispatch(self, msg):
        cmd = msg["cmd"]
        if cmd == "pull_dense":
            return {"status": "ok",
                    "value": self._tables[msg["table"]].pull()}
        if cmd == "push_dense":
            self._tables[msg["table"]].push(msg["grad"])
            return {"status": "ok"}
        if cmd == "set_dense":
            self._tables[msg["table"]].set(msg["value"])
            return {"status": "ok"}
        if cmd == "pull_sparse":
            return {"status": "ok",
                    "value": self._tables[msg["table"]].pull(msg["ids"])}
        if cmd == "push_sparse":
            self._tables[msg["table"]].push(msg["ids"], msg["grads"])
            return {"status": "ok"}
        if cmd == "set_sparse":
            self._tables[msg["table"]].set(msg["ids"], msg["values"],
                                           msg.get("states"))
            return {"status": "ok"}
        if cmd == "pull_sparse_state":
            return {"status": "ok",
                    "value": self._tables[msg["table"]].pull_state(
                        msg["ids"])}
        if cmd == "barrier":
            # generation-counted barrier: predicate loop against spurious
            # wakeups; a timeout is an ERROR (an unsynchronized 'ok' would
            # corrupt training), and the timed-out waiter removes itself so
            # the next round's count stays correct.
            with self._barrier_cv:
                gen = self._barrier_gen
                self._barrier_waiting += 1
                if self._barrier_waiting >= msg["world"]:
                    self._barrier_waiting = 0
                    self._barrier_gen += 1
                    self._barrier_cv.notify_all()
                    return {"status": "ok"}
                released = self._barrier_cv.wait_for(
                    lambda: self._barrier_gen != gen,
                    timeout=self._barrier_timeout)
                if not released:
                    self._barrier_waiting -= 1
                    return {"status": "error",
                            "error": "barrier timeout: not all workers "
                                     "arrived within "
                                     f"{self._barrier_timeout}s"}
            return {"status": "ok"}
        if cmd == "save":
            return {"status": "ok",
                    "value": {tid: t.save()
                              for tid, t in self._tables.items()}}
        if cmd == "stats":
            return {"status": "ok", "value": {
                tid: {"type": type(t).__name__,
                      "push_count": t.push_count,
                      "rows": getattr(t, "size", None)}
                for tid, t in self._tables.items()}}
        if cmd == "stop":
            threading.Thread(target=self._server.shutdown,
                             daemon=True).start()
            return {"status": "ok"}
        return {"status": "error", "error": f"unknown cmd {cmd!r}"}

    # -------------------------------------------------------------- control
    def start(self):
        """reference: fleet.run_server (non-blocking here; join() blocks)."""
        self._thread.start()
        return self

    def join(self):
        self._thread.join()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
