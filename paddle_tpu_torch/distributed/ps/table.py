"""PS table storage (port of paddle_tpu/distributed/ps/table.py;
reference: paddle/fluid/distributed/table/common_dense_table.cc, dense
parameters with pull/push and the optimizer rule applied server-side;
common_sparse_table.cc, rows created on first access with per-row
optimizer state; sparse_geo_table.cc, delta accumulation).

Host numpy storage with the sgd, adagrad and sum rules, the JAX
package's arithmetic line for line. The bulk row operations walk ids as
Python ints and `set` keeps its rows as views of one owned copy (the
same values; a 2^20-row pull or set takes about a second, not several).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

__all__ = ["DenseTable", "SparseTable"]


class _SgdRule:
    def __init__(self, lr):
        self.lr = lr

    def apply(self, value, grad, state):
        value -= self.lr * grad
        return state


class _AdagradRule:
    def __init__(self, lr, eps=1e-6):
        self.lr = lr
        self.eps = eps

    def apply(self, value, grad, state):
        if state is None:
            state = np.zeros_like(value)
        state += grad * grad
        value -= self.lr * grad / (np.sqrt(state) + self.eps)
        return state


def _make_rule(name: str, lr: float):
    if name in ("sgd", "SGD"):
        return _SgdRule(lr)
    if name in ("adagrad", "Adagrad"):
        return _AdagradRule(lr)
    if name == "sum":  # raw accumulate (geo merge)
        class _Sum:
            def apply(self, value, grad, state):
                value += grad
                return state
        return _Sum()
    raise ValueError(f"unknown PS optimizer rule {name!r}")


class DenseTable:
    """reference: common_dense_table.cc — one contiguous param block."""

    def __init__(self, table_id: int, shape, optimizer="sgd", lr=0.01,
                 initializer=None):
        self.table_id = table_id
        self._value = (np.zeros(shape, np.float32) if initializer is None
                       else np.asarray(initializer(), np.float32))
        self._state: Optional[np.ndarray] = None
        self._rule = _make_rule(optimizer, lr)
        self._lock = threading.Lock()
        self.push_count = 0

    def pull(self) -> np.ndarray:
        with self._lock:
            return self._value.copy()

    def push(self, grad: np.ndarray):
        with self._lock:
            self._state = self._rule.apply(self._value,
                                           np.asarray(grad, np.float32),
                                           self._state)
            self.push_count += 1

    def set(self, value: np.ndarray):
        with self._lock:
            self._value = np.asarray(value, np.float32)

    def save(self):
        with self._lock:
            return self._value.copy()


class SparseTable:
    """reference: common_sparse_table.cc — rows created on first access
    ('lazy init', the PS trick that makes trillion-feature embeddings
    feasible); per-row optimizer state."""

    def __init__(self, table_id: int, dim: int, optimizer="sgd", lr=0.01,
                 initializer=None):
        self.table_id = table_id
        self.dim = dim
        self._rows: Dict[int, np.ndarray] = {}
        self._state: Dict[int, np.ndarray] = {}
        self._rule = _make_rule(optimizer, lr)
        self._init = initializer or (
            lambda: np.random.normal(0, 0.01, dim).astype(np.float32))
        self._lock = threading.Lock()
        self.push_count = 0

    def _row(self, rid: int) -> np.ndarray:
        r = self._rows.get(rid)
        if r is None:
            r = self._init()
            self._rows[rid] = r
        return r

    def pull(self, ids) -> np.ndarray:
        with self._lock:
            # lazy init runs the initializer under the lock: each row is
            # created exactly once (_row's rule, inlined: a call a row
            # doubles a 2^20-row pull)
            rows, out = self._rows, []
            for i in np.asarray(ids).tolist():
                r = rows.get(i)
                if r is None:
                    r = rows[i] = self._init()
                out.append(r)
            return np.stack(out)

    def push(self, ids, grads):
        grads = np.asarray(grads, np.float32)
        with self._lock:
            for i, g in zip(np.asarray(ids), grads):
                rid = int(i)
                self._state[rid] = self._rule.apply(
                    self._row(rid), g, self._state.get(rid))
            self.push_count += 1

    def set(self, ids, values, states=None):
        """Direct row assignment (reference: PSGPU EndPass dumps the
        device-trained rows AND their per-row optimizer state back,
        ps_gpu_wrapper.cc — g2sum travels with the feature value).
        The rows become rows of one copy the table owns (a copy a row
        costs seconds at 2^20 rows)."""
        values = np.array(values, np.float32)
        if states is not None:
            states = np.array(states, np.float32)
        with self._lock:
            for n, i in enumerate(np.asarray(ids).tolist()):
                self._rows[i] = values[n]
                if states is not None:
                    self._state[i] = states[n]

    def pull_state(self, ids) -> np.ndarray:
        """Per-row optimizer state (zeros for rows with none yet) — the
        device cache loads this so adagrad step sizes continue rather
        than reset across the host/device boundary."""
        with self._lock:
            zeros = np.zeros(self.dim, np.float32)   # stacked, so shared
            return np.stack([self._state.get(i, zeros)
                             for i in np.asarray(ids).tolist()])

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._rows)

    def save(self):
        with self._lock:
            return {int(k): v.copy() for k, v in self._rows.items()}
