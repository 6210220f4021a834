"""Capped-backoff restart policy (part of paddle_tpu/distributed/elastic.py).

Port of the reference's `BackoffPolicy`, the delay schedule that both
restart supervisors of the system share: the trainer-level
ElasticSupervisor and the serving replica supervisor
(inference/serving/replica.py). Host Python only; the same seeded
`random.Random` stream as the reference, so a given seed gives the
reference's delays exactly.

Not ported yet (ROADMAP Queue 1 item 6): ElasticSupervisor, WorkerSpec,
elastic_spawn, ElasticJobError and the worker heartbeat file.
"""
from __future__ import annotations

import random
from typing import Optional

__all__ = ["BackoffPolicy"]


class BackoffPolicy:
    """Capped exponential restart backoff with seeded multiplicative
    jitter: delay(n) = min(max_delay, base * factor**n) * (1 + U[0,
    jitter)). One object serves every replica of a fleet, so a
    correlated failure of many replicas never restarts them in
    lockstep."""

    def __init__(self, base: float = 0.25, factor: float = 2.0,
                 max_delay: float = 30.0, jitter: float = 0.25,
                 seed: Optional[int] = None):
        self.base = float(base)
        self.factor = float(factor)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def delay(self, n_prev_restarts: int) -> float:
        """Delay before restart #(n_prev_restarts+1) of one worker."""
        d = self.base * (self.factor ** n_prev_restarts)
        d = min(d, self.max_delay)
        return d * (1.0 + self.jitter * self._rng.random())
