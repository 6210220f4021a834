"""Multi-tenant serving: tenants as first-class scheduling objects.

Port of paddle_tpu/inference/serving/tenancy.py. Different callers
have different latency contracts and traffic shapes; a `TenantConfig`
carries what admission needs to price one tenant's work:

- `priority` class (PRIORITY_CLASSES) and `weight`: the tenant's fair
  share of admission cost. The WFQ weight is `weight` times the class
  multiplier, and cost is the prefill cost model's price of the whole
  prompt (analysis/jaxplan.PrefillCostModel), so one long prompt charges
  its quadratic attention cost against the share.
- `quota_tokens` per `quota_window_s`: a sliding-window token budget
  (prompt + max_tokens, charged at admission, refunded if admission is
  refused downstream). Exhaustion raises TenantQuotaExceeded, an
  EngineOverloaded with a `retry_after_s` hint from the window.
- `ttft_slo_s` / `deadline_slo_s`: the latency contract; the scheduler
  refuses at the door a request that provably cannot start before its
  deadline at the measured service rate.
- `prefix_share`: the tenant's weight in prefix-cache eviction.

The scheduler consumes the registry for WFQ admission and the paged
cache for share-weighted trie eviction. Lock order: the registry's lock
is taken under the engine's and the scheduler's and takes nothing
itself. A stack built without a registry never touches this module, and
a registry holding only the default tenant leaves admission FCFS.

Left out: the autoscaler that reads per-tenant pressure (a later
slice, with the router).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .scheduler import EngineOverloaded

__all__ = ["DEFAULT_TENANT", "PRIORITY_CLASSES", "TenantConfig",
           "TenantQuotaExceeded", "TenantRegistry"]

DEFAULT_TENANT = "default"

# priority class -> WFQ weight multiplier. Classes are coarse knobs on
# top of the per-tenant weight: `batch` tenants cede admission FLOPs to
# `standard`, which cedes to `latency`.
PRIORITY_CLASSES = {"batch": 0.25, "standard": 1.0, "latency": 4.0}


class TenantQuotaExceeded(EngineOverloaded):
    """A tenant's sliding-window token quota is spent. Subclasses
    EngineOverloaded so every backpressure path (client retry_after_s
    plumbing, stats.rejected) handles it unchanged; `depth`/`limit`
    carry window spend / quota."""

    def __init__(self, request_id, tenant: str, spent: int, quota: int,
                 retry_after_s: Optional[float] = None):
        super().__init__(request_id, spent, quota,
                         retry_after_s=retry_after_s)
        self.tenant = tenant


@dataclass(frozen=True)
class TenantConfig:
    """One tenant's scheduling contract (module docstring)."""
    name: str
    priority: str = "standard"           # PRIORITY_CLASSES key
    weight: float = 1.0                  # WFQ share within the class
    quota_tokens: Optional[int] = None   # tokens per window (None = ∞)
    quota_window_s: float = 60.0
    ttft_slo_s: Optional[float] = None   # autoscaler growth gate
    deadline_slo_s: Optional[float] = None  # static early-reject bound
    prefix_share: float = 1.0            # trie-eviction share weight

    def __post_init__(self):
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: priority {self.priority!r} not "
                f"in {tuple(PRIORITY_CLASSES)}")
        if self.weight <= 0 or self.prefix_share <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight and prefix_share must "
                f"be positive")
        if self.quota_tokens is not None and self.quota_tokens <= 0:
            raise ValueError(
                f"tenant {self.name!r}: quota_tokens must be positive "
                f"or None")
        if self.quota_window_s <= 0:
            raise ValueError(
                f"tenant {self.name!r}: quota_window_s must be positive")

    @property
    def wfq_weight(self) -> float:
        """Effective fair-share weight: class multiplier × weight."""
        return PRIORITY_CLASSES[self.priority] * self.weight


class TenantRegistry:
    """Fleet-wide tenant table + sliding-window quota accounting.

    `version` increments on every registration so consumers (the
    scheduler's weight snapshot, the cache's eviction shares) can cache
    derived views and refresh only on change. All mutable state lives
    under one lock.
    """

    def __init__(self, tenants=()):
        self._lock = threading.RLock()
        self._tenants: Dict[str, TenantConfig] = {
            DEFAULT_TENANT: TenantConfig(DEFAULT_TENANT)}
        # tenant -> deque[(monotonic_ts, tokens)] inside the window
        self._spend: Dict[str, deque] = {}
        # (tenant, model) -> net tokens charged, cumulative: the
        # per-model billing breakdown. Quota itself stays per-tenant
        # across models.
        self._model_spend: Dict[Tuple[str, str], int] = {}
        self.version = 1
        for cfg in tenants:
            self.register(cfg)

    # ------------------------------------------------------------ table
    def register(self, cfg: TenantConfig) -> TenantConfig:
        """Add or replace one tenant's config."""
        if not isinstance(cfg, TenantConfig):
            raise TypeError(f"expected TenantConfig, got {type(cfg)}")
        with self._lock:
            self._tenants[cfg.name] = cfg
            self.version += 1
            return cfg

    def resolve(self, name: str) -> TenantConfig:
        """Admission-time lookup; unknown tenants are refused loudly —
        an unregistered id is a caller bug, not a new tenant."""
        with self._lock:
            cfg = self._tenants.get(name)
            if cfg is None:
                raise ValueError(
                    f"unknown tenant {name!r}; registered: "
                    f"{sorted(self._tenants)}")
            return cfg

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._tenants))

    def wfq_weights(self) -> Dict[str, float]:
        """Snapshot of effective WFQ weights (scheduler refresh)."""
        with self._lock:
            return {n: c.wfq_weight for n, c in self._tenants.items()}

    def prefix_shares(self) -> Dict[str, float]:
        """Snapshot of trie-eviction shares (cache refresh)."""
        with self._lock:
            return {n: c.prefix_share for n, c in self._tenants.items()}

    # ------------------------------------------------------------ quota
    def charge(self, name: str, tokens: int,
               now: Optional[float] = None,
               model: Optional[str] = None) -> None:
        """Charge `tokens` against the tenant's sliding window; raises
        TenantQuotaExceeded (with a retry_after_s hint — when the
        oldest window entry expires) once the window is spent. The
        caller refunds on a downstream admission refusal so a rejected
        request never burns quota. `model` tags the charge for the
        per-model billing breakdown (model_spend); quota enforcement
        is model-blind."""
        with self._lock:
            cfg = self._tenants.get(name)
            if cfg is None:
                raise ValueError(f"unknown tenant {name!r}")
            if model is not None:
                key = (name, model)
                self._model_spend[key] = \
                    self._model_spend.get(key, 0) + int(tokens)
            if cfg.quota_tokens is None:
                return
            now = time.monotonic() if now is None else now
            window = self._spend.setdefault(name, deque())
            horizon = now - cfg.quota_window_s
            while window and window[0][0] <= horizon:
                window.popleft()
            spent = sum(t for _, t in window)
            if spent + tokens > cfg.quota_tokens:
                retry = round(window[0][0] - horizon, 3) if window \
                    else round(cfg.quota_window_s, 3)
                if model is not None:
                    # refused before commit: the breakdown must not
                    # show tokens the tenant never got to spend
                    self._model_spend[(name, model)] -= int(tokens)
                raise TenantQuotaExceeded(
                    None, name, spent + tokens, cfg.quota_tokens,
                    retry_after_s=max(retry, 0.001))
            window.append((now, int(tokens)))

    def refund(self, name: str, tokens: int,
               model: Optional[str] = None) -> None:
        """Return a charge whose admission was refused downstream (the
        scheduler's queue bound or deadline early-reject fired after
        quota accepted). Removes the most recent matching charge."""
        with self._lock:
            if model is not None:
                key = (name, model)
                if key in self._model_spend:
                    self._model_spend[key] = max(
                        self._model_spend[key] - int(tokens), 0)
            window = self._spend.get(name)
            if not window:
                return
            for i in range(len(window) - 1, -1, -1):
                if window[i][1] == tokens:
                    del window[i]
                    return
            window.pop()

    def model_spend(self) -> Dict[str, Dict[str, int]]:
        """Cumulative net tokens charged, per tenant per model. Empty
        until a charge carries a model tag."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for (tenant, model), tok in sorted(self._model_spend.items()):
                out.setdefault(tenant, {})[model] = tok
            return out

    def window_spend(self, name: str,
                     now: Optional[float] = None) -> int:
        """Tokens charged inside the tenant's current window."""
        with self._lock:
            cfg = self._tenants.get(name)
            window = self._spend.get(name)
            if cfg is None or not window:
                return 0
            now = time.monotonic() if now is None else now
            horizon = now - cfg.quota_window_s
            return sum(t for ts, t in window if ts > horizon)

    def as_dict(self) -> dict:
        with self._lock:
            return {n: {"priority": c.priority, "weight": c.weight,
                        "wfq_weight": c.wfq_weight,
                        "quota_tokens": c.quota_tokens,
                        "quota_window_s": c.quota_window_s,
                        "ttft_slo_s": c.ttft_slo_s,
                        "deadline_slo_s": c.deadline_slo_s,
                        "prefix_share": c.prefix_share}
                    for n, c in sorted(self._tenants.items())}
