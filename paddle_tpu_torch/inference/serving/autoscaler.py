"""Telemetry-driven, role-aware autoscaler over a ReplicaSet.

Port of paddle_tpu/inference/serving/autoscaler.py (host Python). The
Autoscaler decides WHEN to use the replica lifecycle the router already
has; it adds no mechanism of its own:

- SHRINK parks a replica through the evacuating drain
  (`ReplicaSet.drain(index, recompute=False)`): live KV blocks migrate
  to survivors, queued requests re-dispatch from the router's token
  log, nothing is recomputed or lost. The slot parks DRAINED with its
  engine warm.
- GROW returns a parked slot through a warmup-probe rejoin
  (`ReplicaSet.probe_grow(index)`): the slot must serve a 1-token greedy
  probe before real traffic routes there.

The router's replica list is fixed at construction, so the autoscaler
scales the ACTIVE set of a max-provisioned fleet: build the ReplicaSet
at `max_replicas` and let the autoscaler park what the load does not
need. A parked replica holds no work and does not step; its cost is its
idle pool memory.

Signals (AutoscalerPolicy.decide, a pure function): queue pressure
(waiting requests per serving replica, with the per-tenant split
alongside), block headroom (the free-block fraction across live pools)
and the router's TTFT p99 against an optional SLO. The measured phase
split (summed time_prefill against time_decode over serving engines)
picks WHICH role to grow or shrink in a disaggregated fleet; mixed
slots are eligible on both sides. In a multi-model fleet growth lands
in the hottest model's pool and shrink drains the coldest, never a
model's last serving replica.

Thread contract: `Autoscaler._lock` is the outermost serving lock:
step() holds it while calling the ReplicaSet's control surfaces, which
take the router lock and then replica / engine / scheduler locks.
Nothing in the serving stack calls back into the autoscaler.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from ... import obs
from .replica import ReplicaState

__all__ = ["Autoscaler", "AutoscalerConfig", "AutoscalerPolicy"]


@dataclass
class AutoscalerConfig:
    # fleet bounds on the ACTIVE (admission-eligible) set
    min_replicas: int = 1
    max_replicas: Optional[int] = None   # None: the provisioned fleet
    # queue pressure thresholds, in waiting requests per serving replica
    target_waiting_per_replica: float = 8.0   # grow above this
    low_waiting_per_replica: float = 1.0      # shrink below this
    # grow when the aggregate free-block fraction across live pools
    # drops below this (admission is about to hit watermark holds)
    min_headroom_frac: float = 0.10
    # grow when router TTFT p99 breaches this (None: ignore TTFT)
    ttft_p99_slo_s: Optional[float] = None
    # steps to hold after any action (probe + evacuation both perturb
    # the very signals the policy reads; don't chase the transient)
    cooldown_steps: int = 8
    # phase-split fraction above which prefill is "the bottleneck"
    prefill_heavy_frac: float = 0.55

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas is not None \
                and self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if self.low_waiting_per_replica > self.target_waiting_per_replica:
            raise ValueError(
                "low_waiting_per_replica must not exceed "
                "target_waiting_per_replica")
        if not 0.0 <= self.min_headroom_frac < 1.0:
            raise ValueError("min_headroom_frac must be in [0, 1)")
        if self.cooldown_steps < 0:
            raise ValueError("cooldown_steps must be >= 0")


class AutoscalerPolicy:
    """Pure decision function: signals in, verdict out. Stateless so
    tests drive it with synthetic signal dicts and the Autoscaler's
    locking/cooldown machinery stays out of the picture."""

    def __init__(self, config: AutoscalerConfig):
        self.config = config

    def decide(self, signals: dict) -> dict:
        """Map one signal snapshot to {action, reason, role_pref}.

        `signals` keys (Autoscaler.collect_signals builds them):
          up             serving replica count (admission-eligible)
          parked         parked (DRAINED) replica count
          waiting_total  waiting requests across serving replicas
          free_frac      aggregate free-block fraction (1.0 when no
                         live pool is visible)
          ttft_p99       router TTFT p99 seconds (0.0 before data)
          prefill_frac   time_prefill / (time_prefill + time_decode)
                         across serving engines (0.5 before data)
        """
        cfg = self.config
        up = signals["up"]
        pressure_role = "prefill" \
            if signals.get("prefill_frac", 0.5) >= cfg.prefill_heavy_frac \
            else "decode"
        per = signals["waiting_total"] / max(up, 1)
        if up < cfg.min_replicas:
            return {"action": "grow", "reason": "below_min",
                    "role_pref": pressure_role}
        cap = cfg.max_replicas
        can_grow = signals["parked"] > 0 and (cap is None or up < cap)
        if can_grow:
            if per > cfg.target_waiting_per_replica:
                return {"action": "grow", "reason": "queue_pressure",
                        "role_pref": pressure_role}
            if signals["free_frac"] < cfg.min_headroom_frac:
                return {"action": "grow", "reason": "block_headroom",
                        "role_pref": pressure_role}
            if cfg.ttft_p99_slo_s is not None \
                    and signals["ttft_p99"] > cfg.ttft_p99_slo_s:
                return {"action": "grow", "reason": "ttft_slo",
                        "role_pref": pressure_role}
        if up > cfg.min_replicas \
                and per < cfg.low_waiting_per_replica \
                and signals["free_frac"] >= cfg.min_headroom_frac \
                and (cfg.ttft_p99_slo_s is None
                     or signals["ttft_p99"] <= cfg.ttft_p99_slo_s):
            # shrink the role the measured split says is OVER-provided:
            # prefill-heavy load keeps prefill slots, sheds decode
            shed = "decode" if pressure_role == "prefill" else "prefill"
            return {"action": "shrink", "reason": "idle_capacity",
                    "role_pref": shed}
        return {"action": "hold", "reason": "steady",
                "role_pref": pressure_role}


class Autoscaler:
    """Closed-loop fleet sizing over one ReplicaSet (module docstring).
    Drive `step()` from the serving loop — typically once per router
    step or per intake batch; it is cheap (host-side reads) and
    rate-limits itself through the cooldown."""

    _GUARDED_BY = {
        "steps": "_lock",
        "cooldown": "_lock",
        "grow_events": "_lock",
        "shrink_events": "_lock",
        "last_decision": "_lock",
    }

    def __init__(self, rs, config: AutoscalerConfig = None):
        self.rs = rs
        self.config = config or AutoscalerConfig()
        self.policy = AutoscalerPolicy(self.config)
        self._lock = threading.RLock()
        self.steps = 0
        self.cooldown = 0
        self.grow_events = 0
        self.shrink_events = 0
        self.last_decision: dict = {"action": "hold", "reason": "init",
                                    "role_pref": "decode"}
        lbl = dict(router=rs.label)
        self._g_active = obs.gauge(
            "serving_fleet_active",
            "replicas currently accepting admissions (autoscaler-"
            "managed active set)", labels=("router",)).labels(**lbl)
        self._c_events = obs.counter(
            "serving_autoscale_events_total",
            "autoscaler actions enacted, by direction (grow|shrink)",
            labels=("router", "direction"))
        self._g_active.set(rs.num_up())

    # ----------------------------------------------------------- signals
    def collect_signals(self) -> dict:
        """One host-side snapshot of the scaling inputs. Reads take the
        router/replica locks INSIDE this frame (lock order: Autoscaler
        outermost), never the reverse."""
        rs = self.rs
        up = 0
        parked = 0
        waiting_total = 0
        waiting_by_tenant: Dict[str, int] = {}
        free = 0
        total = 0
        t_prefill = 0.0
        t_decode = 0.0
        by_model: Dict[str, Dict[str, int]] = {}
        for rep in rs.replicas:
            ent = by_model.setdefault(
                rep.model, {"up": 0, "parked": 0, "waiting": 0})
            if rep.state == ReplicaState.DRAINED:
                parked += 1
                ent["parked"] += 1
            if not rep.accepts_admissions():
                continue
            up += 1
            ent["up"] += 1
            eng = rep.engine
            if eng is None:
                continue
            info = rep.load_info()
            waiting_total += info["waiting"]
            ent["waiting"] += info["waiting"]
            free += info["free_blocks"]
            total += eng.cache.num_blocks
            for t, n in eng.waiting_by_tenant().items():
                waiting_by_tenant[t] = waiting_by_tenant.get(t, 0) + n
            t_prefill += eng.stats.time_prefill
            t_decode += eng.stats.time_decode
        busy = t_prefill + t_decode
        return {
            "up": up,
            "parked": parked,
            "waiting_total": waiting_total,
            "waiting_by_tenant": waiting_by_tenant,
            "free_frac": free / total if total else 1.0,
            "ttft_p99": rs.ttft_quantile(0.99),
            "prefill_frac": t_prefill / busy if busy else 0.5,
            # per-model pool pressure (multi-model fleets): which pool
            # growth should land in / shrink should drain from
            "by_model": by_model,
        }

    # -------------------------------------------------------------- step
    def step(self) -> dict:
        """One control-loop tick: snapshot signals, decide, enact.
        Returns the decision dict (action/reason/role_pref plus an
        `enacted` flag and the chosen replica index, or None)."""
        with self._lock:
            self.steps += 1
            signals = self.collect_signals()
            if self.cooldown > 0:
                self.cooldown -= 1
                out = {"action": "hold", "reason": "cooldown",
                       "role_pref": None, "enacted": False,
                       "replica": None, "signals": signals}
                self.last_decision = out
                return out
            verdict = self.policy.decide(signals)
            out = dict(verdict)
            out["signals"] = signals
            out["enacted"] = False
            out["replica"] = None
            if verdict["action"] == "grow":
                idx = self._pick_grow(verdict["role_pref"],
                                      model=self._hot_model(signals))
                if idx is not None and self.rs.probe_grow(idx):
                    self.grow_events += 1
                    self.cooldown = self.config.cooldown_steps
                    self._c_events.labels(
                        router=self.rs.label, direction="grow").inc()
                    out["enacted"] = True
                    out["replica"] = idx
            elif verdict["action"] == "shrink":
                idx = self._pick_shrink(verdict["role_pref"],
                                        model=self._cold_model(signals))
                if idx is not None:
                    # evacuating drain: live blocks migrate, queued
                    # work re-dispatches — nothing recomputes or drops
                    self.rs.drain(idx, recompute=False)
                    self.shrink_events += 1
                    self.cooldown = self.config.cooldown_steps
                    self._c_events.labels(
                        router=self.rs.label, direction="shrink").inc()
                    out["enacted"] = True
                    out["replica"] = idx
            self._g_active.set(self.rs.num_up())
            self.last_decision = out
            return out

    # --------------------------------------------------------- selection
    def _hot_model(self, signals: dict) -> Optional[str]:
        """The model pool growth should land in: highest waiting per
        serving replica among models that HAVE a parked slot to give
        back. None in single-model fleets (no preference)."""
        by = signals.get("by_model") or {}
        if len(by) < 2:
            return None
        cands = {m: e for m, e in by.items() if e["parked"] > 0}
        if not cands:
            return None
        return max(sorted(cands),
                   key=lambda m: cands[m]["waiting"]
                   / max(cands[m]["up"], 1))

    def _cold_model(self, signals: dict) -> Optional[str]:
        """The model pool shrink should drain from: lowest waiting per
        serving replica among models that keep >= 1 serving replica
        after the drain. None in single-model fleets."""
        by = signals.get("by_model") or {}
        if len(by) < 2:
            return None
        cands = {m: e for m, e in by.items() if e["up"] > 1}
        if not cands:
            return None
        return min(sorted(cands),
                   key=lambda m: cands[m]["waiting"] / cands[m]["up"])

    def _pick_grow(self, role_pref: str, model: str = None
                   ) -> Optional[int]:
        """Parked slot to rejoin: preferred model pool first (hottest —
        multi-model fleets), then preferred role, then mixed, then
        whatever is parked — availability beats tiering, same rule the
        router's admission fallback uses."""
        parked = [r for r in self.rs.replicas
                  if r.state == ReplicaState.DRAINED]
        if model is not None:
            parked = [r for r in parked if r.model == model] or parked
        for want in (role_pref, "mixed"):
            for rep in parked:
                if rep.role == want:
                    return rep.index
        return parked[0].index if parked else None

    def _pick_shrink(self, role_pref: str, model: str = None
                     ) -> Optional[int]:
        """Active slot to park: among UP replicas (never touch DRAINING
        — one evacuation at a time), prefer the cold model's pool, then
        the shed role, then mixed; within a role, drain the emptiest
        slot (cheapest evacuation). Refuses to take the active set
        below min_replicas, and never parks a model's LAST serving
        replica (a registered pool must stay routable)."""
        ups = [r for r in self.rs.replicas
               if r.state == ReplicaState.UP]
        if len(ups) <= self.config.min_replicas:
            return None
        serving_by_model: Dict[str, int] = {}
        for r in self.rs.replicas:
            if r.accepts_admissions():
                serving_by_model[r.model] = \
                    serving_by_model.get(r.model, 0) + 1
        if len(serving_by_model) > 1:
            ups = [r for r in ups
                   if serving_by_model.get(r.model, 0) > 1]
            if not ups:
                return None
        if model is not None:
            ups = [r for r in ups if r.model == model] or ups
        def emptiest(reps: List) -> Optional[int]:
            best, best_load = None, None
            for rep in reps:
                info = rep.load_info()
                load = info["waiting"] + info["running"]
                if best_load is None or load < best_load:
                    best, best_load = rep.index, load
            return best
        for want in (role_pref, "mixed"):
            cand = [r for r in ups if r.role == want]
            # keep at least one slot of a dedicated role serving: a
            # disaggregated fleet with zero prefill (or zero decode)
            # capacity wedges that phase entirely
            if want != "mixed" and len(cand) <= 1:
                continue
            if cand:
                return emptiest(cand)
        return emptiest(ups)
