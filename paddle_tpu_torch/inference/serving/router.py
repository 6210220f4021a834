"""ReplicaSet: N supervised LLMEngine replicas behind one front-end.

Port of paddle_tpu/inference/serving/router.py (host Python: the router
owns no device work and adds no host syncs; every replica's engine does
its own). N engine replicas (replica.py supervises each) sit behind one
`add_request` / `step` / `run` surface:

- ADMISSION routes each request to the replica with the most effective
  headroom: free blocks minus the replica's outstanding block demand,
  tie-broken by the smallest queued re-prefill cost (priced by the
  engines' prefill cost model when they carry one). `balance=
  "round_robin"` rotates instead; `balance="prefix_affinity"` sends a
  prompt to the replica its leading full blocks rendezvous-hash to
  (highest random weight over replica indices), so requests sharing a
  template prefix land where its KV blocks live, unless that replica
  lacks headroom for the request, when the free-block order decides.
- FAILOVER: a replica that crashes (its step raises) or wedges (its
  heartbeat goes stale past `heartbeat_timeout_s` while it holds work)
  is quarantined, its engine dropped unread, and every one of its
  in-flight and queued requests re-admitted to survivors in ORIGINAL
  arrival order, with its original arrival time and FCFS ticket and the
  tokens already streamed (re-prefill from the router's token log).
  Requests on untouched replicas are not perturbed; deadlines keep
  counting from the original arrival.
- RECOVERY: failed replicas restart with capped backoff
  (distributed.elastic.BackoffPolicy) and rejoin after a warmup probe;
  one that exhausts max_restarts parks FAILED. With no survivor up,
  victims wait in the orphan queue (arrival order) and re-admit the
  moment a replica rejoins; only when every replica is FAILED do they
  end 'error'.
- BACKPRESSURE: `max_waiting` bounds the total waiting depth across up
  replicas; 'reject' raises EngineOverloaded with a `retry_after_s`
  hint, 'shed_oldest' sheds the globally oldest waiting request.
- TIERS and MIGRATION (migration.py): `roles` splits the fleet into
  prefill / decode / mixed replicas; a prefill replica hands every
  request that finishes prefill to the decode tier by live KV-block
  migration. `rebalance`, `drain(recompute=False)` and peer prefix
  fetch (`peer_prefix_fetch`) use the same transactional primitive.
- MULTI-MODEL (deploy.py): with `config.models` a ModelRegistry, each
  replica belongs to one model's pool, `SamplingParams.model` picks the
  pool, and per-model revision route weights split a pool's traffic
  across revisions. Every request is pinned to the revision that
  admitted it (obs/reqtrace.py invariant 8): migrated KV moves only
  between replicas of one (model, revision) key, and the only legal
  revision crossing is a full re-dispatch, which records a fresh
  `admitted` event.

Observability: `serving_replica_up{router,replica}`,
`serving_failovers_total{router,replica,reason}`,
`serving_requeued_total{router}`, `serving_router_ttft_seconds{router}`
(first token as the client sees it, across failovers) and
`serving_failover_recovery_seconds{router}` (quarantine -> back UP).

Replicas step one after another on the caller's thread (on CUDA, the
device's default stream). `from_model` and `from_registry` build every
engine over one shared copy of a revision's weights (detached views,
gen.extract_params), each with its own paged pool.

Thread contract: router tables are shared between the serving loop
(step/run) and intake threads (add_request/cancel); public entry points
take self._lock, private helpers run under it. Lock order: router ->
migration -> replica -> engine -> scheduler, never the reverse.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ... import obs
from ...distributed.elastic import BackoffPolicy
from .migration import BlockMigration
from .replica import EngineReplica, ReplicaCrashed, ReplicaState
from .scheduler import EngineOverloaded, SamplingParams
from .tenancy import TenantQuotaExceeded
from .engine import RequestOutput

__all__ = ["BALANCE_POLICIES", "ReplicaSet", "RouterConfig",
           "RouterRequest"]

BALANCE_POLICIES = ("free_blocks", "round_robin", "prefix_affinity")

_ROUTER_IDS = itertools.count()


def _model_device(model):
    """The device a model's parameters live on (where its engines run)."""
    return next(iter(model.parameters())).device


@dataclass
class RouterConfig:
    num_replicas: int = 2
    balance: str = "free_blocks"         # BALANCE_POLICIES
    # heartbeat-based wedge detection (None disables — crash failover
    # still works; wedges then surface only through engine watchdogs)
    heartbeat_timeout_s: Optional[float] = None
    # replica restart policy (distributed.elastic.BackoffPolicy)
    max_restarts: int = 3
    backoff_base: float = 0.25
    backoff_factor: float = 2.0
    backoff_max: float = 30.0
    backoff_jitter: float = 0.25
    backoff_seed: Optional[int] = None
    # router-level backpressure spanning replicas: TOTAL waiting bound
    max_waiting: Optional[int] = None
    admission_policy: str = "reject"     # 'reject' | 'shed_oldest'
    # prefix-affinity key width (balance="prefix_affinity"): how many
    # leading FULL blocks of the prompt feed the rendezvous hash. Wide
    # enough to separate templates, narrow enough that one template's
    # requests share a key whatever their unique suffixes
    affinity_prefix_blocks: int = 4
    # warmup probe for rejoining replicas (token ids; must be < vocab)
    probe_prompt: tuple = (1,)
    # disaggregated tiers (docs/serving.md "Disaggregated serving and
    # block migration"): one role per replica, 'prefill' | 'decode' |
    # 'mixed'. None keeps the homogeneous all-'mixed' fleet. New
    # prompts admit to the prefill/mixed tier; a prefill replica hands
    # every request that completes prefill off to the decode tier via
    # live KV-block migration (serving/migration.py)
    roles: Optional[tuple] = None
    # peer prefix fetch (docs/serving.md "Hierarchical KV-cache
    # tiering"): at dispatch, if a PEER replica holds at least one more
    # full block of the prompt's prefix than the chosen home, pull the
    # blocks over (BlockMigration.fetch_prefix — transactional, abort
    # leaves the destination untouched) before the request prefills.
    # Off by default: with balance="prefix_affinity" requests already
    # land where their prefix lives; this flag pays under round_robin /
    # free_blocks routing and after failovers scatter a template's
    # working set
    peer_prefix_fetch: bool = False
    # multi-model fleet (serving/deploy.py): a ModelRegistry resolving
    # SamplingParams.model to its published revisions. When set, each
    # replica belongs to ONE model's pool (its engine config's `model`),
    # admission/routing/failover stay inside that pool, and per-model
    # revision weights (set_route_weights / DeployController) split
    # traffic across revisions for A/B and rolling deploys. None keeps
    # the single-model fleet untagged and bit-identical.
    models: Optional[object] = None
    obs_label: Optional[str] = None


@dataclass
class RouterRequest:
    """Router-side record of one request: the authoritative copy of
    everything failover needs — prompt, params, ORIGINAL arrival
    stamps, and the token log as streamed to the client (the router
    never reads recovery state out of a dead engine)."""
    request_id: str
    prompt_ids: np.ndarray
    params: SamplingParams
    arrival_time: float
    arrival: int                         # global FCFS ticket
    replica: Optional[int]               # current home (None = orphaned)
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None
    requeues: int = 0                    # failover re-admissions
    first_token_time: Optional[float] = None
    # causal tracing (obs/reqtrace.py): the stable trace id minted at
    # router admission, and the replica a failover orphaned it from —
    # the re-admission event names its predecessor with it
    trace_id: str = ""
    prev_replica: Optional[int] = None
    # multi-model fleets (serving/deploy.py): the model pool this
    # request belongs to and the revision it is currently PINNED to
    # (the revision of the replica that admitted it — tokens may only
    # come from that revision; a re-pin records a fresh `admitted`)
    model: str = "default"
    revision: Optional[str] = None


class ReplicaSet:
    """N supervised engine replicas behind one serving surface (module
    docstring)."""

    _GUARDED_BY = {
        "_requests": "_lock",
        "_next_id": "_lock",
        "_next_trace": "_lock",
        "_readmit_seq": "_lock",
        "_rr_next": "_lock",
        "_orphans": "_lock",
        "_pending": "_lock",
        "_flights": "_lock",
        "_steps": "_lock",
        "_step_ewma": "_lock",
        "recovery_times": "_lock",
        "_route_weights": "_lock",
    }

    def __init__(self, engine_factory, config: RouterConfig = None,
                 faults=None):
        """`engine_factory(replica_index, incarnation) -> LLMEngine`
        builds each replica incarnation; `from_model` wires the common
        case. `faults` is a ServingFaultInjector shared by the router
        (kill_replica/wedge_replica hooks) and — when the factory passes
        it through, as from_model does — by every engine (the
        engine-level nan/stall/corrupt hooks keep working unchanged in
        multi-replica runs)."""
        config = config or RouterConfig()
        if config.num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {config.num_replicas}")
        if config.balance not in BALANCE_POLICIES:
            raise ValueError(
                f"balance must be one of {BALANCE_POLICIES}, got "
                f"{config.balance!r}")
        if config.admission_policy not in ("reject", "shed_oldest"):
            raise ValueError(
                f"admission_policy must be 'reject' or 'shed_oldest', "
                f"got {config.admission_policy!r}")
        roles = config.roles
        if roles is not None:
            if len(roles) != config.num_replicas:
                raise ValueError(
                    f"roles has {len(roles)} entries for "
                    f"{config.num_replicas} replicas")
            bad = [r for r in roles if r not in EngineReplica.ROLES]
            if bad:
                raise ValueError(
                    f"unknown replica roles {bad}; expected one of "
                    f"{EngineReplica.ROLES}")
            if "prefill" in roles and not any(
                    r in ("decode", "mixed") for r in roles):
                raise ValueError(
                    "a prefill tier needs at least one decode or mixed "
                    "replica to hand off to")
        else:
            roles = ("mixed",) * config.num_replicas
        self.config = config
        self.label = f"{config.obs_label or 'router'}-{next(_ROUTER_IDS)}"
        if faults is None:
            from ...testing.faults import ServingFaultInjector
            faults = ServingFaultInjector()
        self.faults = faults
        backoff = BackoffPolicy(base=config.backoff_base,
                                factor=config.backoff_factor,
                                max_delay=config.backoff_max,
                                jitter=config.backoff_jitter,
                                seed=config.backoff_seed)
        # the replica list itself is immutable after construction (each
        # EngineReplica carries its own lock); router tables below are
        # the shared-mutable state under self._lock
        self.replicas = [
            EngineReplica(i, engine_factory, backoff,
                          max_restarts=config.max_restarts,
                          heartbeat_timeout=config.heartbeat_timeout_s,
                          probe_prompt=config.probe_prompt,
                          role=roles[i])
            for i in range(config.num_replicas)]
        # migration coordinator: one per router, immutable after
        # construction (it carries its own lock)
        self.migrator = BlockMigration(self.label)
        self._lock = threading.RLock()
        self._requests: Dict[str, RouterRequest] = {}
        # per-model revision routing weights (A/B splits and canary
        # ramps, serving/deploy.py). Empty → every model routes to its
        # registry-active revision. Only consulted when config.models
        # is set; single-model fleets never look here.
        self._route_weights: Dict[str, Dict[str, float]] = {}
        self._next_id = 0
        self._next_trace = 0              # trace-id mint (reqtrace)
        self._readmit_seq = 0             # failover re-admission batches
        self._rr_next = 0                 # round_robin cursor
        self._orphans: List[RouterRequest] = []
        self._pending: List[RequestOutput] = []
        self._flights: List[tuple] = []   # deferred flight-recorder dumps
        self._steps = 0
        self._step_ewma = 0.05            # drain-rate estimate seed (s)
        self.recovery_times: List[float] = []
        lbl = dict(router=self.label)
        self._g_up = obs.gauge(
            "serving_replica_up",
            "1 while the replica accepts admissions, 0 while draining/"
            "down/failed", labels=("router", "replica"))
        self._c_failovers = obs.counter(
            "serving_failovers_total",
            "replica-level failovers by reason (crash|wedge)",
            labels=("router", "replica", "reason"))
        self._c_requeued = obs.counter(
            "serving_requeued_total",
            "requests re-admitted to a survivor (or orphaned) after "
            "their replica failed", labels=("router",)).labels(**lbl)
        self._h_ttft = obs.histogram(
            "serving_router_ttft_seconds",
            "client-visible time to first token across replicas and "
            "failovers", labels=("router",), unit="seconds").labels(**lbl)
        self._h_recovery = obs.histogram(
            "serving_failover_recovery_seconds",
            "quarantine -> rejoined-UP wall time per replica restart",
            labels=("router",), unit="seconds").labels(**lbl)
        g_role = obs.gauge(
            "serving_replica_role",
            "1 for the replica's assigned tier (prefill|decode|mixed)",
            labels=("router", "replica", "role"))
        for r in self.replicas:
            self._set_up_gauge(r)
            g_role.labels(router=self.label, replica=str(r.index),
                          role=r.role).set(1)

    @classmethod
    def from_model(cls, model, config: RouterConfig = None,
                   engine_config=None, faults=None):
        """Build a ReplicaSet of identical engines over one model's live
        parameters, on the model's own device (a model is built on CUDA
        unless told otherwise). The replicas share the weights; each gets
        its own paged pool and a per-replica obs label `<router>-r<i>`."""
        import dataclasses
        from .engine import EngineConfig, LLMEngine
        config = config or RouterConfig()
        ecfg = engine_config or EngineConfig()
        if faults is None:
            from ...testing.faults import ServingFaultInjector
            faults = ServingFaultInjector()
        base_label = config.obs_label or "router"
        device = _model_device(model)

        def factory(index, incarnation):
            cfg_i = dataclasses.replace(
                ecfg, obs_label=f"{base_label}-r{index}")
            return LLMEngine.from_model(model, cfg_i, faults=faults,
                                        device=device)

        return cls(factory, config, faults=faults)

    @classmethod
    def from_registry(cls, registry, assignments, config: RouterConfig
                      = None, faults=None):
        """Build a multi-model fleet over a ModelRegistry (deploy.py):
        `assignments[i]` names the model replica i serves, each pinned
        to the model's revision active at build time (a restart rebuilds
        the same revision; only a DeployController swap moves a slot
        forward). Engines run on each revision's model's device. The
        registry rides on config.models so admission, failover and
        migration stay inside each model's pool."""
        import dataclasses
        config = config or RouterConfig()
        if len(assignments) != config.num_replicas:
            raise ValueError(
                f"assignments names {len(assignments)} replicas but "
                f"num_replicas={config.num_replicas}")
        # one pinned factory per slot, resolved NOW: a later restart
        # (which runs the factory under EngineReplica._lock) rebuilds
        # the same revision without re-entering the registry
        pinned = tuple(registry.engine_factory(m, registry.active(m))
                       for m in assignments)
        config = dataclasses.replace(config, models=registry)

        def factory(index, incarnation):
            return pinned[index](index, incarnation)

        return cls(factory, config, faults=faults)

    # ------------------------------------------------------------ intake
    def add_request(self, prompt_ids, sampling: SamplingParams = None,
                    request_id: str = None) -> str:
        """Route one request to the best replica. Raises
        EngineOverloaded (with a retry_after_s hint) when no replica is
        up, or when the router-level waiting bound is hit under policy
        'reject'; under 'shed_oldest' the globally-oldest waiting
        request is shed instead."""
        sampling = sampling or SamplingParams()
        with self._lock:
            if request_id is None:
                request_id = f"rr-{self._next_id}"
                self._next_id += 1
            if request_id in self._requests:
                raise ValueError(f"duplicate request_id {request_id!r}")
            model = sampling.model
            registry = self.config.models
            if registry is not None and not registry.has_model(model):
                # a caller bug, not an overload: unknown models never
                # become routable by waiting
                raise ValueError(
                    f"unknown model {model!r}; registry serves "
                    f"{sorted(registry.models())}")
            ups = self._admission_candidates(model=model)
            if not ups:
                raise EngineOverloaded(
                    request_id, 0, 0,
                    retry_after_s=self._retry_after())
            limit = self.config.max_waiting
            if limit is not None:
                total = sum(r.load_info()["waiting"] for r in ups)
                if total >= limit:
                    if self.config.admission_policy == "reject":
                        raise EngineOverloaded(
                            request_id, total, limit,
                            retry_after_s=self._retry_after())
                    self._shed_globally_oldest(ups)
            ids = np.asarray(prompt_ids, np.int32).reshape(-1)
            trace_id = f"tr-{self.label}-{self._next_trace}"
            self._next_trace += 1
            # revision steering (A/B weights / canary ramp): prefer the
            # picked revision's replicas, but availability beats the
            # split — the admitted event records the revision the
            # request actually LANDED on, which is what pins it
            want_rev = self._pick_revision(model, request_id)
            if want_rev is not None:
                ups = [r for r in ups if r.revision == want_rev] or ups
            last_exc = None
            for rep in self._rank(ups, prompt_ids=ids,
                                  demand=self._worst_demand(
                                      ids.size + sampling.max_tokens,
                                      ups)):
                try:
                    arrival, arrival_time = rep.dispatch(
                        prompt_ids, sampling, request_id,
                        trace_id=trace_id)
                except TenantQuotaExceeded:
                    # the quota verdict is TENANT-global, not a property
                    # of this replica — every peer shares the registry
                    # and would refuse identically, so surface it now
                    # with its own retry_after_s (window expiry)
                    raise
                except EngineOverloaded as e:
                    last_exc = e          # per-replica bound; try next
                    continue
                self._rr_next = (rep.index + 1) % len(self.replicas)
                self._requests[request_id] = RouterRequest(
                    request_id=request_id, prompt_ids=ids,
                    params=sampling, arrival_time=arrival_time,
                    arrival=arrival, replica=rep.index,
                    trace_id=trace_id, model=model,
                    revision=rep.revision)
                # balance decision, recorded with the chosen replica's
                # post-dispatch headroom (host-side load snapshot).
                # Multi-model fleets stamp the resolved (model,
                # revision) — invariant 8 pins every later token to it;
                # single-model fleets stay untagged (byte-identical
                # dumps).
                info = rep.load_info()
                rev_tag = {} if registry is None else {
                    "model": model, "revision": rep.revision}
                obs.reqtrace.record(
                    "admitted", trace_id, request_id,
                    router=self.label, replica=rep.index,
                    policy=self.config.balance,
                    headroom=info["free_blocks"] - info["block_demand"],
                    waiting=info["waiting"], **rev_tag)
                self._maybe_peer_fetch(rep, request_id, trace_id, ids)
                return request_id
            # every up replica refused at ITS bound: surface overload
            # with the strongest hint we have — a replica-supplied
            # retry_after_s (deadline early-reject estimate) beats the
            # router's drain-rate guess
            hint = last_exc.retry_after_s if last_exc is not None \
                and last_exc.retry_after_s is not None \
                else self._retry_after()
            raise EngineOverloaded(
                request_id, last_exc.depth if last_exc else 0,
                last_exc.limit if last_exc else 0,
                retry_after_s=hint)

    def cancel(self, request_id: str) -> bool:
        with self._lock:
            rec = self._requests.get(request_id)
            if rec is None or rec.finished:
                return False
            if rec.replica is None:       # orphaned: cancel router-side
                self._orphans = [o for o in self._orphans
                                 if o.request_id != request_id]
                self._terminal(rec, "cancelled")
                return True
            ok = self.replicas[rec.replica].cancel(request_id)
            if ok:
                # the engine's cancel already recorded the terminal
                # trace event; don't double-record it router-side
                self._terminal(rec, "cancelled", record=False)
            return ok

    def get_request(self, request_id: str) -> RouterRequest:
        with self._lock:
            return self._requests[request_id]

    def has_unfinished(self) -> bool:
        with self._lock:
            return any(not rec.finished
                       for rec in self._requests.values())

    # ------------------------------------------------------------ routing
    def _admission_candidates(self, model: str = None
                              ) -> List[EngineReplica]:
        """New prompts (and failover re-prefills) are prefill work:
        they admit to the prefill/mixed tier. Falls back to EVERY
        accepting replica when that whole tier is down — availability
        beats tiering, and a decode replica can still prefill, just not
        at its sized-for roofline. In a multi-model fleet the request's
        model pool is a HARD filter applied first — a request never
        lands on another model's weights, whatever is down."""
        ups = [r for r in self.replicas if r.accepts_admissions()]
        if model is not None and self.config.models is not None:
            ups = [r for r in ups if r.model == model]
        tier = [r for r in ups if r.role in ("prefill", "mixed")]
        return tier or ups

    def _pick_revision(self, model: str, seed: str) -> Optional[str]:
        """Deterministic weighted revision choice for one request:
        hash (model, request_id) onto the model's route weights —
        stateless, replayable, and a 90/10 split is 90/10 for any
        request population. No weights → the registry's active
        revision; no registry → None (single-model fleet, no
        steering)."""
        weights = self._route_weights.get(model)
        if not weights:
            reg = self.config.models
            return reg.active(model) if reg is not None else None
        total = sum(weights.values())
        h = int.from_bytes(hashlib.sha256(
            f"{model}/{seed}".encode()).digest()[:8], "big")
        x = (h / 2.0 ** 64) * total
        for rev in sorted(weights):
            x -= weights[rev]
            if x < 0:
                return rev
        return sorted(weights)[-1]

    def _repin(self, rec: RouterRequest, rep: EngineReplica) -> None:
        """Re-pin a re-dispatched request to its new home's revision.
        Crossing revisions is legal ONLY because re-dispatch re-prefills
        from the router's token log (migrated KV never crosses — the
        migrator refuses); the fresh `admitted` event re-pins the trace
        so invariant 8 holds the request's FUTURE tokens to the new
        revision."""
        if self.config.models is None:
            rec.revision = rep.revision
            return
        if rec.revision == rep.revision:
            return
        rec.revision = rep.revision
        obs.reqtrace.record(
            "admitted", rec.trace_id or rec.request_id,
            rec.request_id, router=self.label, replica=rep.index,
            policy="repin", model=rec.model, revision=rep.revision)

    def _rank(self, candidates: List[EngineReplica],
              prompt_ids=None, demand: int = 0):
        """Dispatch preference order. free_blocks: descending effective
        headroom (free - outstanding demand), then cheapest queued
        re-prefill backlog (jaxplan-priced when the engines carry a
        cost model), then lowest index. round_robin: rotate.
        prefix_affinity: the prompt's rendezvous-preferred replica
        first IF its effective headroom covers the request's worst-case
        `demand` blocks, then the free_blocks order — affinity steers,
        headroom decides."""
        if self.config.balance == "round_robin":
            n = len(self.replicas)
            return sorted(candidates,
                          key=lambda r: (r.index - self._rr_next) % n)

        def score(rep):
            info = rep.load_info()
            return (info["free_blocks"] - info["block_demand"],
                    -info["prefill_cost"], -rep.index)

        by_headroom = sorted(candidates, key=score, reverse=True)
        if self.config.balance == "prefix_affinity" \
                and prompt_ids is not None:
            key = self._affinity_key(prompt_ids)
            if key is not None:
                pref = max(candidates,
                           key=lambda r: self._affinity_weight(key,
                                                               r.index))
                info = pref.load_info()
                if info["free_blocks"] - info["block_demand"] >= demand:
                    return [pref] + [r for r in by_headroom
                                     if r is not pref]
        return by_headroom

    def _affinity_key(self, prompt_ids) -> Optional[tuple]:
        """Routing key: the prompt's leading full blocks, capped at
        affinity_prefix_blocks, mirroring what the engine-side prefix
        trie can actually share (full-block granularity over the first
        len-1 tokens). None when the prompt spans no full block — such
        prompts carry nothing shareable and route purely on headroom."""
        ups = [r for r in self.replicas if r.engine is not None]
        if not ups:
            return None
        bs = ups[0].engine.cache.block_size
        toks = [int(t) for t in
                np.asarray(prompt_ids, np.int32).reshape(-1)]
        nb = min(max(len(toks) - 1, 0) // bs,
                 self.config.affinity_prefix_blocks)
        if nb <= 0:
            return None
        return tuple(toks[:nb * bs])

    @staticmethod
    def _affinity_weight(key: tuple, index: int) -> int:
        """Highest-random-weight (rendezvous) hash: every router ranks
        (key, replica) identically, keys spread uniformly, and removing
        a replica only remaps the keys it owned — failover moves a
        template's traffic to ONE deterministic survivor instead of
        scattering it."""
        h = hashlib.sha256(repr((key, index)).encode()).digest()
        return int.from_bytes(h[:8], "big")

    def _worst_demand(self, n_tokens: int, ups: List[EngineReplica]
                      ) -> int:
        """Worst-case block footprint of a request (prompt + full
        max_tokens budget), in the fleet's common block geometry — the
        headroom bar a prefix-affinity preferred replica must clear."""
        eng = next((r.engine for r in ups if r.engine is not None), None)
        return eng.cache.blocks_needed(n_tokens) if eng is not None \
            else 0

    def _shed_globally_oldest(self, ups: List[EngineReplica]) -> None:
        oldest, victim_rep = None, None
        for rep in ups:
            a = rep.oldest_waiting_arrival()
            if a is not None and (oldest is None or a < oldest):
                oldest, victim_rep = a, rep
        if victim_rep is not None:
            victim_rep.shed_oldest_waiting()
            # terminal 'shed' output streams from that replica's next
            # step and lands in the router record via _absorb

    def _retry_after(self) -> float:
        """Client backoff hint: the earliest pending replica restart if
        the fleet is (partially) down, else one drain step's EWMA."""
        now = time.monotonic()
        waits = [max(r.restart_at - now, 0.0) for r in self.replicas
                 if r.restart_at is not None
                 and r.state == ReplicaState.DOWN]
        base = max(self._step_ewma, 0.01)
        return round(max(min(waits), base), 3) if waits \
            else round(base, 3)

    # -------------------------------------------------------------- step
    def step(self) -> List[RequestOutput]:
        """One router iteration: restart due replicas (warmup-probed),
        re-admit orphans, step every serving replica under crash
        supervision, then run the heartbeat wedge check. Returns the
        merged streamed outputs."""
        with self._lock:
            outs = self._step_locked()
            flights, self._flights = self._flights, []
        # flight-recorder dumps are file I/O — run them AFTER releasing
        # the router lock so a slow disk cannot stall intake
        # threads or the whole fleet's step loop
        for reason, ids, extra in flights:
            obs.reqtrace.maybe_flight(reason, ids, extra=extra)
        return outs

    def _step_locked(self) -> List[RequestOutput]:
        outs: List[RequestOutput] = list(self._pending)
        self._pending.clear()
        self._steps += 1
        step_no = self._steps
        t0 = time.perf_counter()
        with obs.span("serving.router_step", cat="serving",
                      annotate=False,
                      args={"router": self.label, "step": step_no}):
            for rep in self.replicas:
                if rep.restart_due():
                    before = rep.failed_at
                    if rep.restart():
                        self._set_up_gauge(rep)
                        dt = time.monotonic() - before
                        self.recovery_times.append(dt)
                        self._h_recovery.observe(dt)
            self._readmit_orphans(outs)
            for rep in self.replicas:
                if not rep.is_serving():
                    continue
                try:
                    r_outs = rep.step(step_no, self.faults)
                except ReplicaCrashed as e:
                    self._failover(rep, "crash", str(e), outs)
                    continue
                self._absorb(r_outs, outs)
                rep.maybe_drained()
            self._handoffs(step_no, outs)
            for rep in self.replicas:
                if rep.wedged():
                    self._failover(rep, "wedge",
                                   "heartbeat stale past "
                                   f"{self.config.heartbeat_timeout_s}s",
                                   outs)
        dt = time.perf_counter() - t0
        self._step_ewma = 0.8 * self._step_ewma + 0.2 * dt
        return outs

    # --------------------------------------------------------- peer fetch
    def _maybe_peer_fetch(self, rep: EngineReplica, request_id: str,
                          trace_id: str, prompt_ids) -> None:
        """After dispatching to `rep`: if a serving peer holds at least
        one more FULL block of this prompt's prefix (device- or
        host-resident) than `rep` does, pull those blocks over
        (BlockMigration.fetch_prefix) before the request schedules. An
        aborted pull costs nothing — the request re-prefills exactly as
        if the peer had held nothing."""
        if not self.config.peer_prefix_fetch:
            return
        eng = next((r.engine for r in self.replicas
                    if r.engine is not None), None)
        if eng is None:
            return
        local = rep.prefix_probe(prompt_ids)
        best, best_len = None, local
        for peer in self.replicas:
            # prefix KV is revision-keyed: a peer on other weights
            # holds nothing this replica may serve
            if peer is rep or not peer.is_serving() \
                    or peer.revision_key() != rep.revision_key():
                continue
            n = peer.prefix_probe(prompt_ids)
            if n > best_len:
                best, best_len = peer, n
        if best is None or best_len - local < eng.cache.block_size:
            return                        # nothing a full block better
        self.migrator.fetch_prefix(best, rep, request_id, trace_id,
                                   prompt_ids, router_step=self._steps)

    # ---------------------------------------------------------- migration
    def _migration_targets(self, exclude: EngineReplica,
                           decode_phase: bool = True
                           ) -> List[EngineReplica]:
        """Destination preference for one migration: UP replicas other
        than the source, decode tier first for decode-phase requests
        (that is what the tier is sized for, and the router's tier
        filter keeps prompts off it), then descending effective
        headroom, mid-prefill migrations prefer prefill/mixed instead
        (their remaining chunks are prefill work). Candidates must
        share the source's (model, revision) key — KV blocks never
        cross a weight rollout (the migrator refuses anyway; filtering
        here avoids burning export attempts on guaranteed refusals)."""
        key = exclude.revision_key()
        cands = [r for r in self.replicas
                 if r is not exclude and r.accepts_admissions()
                 and r.revision_key() == key]
        if decode_phase:
            cands = [r for r in cands if r.role != "prefill"] \
                or cands

        def score(rep):
            info = rep.load_info()
            return (rep.role == "decode" if decode_phase
                    else rep.role != "decode",
                    info["free_blocks"] - info["block_demand"],
                    -rep.index)

        return sorted(cands, key=score, reverse=True)

    def _handoffs(self, step_no: int, outs) -> None:
        """Prefill→decode tier handoff, run once per router step:
        every request that COMPLETED prefill on a prefill-role replica
        migrates to the decode tier before its next decode chunk. No
        decode-tier headroom → the request simply keeps decoding where
        it is (tiering degrades to mixed, never wedges); a source that
        dies mid-migration fails over like any other crash."""
        for rep in self.replicas:
            if rep.role != "prefill" or not rep.is_serving():
                continue
            try:
                rids = rep.migratable_requests(decode_only=True)
            except ReplicaCrashed:  # pragma: no cover - defensive
                continue
            for rid in rids:
                rec = self._requests.get(rid)
                if rec is None or rec.finished:
                    continue          # warmup probe / already terminal
                targets = self._migration_targets(rep)
                if not targets:
                    break             # no decode tier up: decode here
                try:
                    info = self.migrator.migrate(
                        rep, targets[0], rid, "handoff",
                        router_step=step_no, faults=self.faults)
                except ReplicaCrashed as e:
                    self._failover(rep, "crash", str(e), outs)
                    break             # source gone; victims re-admit
                if info is None:
                    break             # tier full this step; retry next
                rec.replica = targets[0].index

    def _evacuate(self, rep: EngineReplica, outs) -> int:
        """drain(recompute=False) body: move every live request's KV
        off `rep` (arrival order — FCFS fairness at the destinations),
        then re-dispatch its queued requests from the router's token
        log. Anything no survivor can hold stays behind and finishes
        under classic drain. Returns the number of requests moved."""
        moved = 0
        live = sorted(
            (self._requests[rid] for rid
             in rep.migratable_requests(decode_only=False)
             if rid in self._requests),
            key=lambda rec: rec.arrival)
        for rec in live:
            if rec.finished:
                continue
            # streamed tokens ⇒ past prefill ⇒ decode-tier preference
            targets = self._migration_targets(
                rep, decode_phase=bool(rec.tokens))
            done = None
            for target in targets:
                try:
                    done = self.migrator.migrate(
                        rep, target, rec.request_id, "drain",
                        router_step=self._steps, faults=self.faults)
                except ReplicaCrashed as e:
                    self._failover(rep, "crash", str(e), outs)
                    return moved
                if done is not None:
                    rec.replica = target.index
                    moved += 1
                    break
        # queued work second: no KV exists yet, so this is a plain
        # re-dispatch — the first prefill at the new home recomputes
        # nothing. The migrate_out event (blocks=0, queued) closes the
        # request's timeline on this replica; the dispatch's
        # engine_admit opens it on the next.
        queued = sorted(
            (rec for rec in self._requests.values()
             if rec.replica == rep.index and not rec.finished),
            key=lambda rec: rec.arrival)
        for rec in queued:
            # excludes the DRAINING rep; stays in the model pool, and
            # prefers the revision the request is pinned to (crossing
            # is legal for queued work — it never prefilled — but a
            # same-revision home keeps old-revision traffic bitwise on
            # old weights through a rolling deploy)
            ups = self._admission_candidates(model=rec.model)
            if not ups:
                break
            if rec.revision is not None:
                ups = [r for r in ups
                       if r.revision == rec.revision] or ups
            if rep.release_waiting(rec.request_id) is None:
                continue      # running but unmovable: finishes here
            target = self._rank(
                ups, prompt_ids=rec.prompt_ids,
                demand=self._worst_demand(
                    rec.prompt_ids.size + rec.params.max_tokens,
                    ups))[0]
            obs.reqtrace.record(
                "migrate_out", rec.trace_id or rec.request_id,
                rec.request_id, replica=rep.index,
                to_replica=target.index, reason="drain",
                blocks=0, bytes=0, resume_pos=0, arrival=rec.arrival,
                queued=True)
            try:
                target.dispatch(rec.prompt_ids, rec.params,
                                rec.request_id,
                                arrival_time=rec.arrival_time,
                                arrival=rec.arrival,
                                resume_tokens=rec.tokens, readmit=True,
                                trace_id=rec.trace_id or None)
            except ValueError:
                # can never fit any pool — terminal, loud (the same
                # contract as failover re-admission)
                self._terminal(rec, "error")
                outs.append(self._pending.pop())
                continue
            rec.replica = target.index
            self._repin(rec, target)
            moved += 1
        return moved

    def _absorb(self, replica_outputs, outs) -> None:
        """Fold one replica's streamed outputs into the router tables.
        token_ids is authoritative (it includes resumed tokens, so the
        router log can only move forward)."""
        now = time.perf_counter()
        for o in replica_outputs:
            rec = self._requests.get(o.request_id)
            if rec is None:
                continue                  # warmup probe etc.
            rec.tokens = list(o.token_ids)
            if rec.first_token_time is None and o.new_token is not None:
                rec.first_token_time = now
                self._h_ttft.observe(now - rec.arrival_time)
            if o.finished:
                rec.finished = True
                rec.finish_reason = o.finish_reason
            outs.append(o)

    def _terminal(self, rec: RouterRequest, reason: str,
                  record: bool = True) -> None:
        """Router-side terminal (cancel of an orphan, orphans with no
        fleet left): synthesize the terminal output the engines would
        have streamed. `record=False` when an engine already emitted
        the terminal trace event (exactly-one-terminal invariant)."""
        rec.finished = True
        rec.finish_reason = reason
        self._pending.append(RequestOutput(
            rec.request_id, None, list(rec.tokens), True, reason))
        if record:
            obs.reqtrace.record("finish", rec.trace_id or rec.request_id,
                                rec.request_id, reason=reason,
                                tokens=len(rec.tokens))

    # ----------------------------------------------------------- failover
    def _failover(self, rep: EngineReplica, reason: str, detail: str,
                  outs) -> None:
        """Quarantine a crashed/wedged replica and re-admit its
        non-terminal requests to survivors in original arrival order
        (module docstring). The router's own record is the recovery
        source — nothing is read from the failed engine."""
        self._c_failovers.labels(router=self.label,
                                 replica=str(rep.index),
                                 reason=reason).inc()
        rep.quarantine(f"{reason}: {detail}")
        self._set_up_gauge(rep)
        victims = sorted(
            (rec for rec in self._requests.values()
             if not rec.finished and rec.replica == rep.index),
            key=lambda rec: rec.arrival)
        for rec in victims:
            rec.prev_replica = rep.index
            rec.replica = None
            rec.requeues += 1
            self._c_requeued.inc()
            obs.reqtrace.record(
                "failover", rec.trace_id or rec.request_id,
                rec.request_id, replica=rep.index, reason=reason,
                arrival=rec.arrival, tokens_streamed=len(rec.tokens))
        self._orphans.extend(victims)
        self._orphans.sort(key=lambda rec: rec.arrival)
        self._readmit_orphans(outs)
        # flight recorder: a failover is a postmortem trigger — when
        # armed, dump the victims' timelines (incl. the re-admission
        # hops just recorded) plus the registry snapshot. The dump is
        # file I/O, so it is only QUEUED here; step() writes it after
        # the router lock is released.
        self._flights.append((
            "failover",
            [rec.trace_id or rec.request_id for rec in victims],
            {"router": self.label, "replica": rep.index,
             "reason": reason, "detail": detail,
             "victims": [rec.request_id for rec in victims]}))

    def _readmit_orphans(self, outs) -> None:
        """Re-admit orphaned requests (original arrival order) to up
        replicas; with the whole fleet permanently FAILED they
        terminalize as 'error' — loudly, never silently dropped."""
        if not self._orphans:
            return
        if all(r.state == ReplicaState.FAILED for r in self.replicas):
            for rec in self._orphans:
                self._terminal(rec, "error")
                outs.append(self._pending.pop())
            self._orphans.clear()
            return
        remaining: List[RouterRequest] = []
        self._readmit_seq += 1
        batch_id = self._readmit_seq
        for rec in self._orphans:
            ups = self._admission_candidates(model=rec.model)
            if not ups:
                remaining.append(rec)
                continue
            # same-revision survivors first: a failover mid-deploy must
            # not silently promote old-revision requests onto new
            # weights while an old-revision home exists (re-admission
            # DOES cross revisions as a last resort — it re-prefills
            # from the token log, and _repin records the fresh
            # `admitted` that makes it legal under invariant 8)
            if rec.revision is not None:
                ups = [r for r in ups
                       if r.revision == rec.revision] or ups
            # affinity-aware re-admission: the rendezvous key re-ranks
            # over the SURVIVOR set, so a dead replica's template
            # traffic converges on one deterministic survivor and
            # rebuilds its prefix working set there once
            target = self._rank(
                ups, prompt_ids=rec.prompt_ids,
                demand=self._worst_demand(
                    rec.prompt_ids.size + rec.params.max_tokens,
                    ups))[0]
            try:
                target.dispatch(rec.prompt_ids, rec.params,
                                rec.request_id,
                                arrival_time=rec.arrival_time,
                                arrival=rec.arrival,
                                resume_tokens=rec.tokens, readmit=True,
                                trace_id=rec.trace_id or None)
            except ValueError:
                # can never fit the survivor's pool — terminal, loud
                self._terminal(rec, "error")
                outs.append(self._pending.pop())
                continue
            rec.replica = target.index
            obs.reqtrace.record(
                "readmit", rec.trace_id or rec.request_id,
                rec.request_id, to_replica=target.index,
                from_replica=rec.prev_replica, arrival=rec.arrival,
                resume=len(rec.tokens), requeues=rec.requeues,
                batch=batch_id)
            self._repin(rec, target)
            # the dead replica's prefix working set may survive on a
            # peer — pull it before the re-prefill recomputes it
            self._maybe_peer_fetch(target, rec.request_id,
                                   rec.trace_id, rec.prompt_ids)
        self._orphans[:] = remaining

    def _set_up_gauge(self, rep: EngineReplica) -> None:
        self._g_up.labels(router=self.label,
                          replica=str(rep.index)).set(
            1 if rep.accepts_admissions() else 0)

    # ------------------------------------------------------------ control
    def rebalance(self, watermark: float = 0.85) -> int:
        """Move the COLDEST decode requests off every pool running past
        `watermark` occupancy (used / total blocks) until it drops back
        under. Coldest = latest arrival: under pressure those are
        exactly the requests the FCFS preemption rule would recompute
        anyway, so moving them is strictly cheaper than losing them.
        Returns the number of requests migrated."""
        if not 0.0 < watermark <= 1.0:
            raise ValueError(
                f"watermark must be in (0, 1], got {watermark}")
        with self._lock:
            moved = 0
            outs: List[RequestOutput] = []
            for rep in self.replicas:
                if not rep.is_serving() or rep.engine is None:
                    continue
                total = rep.engine.cache.num_blocks
                victims = sorted(
                    (self._requests[rid] for rid
                     in rep.migratable_requests(decode_only=True)
                     if rid in self._requests),
                    key=lambda rec: rec.arrival, reverse=True)
                for rec in victims:
                    info = rep.load_info()
                    if (total - info["free_blocks"]) / total \
                            <= watermark:
                        break
                    targets = [t for t in self._migration_targets(rep)
                               if t.engine is not None
                               and (t.engine.cache.num_blocks
                                    - t.load_info()["free_blocks"])
                               / t.engine.cache.num_blocks < watermark]
                    if not targets:
                        break     # nowhere under the bar: stop moving
                    try:
                        done = self.migrator.migrate(
                            rep, targets[0], rec.request_id,
                            "rebalance", router_step=self._steps,
                            faults=self.faults)
                    except ReplicaCrashed as e:
                        self._failover(rep, "crash", str(e), outs)
                        break
                    if done is None:
                        break
                    rec.replica = targets[0].index
                    moved += 1
            self._pending.extend(outs)
            return moved

    def drain(self, index: int, recompute: bool = True) -> None:
        """Stop routing new work to replica `index`; it parks DRAINED
        once empty (undrain() to rejoin). `recompute=True` (classic)
        lets it finish everything it holds in place.
        `recompute=False` EVACUATES it instead: live requests (decode
        AND mid-prefill) migrate their KV blocks to the other replicas
        — zero re-prefilled tokens — and queued requests re-dispatch
        from the router's token log (they never prefilled, so their
        first prefill elsewhere recomputes nothing). Work that no
        survivor can hold stays and finishes here under the classic
        drain semantics."""
        with self._lock:
            rep = self.replicas[index]
            rep.drain()
            self._set_up_gauge(rep)
            if recompute or rep.engine is None:
                return
            outs: List[RequestOutput] = []
            self._evacuate(rep, outs)
            self._pending.extend(outs)

    def undrain(self, index: int) -> None:
        with self._lock:
            self.replicas[index].undrain()
            self._set_up_gauge(self.replicas[index])

    def evict(self, index: int, reason: str = "evict",
              detail: str = "") -> int:
        """Forced failover of one replica through the exact machinery a
        crash takes: quarantine, requeue every non-terminal request in
        original arrival order, re-admit to survivors immediately. The
        deploy controller uses this on rollback to clear a swapped
        slot's live work before restoring the previous revision's warm
        engine — restore_revision replaces the engine object, so any
        request still decoding there would otherwise be silently
        stranded. Terminal outputs synthesized during re-admission (no
        survivor fits) are delivered by the next step(). Returns the
        number of requeued requests."""
        with self._lock:
            rep = self.replicas[index]
            victims = sum(1 for rec in self._requests.values()
                          if not rec.finished and rec.replica == index)
            outs: List[RequestOutput] = []
            self._failover(rep, reason, detail, outs)
            self._pending.extend(outs)
            return victims

    def set_route_weights(self, model: str,
                          weights: Dict[str, float] = None) -> None:
        """Set (or with None/empty: clear) the revision traffic split
        for `model` — {"sha256:abc...": 0.9, "sha256:def...": 0.1}.
        Cleared → requests route to the registry-active revision.
        DeployController drives this to shift traffic onto swapped
        replicas mid-rollout and to snap it back on rollback."""
        if weights:
            if any(w < 0 for w in weights.values()) \
                    or sum(weights.values()) <= 0:
                raise ValueError(
                    f"route weights must be non-negative with a "
                    f"positive sum, got {weights}")
        with self._lock:
            if weights:
                self._route_weights[model] = dict(weights)
            else:
                self._route_weights.pop(model, None)

    def route_weights(self, model: str) -> Dict[str, float]:
        with self._lock:
            return dict(self._route_weights.get(model, {}))

    def pool(self, model: str) -> List[int]:
        """Replica indices currently serving `model` (any revision)."""
        with self._lock:
            return [r.index for r in self.replicas if r.model == model]

    def probe_grow(self, index: int) -> bool:
        """Return a PARKED (DRAINED) replica to rotation through a
        warmup-probe rejoin (autoscaler grow path, docs/serving.md):
        unlike undrain(), which trusts the warm engine blindly, the
        slot must serve a 1-token greedy probe end-to-end before real
        traffic routes there — the same gate a restarted incarnation
        passes. A failed probe quarantines the slot (normal
        restart/backoff machinery takes over) and returns False."""
        with self._lock:
            rep = self.replicas[index]
            ok = rep.probe_rejoin()
            self._set_up_gauge(rep)
            return ok

    # ------------------------------------------------------------- audits
    def check_integrity(self) -> dict:
        """Per-replica zero-leak audit (chaos gate): every live pool's
        free list + tables must exactly partition it. Replicas whose
        slot holds no engine (DOWN/FAILED) audit as None — their pools
        are unreachable."""
        return {r.index: r.check_integrity() for r in self.replicas}

    def prefix_stats(self) -> dict:
        """Fleet-level prefix-cache telemetry: per-replica snapshots
        plus the aggregate hit rate the 3-replica affinity SLO gates on
        (cached tokens / prompt tokens summed across LIVE replicas —
        dead replicas' counters died with their engines)."""
        with self._lock:
            per = {}
            agg = {"hits": 0, "misses": 0, "evictions": 0,
                   "cow_forks": 0, "cached_tokens_total": 0,
                   "prompt_tokens_total": 0}
            for r in self.replicas:
                eng = r.engine
                if eng is None:
                    per[r.index] = None
                    continue
                ps = eng.cache.prefix_stats()
                per[r.index] = ps
                for k in agg:
                    agg[k] += ps[k]
            total = agg["prompt_tokens_total"]
            agg["cached_tokens_ratio"] = \
                agg["cached_tokens_total"] / total if total else 0.0
            agg["replicas"] = per
            return agg

    def states(self) -> dict:
        return {r.index: r.state for r in self.replicas}

    def num_up(self) -> int:
        return sum(1 for r in self.replicas if r.accepts_admissions())

    def ttft_quantile(self, q: float) -> float:
        return self._h_ttft.quantile(q)

    def router_stats(self) -> dict:
        with self._lock:
            recs = list(self._requests.values())
            by_reason: Dict[str, int] = {}
            for rec in recs:
                if rec.finished:
                    key = rec.finish_reason or "unknown"
                    by_reason[key] = by_reason.get(key, 0) + 1
            pools: Dict[str, Dict[str, List[int]]] = {}
            for r in self.replicas:
                pools.setdefault(r.model, {}).setdefault(
                    r.revision, []).append(r.index)
            return {
                "steps": self._steps,
                "requests": len(recs),
                "unfinished": sum(1 for r in recs if not r.finished),
                "generated_tokens": sum(len(r.tokens) for r in recs),
                "requeues": sum(r.requeues for r in recs),
                "migrations": self.migrator.stats(),
                "finish_reasons": by_reason,
                "replica_states": {r.index: r.state
                                   for r in self.replicas},
                "pools": pools,
                "route_weights": {m: dict(w) for m, w
                                  in self._route_weights.items()},
                "recovery_times_s": [round(t, 4)
                                     for t in self.recovery_times],
            }

    # ------------------------------------------------------- convenience
    def run(self, max_steps: int = None) -> Dict[str, np.ndarray]:
        """Drive every queued request to a terminal state; returns
        {request_id: generated token ids} for normally-completed
        requests. Idles briefly while the only pending work is a
        replica restart backoff, so the drain loop doesn't spin."""
        steps = 0
        while self.has_unfinished():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"router did not drain within {max_steps} steps")
            if not any(r.has_unfinished() for r in self.replicas) \
                    and self.has_unfinished():
                time.sleep(0.002)         # waiting on a restart backoff
        with self._lock:
            return {rid: np.asarray(rec.tokens, np.int64)
                    for rid, rec in self._requests.items()
                    if rec.finish_reason in ("stop", "length")}
