"""EngineReplica: one supervised LLMEngine slot inside a ReplicaSet.

Port of paddle_tpu/inference/serving/replica.py (host Python in both
packages; the engine it supervises owns the device work). The
supervisor watches three signals, one per failure mode:

- CRASH: the engine's step raises (a kill_replica fault, a device error
  the engine-level recovery could not contain). The exception is the
  signal.
- WEDGE: the engine stops making progress without raising. Each
  successful step beats a heartbeat timestamp; a replica holding
  unfinished work whose beat goes stale past `heartbeat_timeout` counts
  as wedged (`ReplicaSet` runs the check; a wedged step returns without
  beating, which is what a hung engine looks like from the router).
- DRAIN: operator-initiated; the replica finishes its admitted work but
  receives nothing new, then parks DRAINED until undrained.

A failed replica's engine is dropped unread: nothing it owns is
trusted, the pool dies with it (its device memory returns once nothing
references the engine) and a fresh incarnation gets a fresh pool.
Restarts follow distributed.elastic.BackoffPolicy, and a restarted
replica rejoins rotation only after a WARMUP PROBE: a 1-token greedy
request must complete on the fresh engine first (a replica that crashes
on its probe goes straight back to backoff).

Thread contract: replica state is shared between the router's step loop
and intake threads; public methods take self._lock (the fields are
listed in _GUARDED_BY), private helpers run under it. Lock order is
router -> replica -> engine -> scheduler, never the reverse.

Left out: the lock-order annotation (`analysis.holds_lock`) and the
lock witness, which the port's analyzers do not read yet.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ...distributed.elastic import BackoffPolicy
from .scheduler import SamplingParams

__all__ = ["EngineReplica", "ReplicaCrashed", "ReplicaState"]


class ReplicaCrashed(RuntimeError):
    """A replica's engine died mid-step (the serving analogue of a
    nonzero worker exit code); the router quarantines the replica and
    fails its requests over to survivors."""


class ReplicaState:
    STARTING = "starting"    # fresh engine up, warmup probe pending
    UP = "up"                # serving; eligible for admissions
    DRAINING = "draining"    # finishing admitted work; no new admissions
    DRAINED = "drained"      # drained empty; parked until undrain()
    DOWN = "down"            # quarantined; backing off before restart
    FAILED = "failed"        # restart budget exhausted; never rejoins

    SERVING = (UP, DRAINING)  # states whose engine steps


class EngineReplica:
    """One supervised engine slot (module docstring). The ReplicaSet is
    the only caller; every public method is safe from the router's
    locked frame (lock order router → replica)."""

    _GUARDED_BY = {
        "engine": "_lock",
        "state": "_lock",
        "restarts": "_lock",
        "restart_at": "_lock",
        "last_beat": "_lock",
        "last_step_end": "_lock",
        "_wedged": "_lock",
        "history": "_lock",
        "failed_at": "_lock",
        "probe_tokens": "_lock",
        "_probe_seq": "_lock",
        "_factory": "_lock",
        "model": "_lock",
        "revision": "_lock",
        "_prev_engine": "_lock",
        "_prev_factory": "_lock",
    }

    ROLES = ("prefill", "decode", "mixed")

    def __init__(self, index: int, engine_factory: Callable,
                 backoff: BackoffPolicy, max_restarts: int = 3,
                 heartbeat_timeout: Optional[float] = None,
                 probe_prompt=(1,), probe_timeout_steps: int = 64,
                 role: str = "mixed"):
        if role not in self.ROLES:
            raise ValueError(f"replica role {role!r} not in {self.ROLES}")
        self.index = index
        # tier assignment (docs/serving.md): immutable after construction
        # — "prefill" replicas take new prompts and hand finished
        # prefills off, "decode" replicas only receive migrations,
        # "mixed" does both (the homogeneous default)
        self.role = role
        self._factory = engine_factory
        self._backoff = backoff
        self.max_restarts = int(max_restarts)
        self.heartbeat_timeout = heartbeat_timeout
        self.probe_prompt = list(probe_prompt)
        self.probe_timeout_steps = int(probe_timeout_steps)
        self._lock = threading.RLock()
        self.engine = engine_factory(index, 0)
        # first incarnation starts UP unprobed — the same trust a
        # single-engine deployment extends to a freshly built LLMEngine;
        # the warmup probe gates REJOIN after a failure, where the
        # previous incarnation just proved the slot can go bad
        self.state = ReplicaState.UP
        self.restarts = 0                 # incarnations spent (0 = first)
        self.restart_at: Optional[float] = None
        self.last_beat = time.monotonic()
        self.last_step_end = self.last_beat
        self._wedged = False
        self.failed_at: Optional[float] = None  # quarantine timestamp
        self.history: List[tuple] = []    # [(incarnation, reason)]
        self.probe_tokens = 0             # warmup tokens spent (telemetry)
        self._probe_seq = 0               # probes run on THIS incarnation
        # (model, revision) identity (serving/deploy.py): cached OFF the
        # engine so routing/autoscaling can still group a quarantined
        # slot (engine None) with its pool. Updated whenever an engine
        # is (re)built; swap_revision changes it, quarantine keeps it.
        with self._lock:
            self.model, self.revision = self._engine_key()
        # warm standby for instant rollback: the previous revision's
        # engine + factory, held from swap_revision until the deploy
        # commits (commit_revision) or rolls back (restore_revision)
        self._prev_engine = None
        self._prev_factory: Optional[Callable] = None

    def _engine_key(self) -> tuple:
        """(model, revision) the current engine serves (engine configs
        default to ("default", "r0") on single-model stacks)."""
        cfg = self.engine.config
        return (getattr(cfg, "model", "default"),
                getattr(cfg, "revision", "r0"))

    # ------------------------------------------------------------ queries
    def revision_key(self) -> tuple:
        """(model, revision) this slot serves — the key every KV payload
        carries and every admit path checks (cross-revision refusal)."""
        with self._lock:
            return (self.model, self.revision)

    def is_serving(self) -> bool:
        with self._lock:
            return self.state in ReplicaState.SERVING

    def accepts_admissions(self) -> bool:
        with self._lock:
            return self.state == ReplicaState.UP

    def has_unfinished(self) -> bool:
        with self._lock:
            return self.state in ReplicaState.SERVING \
                and self.engine.has_unfinished()

    def load_info(self) -> dict:
        with self._lock:
            return self.engine.load_info()

    def check_integrity(self):
        """Zero-leak audit of THIS replica's live pool (None while the
        slot holds no engine — a quarantined incarnation's pool is
        unreachable by definition)."""
        with self._lock:
            if self.engine is None:
                return None
            return self.engine.cache.check_integrity()

    # ------------------------------------------------------------ intake
    def dispatch(self, prompt_ids, sampling, request_id,
                 arrival_time=None, arrival=None, resume_tokens=None,
                 readmit: bool = False, trace_id=None):
        """Admit one request to this replica's engine (router-only
        entry; the dispatch beats the heartbeat so an idle replica's
        clock starts when work lands). `trace_id` rides through to the
        engine so the router-minted causal timeline (obs/reqtrace.py)
        survives the hop. Returns the engine-stamped
        (arrival ticket, arrival_time)."""
        with self._lock:
            self.engine.add_request(prompt_ids, sampling,
                                    request_id=request_id,
                                    arrival_time=arrival_time,
                                    arrival=arrival,
                                    resume_tokens=resume_tokens,
                                    readmit=readmit,
                                    trace_id=trace_id)
            self.last_beat = time.monotonic()
            req = self.engine.get_request(request_id)
            return req.arrival, req.arrival_time

    def oldest_waiting_arrival(self) -> Optional[int]:
        with self._lock:
            return self.engine.oldest_waiting_arrival()

    def shed_oldest_waiting(self) -> Optional[str]:
        with self._lock:
            return self.engine.shed_oldest_waiting()

    def cancel(self, request_id: str) -> bool:
        with self._lock:
            if self.engine is None:
                return False
            return self.engine.cancel(request_id)

    # --------------------------------------------------------------- step
    def step(self, router_step: int, faults=None) -> list:
        """One engine step under supervision. Raises ReplicaCrashed when
        a kill fault (or any engine-level exception) fires; a wedged
        replica returns [] WITHOUT beating the heartbeat — from the
        router's perspective indistinguishable from a hung device call,
        which is the point."""
        with self._lock:
            if faults is not None \
                    and faults.kill_replica(router_step, self.index):
                raise ReplicaCrashed(
                    f"replica {self.index} killed by fault injection at "
                    f"router step {router_step}")
            if faults is not None \
                    and faults.wedge_replica(router_step, self.index):
                self._wedged = True
            if self._wedged:
                self.last_step_end = time.monotonic()
                return []
            try:
                outs = self.engine.step()
            except Exception as e:
                raise ReplicaCrashed(
                    f"replica {self.index} engine step raised: {e}") from e
            now = time.monotonic()
            self.last_beat = now
            self.last_step_end = now
            return outs

    def beat(self) -> None:
        """Reset the heartbeat baseline (the router beats on dispatch so
        a request added to a momentarily-idle replica can't trip the
        stale-beat check before its first step)."""
        with self._lock:
            self.last_beat = time.monotonic()

    def wedged(self) -> bool:
        """Heartbeat-based wedge verdict: serving, holding unfinished
        work, and silent past heartbeat_timeout. The staleness baseline
        is the replica's OWN last step-return time, not wall clock — a
        healthy step always beats at its end, so last_step_end and
        last_beat advance together and a slow-but-progressing step
        (fresh-engine compile, a long stall that completes) can never
        false-trip the check; only steps that return WITHOUT beating —
        the wedge signature — let last_step_end drift ahead. An IDLE
        wedged replica is caught on its first admission: the dispatch
        beat starts the clock and no step beat ever follows."""
        with self._lock:
            if self.heartbeat_timeout is None \
                    or self.state not in ReplicaState.SERVING:
                return False
            if not self.engine.has_unfinished():
                return False
            return (self.last_step_end - self.last_beat) \
                > self.heartbeat_timeout

    # ----------------------------------------------------------- failover
    def quarantine(self, reason: str) -> None:
        """Take the replica out of rotation after a crash/wedge verdict.
        The engine object is dropped UNREAD — nothing it owns can be
        trusted (and for a real dead process nothing is reachable), so
        there is no scrub, no free: the pool dies with the engine. A
        fresh incarnation gets a fresh pool."""
        with self._lock:
            self.history.append((self.restarts, reason))
            self.engine = None
            self._wedged = False
            self.failed_at = time.monotonic()
            if self.restarts >= self.max_restarts:
                self.state = ReplicaState.FAILED
                self.restart_at = None
            else:
                self.state = ReplicaState.DOWN
                self.restart_at = time.monotonic() \
                    + self._backoff.delay(self.restarts)
                self.restarts += 1

    def restart_due(self, now: float = None) -> bool:
        with self._lock:
            now = time.monotonic() if now is None else now
            return self.state == ReplicaState.DOWN \
                and self.restart_at is not None and now >= self.restart_at

    def restart(self) -> bool:
        """Build a fresh engine incarnation and run the warmup probe.
        Returns True when the replica is back UP; a probe failure sends
        it straight back to quarantine (counting against the restart
        budget, with escalated backoff)."""
        with self._lock:
            self.state = ReplicaState.STARTING
            try:
                self.engine = self._factory(self.index, self.restarts)
                self.model, self.revision = self._engine_key()
                self._probe()
            except Exception as e:          # noqa: BLE001 — any probe
                # failure is a failed incarnation, not a router crash
                self.quarantine(f"warmup probe failed: {e}")
                return False
            self.state = ReplicaState.UP
            self.last_beat = time.monotonic()
            return True

    def _probe(self) -> None:
        """Warmup probe: one greedy token end-to-end on the fresh engine
        (prefill → paged decode → terminal). Any raise or a non-'length'
        terminal fails the probe; the probe request never reaches the
        router's tables."""
        eng = self.engine
        # the -p sequence keeps probe ids unique when one incarnation is
        # probed more than once (restart probe, then autoscaler rejoin
        # probes after each park) — engines reject duplicate request ids
        self._probe_seq += 1
        rid = eng.add_request(
            self.probe_prompt,
            SamplingParams(max_tokens=1, temperature=0.0),
            request_id=(f"warmup-probe-r{self.index}-i{self.restarts}"
                        f"-p{self._probe_seq}"))
        for _ in range(self.probe_timeout_steps):
            eng.step()
            req = eng.get_request(rid)
            if req.finished:
                break
        req = eng.get_request(rid)
        if req.state != "finished_length":
            raise RuntimeError(
                f"warmup probe ended {req.state!r} instead of serving "
                f"its token")
        self.probe_tokens += len(req.output_ids)

    # ----------------------------------------------------------- migration
    # Locked pass-throughs for the BlockMigration coordinator
    # (serving/migration.py). The coordinator runs in the router's step
    # frame and acquires ONE replica's lock at a time — never source and
    # destination together (lock order: BlockMigration._lock →
    # EngineReplica._lock; two same-named locks held at once would be a
    # witnessed self-cycle).

    def migratable_requests(self, decode_only: bool = True) -> List[str]:
        with self._lock:
            if self.state not in ReplicaState.SERVING \
                    or self.engine is None:
                return []
            return self.engine.migratable_requests(decode_only=decode_only)

    def export_request(self, request_id: str) -> dict:
        with self._lock:
            return self.engine.export_request(request_id)

    def admit_migrated(self, snap: dict) -> str:
        """Destination admission; beats the heartbeat like dispatch()
        does, so a migration landing on an idle decode replica can't
        trip the stale-beat wedge check before its first step. Returns
        the destination engine's obs label (migrate_in event home)."""
        with self._lock:
            label = self.engine.admit_migrated(snap)
            self.last_beat = time.monotonic()
            return label

    def release_migrated(self, request_id: str) -> None:
        with self._lock:
            self.engine.release_migrated(request_id)

    def abort_migrated(self, request_id: str) -> None:
        with self._lock:
            if self.engine is not None:
                self.engine.abort_migrated(request_id)

    def release_waiting(self, request_id: str):
        with self._lock:
            return self.engine.release_waiting(request_id)

    # ------------------------------------------------------- prefix tier
    # Peer prefix-fetch pass-throughs (docs/serving.md "Hierarchical
    # KV-cache tiering"). Same discipline as the migration block above:
    # the BlockMigration coordinator touches ONE replica's lock at a
    # time, so a fetch in each direction between two replicas can never
    # deadlock. A slot with no engine probes 0 / exports None — a dead
    # peer simply holds no prefix.

    def prefix_probe(self, prompt_ids) -> int:
        with self._lock:
            if self.engine is None:
                return 0
            return self.engine.prefix_probe(prompt_ids)

    def export_prefix(self, prompt_ids):
        with self._lock:
            if self.engine is None:
                return None
            return self.engine.export_prefix(prompt_ids)

    def admit_prefix(self, prompt_ids, blocks, model: str = None,
                     revision: str = None) -> int:
        with self._lock:
            if self.engine is None:
                return 0
            return self.engine.admit_prefix(prompt_ids, blocks,
                                            model=model,
                                            revision=revision)

    # ------------------------------------------------------------ draining
    def drain(self) -> None:
        with self._lock:
            if self.state == ReplicaState.UP:
                self.state = ReplicaState.DRAINING

    def maybe_drained(self) -> bool:
        """DRAINING → DRAINED once the engine has nothing unfinished
        (router polls this each step). True when parked."""
        with self._lock:
            if self.state == ReplicaState.DRAINING \
                    and not self.engine.has_unfinished():
                self.state = ReplicaState.DRAINED
            return self.state == ReplicaState.DRAINED

    def undrain(self) -> None:
        with self._lock:
            if self.state in (ReplicaState.DRAINING, ReplicaState.DRAINED):
                self.state = ReplicaState.UP

    def probe_rejoin(self) -> bool:
        """Warmup-probe rejoin for a PARKED replica (autoscaler grow
        path, docs/serving.md): a DRAINED slot has been idle for an
        unbounded time, so before it takes traffic again it must prove
        the warm engine still serves — the same 1-token greedy probe
        that gates rejoin after a restart. Only DRAINED slots qualify:
        the probe loop steps the engine and discards outputs, which
        would eat live requests' tokens on any serving state. A probe
        failure quarantines the incarnation (the slot just proved it
        went bad while parked), handing recovery to the normal
        restart/backoff machinery. Returns True when the replica is
        back UP."""
        with self._lock:
            if self.state != ReplicaState.DRAINED:
                return False
            if self.engine is None or self.engine.has_unfinished():
                return False
            try:
                self._probe()
            except Exception as e:          # noqa: BLE001 — a failed
                # rejoin probe is a failed incarnation, not a crash
                self.quarantine(f"rejoin probe failed: {e}")
                return False
            self.state = ReplicaState.UP
            self.last_beat = time.monotonic()
            return True

    # ------------------------------------------------- revision rollout
    # The DeployController's per-replica primitives (serving/deploy.py).
    # A rollout touches one PARKED (DRAINED, evacuated-empty) slot at a
    # time: swap_revision installs the new revision's engine and runs
    # the warmup probe, canary_outputs drives the parity gate, and the
    # slot only rejoins rotation via the normal probe_rejoin. The OLD
    # engine + factory are kept warm until the whole deploy commits
    # (commit_revision) so restore_revision is an instant, re-prefill-
    # free rollback — the drained old pool is empty, nothing is stale.

    def swap_revision(self, engine_factory: Callable) -> bool:
        """Replace a PARKED slot's engine with a new revision's, probe
        it, and park again (the canary gate and probe_rejoin stand
        between the swap and real traffic). A factory/probe failure
        reinstates the old incarnation and returns False — the slot is
        exactly as before the call."""
        with self._lock:
            if self.state != ReplicaState.DRAINED:
                raise ValueError(
                    f"swap_revision: replica {self.index} is "
                    f"{self.state!r}, not drained")
            if self.engine.has_unfinished():
                raise ValueError(
                    f"swap_revision: replica {self.index} still holds "
                    f"unfinished work")
            self._prev_engine = self.engine
            self._prev_factory = self._factory
            self._factory = engine_factory
            self.state = ReplicaState.STARTING
            try:
                self.engine = engine_factory(self.index, self.restarts)
                self.model, self.revision = self._engine_key()
                self._probe()
            except Exception:               # noqa: BLE001 — a failed
                # swap is a failed CANDIDATE, not a failed slot: the
                # old incarnation comes straight back
                self._factory = self._prev_factory
                self.engine = self._prev_engine
                self._prev_engine = None
                self._prev_factory = None
                self.model, self.revision = self._engine_key()
                self.state = ReplicaState.DRAINED
                return False
            self.state = ReplicaState.DRAINED
            return True

    def restore_revision(self) -> bool:
        """Instant rollback: reinstate the warm previous-revision engine
        and factory saved by swap_revision. Works whether the swapped
        incarnation is still parked or was quarantined mid-deploy (the
        chaos window) — the slot parks DRAINED either way and rejoins
        via probe_rejoin. Returns False when there is nothing to
        restore."""
        with self._lock:
            if self._prev_factory is None:
                return False
            self._factory = self._prev_factory
            old, self._prev_engine = self._prev_engine, None
            self._prev_factory = None
            if old is None:                  # pragma: no cover - the
                # warm engine is only dropped by commit_revision, which
                # also clears the factory; restart() rebuilds old weights
                return False
            self.engine = old
            self.model, self.revision = self._engine_key()
            self._wedged = False
            self.restart_at = None
            self.state = ReplicaState.DRAINED
            return True

    def commit_revision(self) -> None:
        """Release the warm standby once the deploy commits — rollback
        past this point is a fresh deploy of the old revision."""
        with self._lock:
            self._prev_engine = None
            self._prev_factory = None

    def canary_outputs(self, prompts, max_tokens: int = 8,
                       max_steps_each: int = 256) -> List[List[int]]:
        """Greedy decode of the pinned canary prompt set on a PARKED
        slot's engine — the deploy parity gate's measurement half. Runs
        each prompt end-to-end (prefill → decode → 'length' terminal)
        and returns the emitted token lists; any raise or an unfinished
        canary fails the gate. Only DRAINED slots qualify, for the same
        reason as probe_rejoin: the loop steps the engine and a serving
        state would lose live requests' tokens."""
        with self._lock:
            if self.state != ReplicaState.DRAINED:
                raise ValueError(
                    f"canary_outputs: replica {self.index} is "
                    f"{self.state!r}, not drained")
            eng = self.engine
            outs: List[List[int]] = []
            for prompt in prompts:
                self._probe_seq += 1
                rid = eng.add_request(
                    list(prompt),
                    SamplingParams(max_tokens=max_tokens,
                                   temperature=0.0),
                    request_id=(f"canary-r{self.index}-i{self.restarts}"
                                f"-p{self._probe_seq}"))
                for _ in range(max_steps_each):
                    eng.step()
                    if eng.get_request(rid).finished:
                        break
                req = eng.get_request(rid)
                if req.state != "finished_length":
                    raise RuntimeError(
                        f"canary {rid!r} ended {req.state!r} instead of "
                        f"serving its tokens")
                self.probe_tokens += len(req.output_ids)
                outs.append([int(t) for t in req.output_ids])
            return outs
