"""Multi-model registry and chaos-gated zero-downtime weight rollouts.

Port of paddle_tpu/inference/serving/deploy.py (host Python). One
ReplicaSet serves several models, each with a line of published
checkpoint REVISIONS, and moves a model's pool from one revision to the
next replica by replica without dropping a request or letting stale KV
serve new weights:

- `ModelRegistry`: model id -> published revisions. A revision's id is
  the digest of the per-array sha256 manifest
  (incubate/checkpoint.py's `_array_manifest` over the model's
  parameters, or an artifact directory's `checksums.json`; publishing
  an artifact without one is a hard error), so identical weights
  publish as the same revision, in this package and the JAX package
  alike. Each revision carries its own prefill cost model (the port's
  analysis/jaxplan.py reader), so admission pricing rolls forward with
  the weights. Engines of a revision run on its model's device and
  share its weights.

- `DeployController`: a tick-driven state machine that rolls one
  model's pool to a new revision one replica at a time:

      drain(recompute=False)  evacuating drain: live KV migrates to
                              same-revision peers, queued work
                              re-dispatches
      swap_revision           the new revision's engine on the parked
                              slot, warmup-probed; the old engine and
                              factory stay warm for rollback
      [kill_deploy window]    the chaos fault fires here, after the swap
                              and before the canary gate
      canary parity gate      greedy outputs on pinned prompts against
                              the old revision's; more mismatches than
                              the committed tolerance abort the deploy
      probe_rejoin            the slot rejoins through the warmup probe
      route-weight shift      new admissions steer to the new revision
                              in proportion to the pool's progress

  Any failure (a stuck drain, a swap or probe failure, a canary
  mismatch, a replica killed in the window) rolls every swapped slot
  back to its warm old engine (newest first) and snaps the route
  weights back; the rollback re-prefills nothing because the old pools
  were evacuated empty. Commit releases the warm standbys, flips the
  registry's active revision and clears the weights.

Revision safety is enforced below this module: engines stamp (model,
revision) on every exported KV payload and refuse mismatched admits,
the router migrates only between same-key replicas, and reqtrace
invariant 8 checks after the fact that no token came from a revision
other than the one that admitted its request.

Observability: `serving_deploys_total{router,outcome}`,
`serving_model_revision{router,model,revision}`,
`serving_canary_mismatches_total{router}`, deploy spans, and the deploy
events (`deploy_start`, `replica_swap`, `canary`, `rollback`,
`deploy_commit`) on one `deploy-<model>-N` trace per rollout.

Thread contract: `DeployController._lock` is the outermost serving lock
(a tick drives router control surfaces and replica rollout primitives).
`ModelRegistry._lock` sits between EngineReplica and LLMEngine: the
router resolves the active revision under its own lock, and a replica
swap builds the new engine through a factory pinned to a resolved
Revision, which takes no registry lock.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ... import obs
from .scheduler import SamplingParams

__all__ = ["DeployConfig", "DeployController", "ModelRegistry",
           "Revision"]

_DEPLOY_IDS = itertools.count()

# deploy outcomes, the serving_deploys_total label set
OUTCOMES = ("committed", "rolled_back", "aborted")


@dataclass(frozen=True)
class Revision:
    """One published (model, revision): verified weights + the pricing
    that ships with them."""
    model: str
    revision: str                 # "sha256:<manifest digest prefix>"
    weights: object               # the live model object engines build from
    manifest: Dict[str, str]      # array path -> sha256 (checkpoint.py)
    cost_model: Optional[object]  # jaxplan.PrefillCostModel or None
    engine_config: object         # base EngineConfig template


def _manifest_from_artifact(artifact_dir: str) -> Dict[str, str]:
    """Load the sha256 manifest of a checkpoint artifact directory.
    Missing manifest is a HARD error — the strict half of
    AutoCheckpointManager(require_manifest=True): an unverifiable
    artifact cannot become a revision."""
    from ...incubate.checkpoint import CHECKSUM_FILE
    path = os.path.join(artifact_dir, CHECKSUM_FILE)
    if not os.path.exists(path):
        raise IOError(
            f"artifact {artifact_dir!r} has no {CHECKSUM_FILE} manifest "
            f"— unverifiable weights cannot be published as a revision")
    with open(path) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) or not manifest:
        raise IOError(
            f"artifact {artifact_dir!r}: {CHECKSUM_FILE} is empty or "
            f"malformed")
    return {str(k): str(v) for k, v in manifest.items()}


def _manifest_from_weights(weights) -> Dict[str, str]:
    """sha256 manifest computed directly from a live model's parameter
    tree (host-side bytes) — the in-memory publish path, digest-
    compatible with what checkpoint.py writes for the same arrays."""
    from ...incubate.checkpoint import _array_manifest, _to_host
    from ...models import generation as gen
    return _array_manifest(_to_host(gen.extract_params(weights)))


def _engine_from_revision(rev: "Revision", index: int,
                          label: str = None):
    """Build one engine from an already-resolved Revision. Registry
    lock-free on purpose: the pinned factories replica slots install
    run under EngineReplica._lock (swap_revision, restart), and the
    resolved Revision is immutable, so nothing here needs — or may
    take — ModelRegistry._lock."""
    from .engine import LLMEngine
    from .router import _model_device
    cfg = dataclasses.replace(
        rev.engine_config, model=rev.model, revision=rev.revision,
        prefill_cost_model=rev.cost_model,
        obs_label=label or f"{rev.model}-r{index}")
    return LLMEngine.from_model(rev.weights, cfg,
                                device=_model_device(rev.weights))


def _revision_id(manifest: Dict[str, str]) -> str:
    digest = hashlib.sha256(
        json.dumps(manifest, sort_keys=True).encode()).hexdigest()
    return f"sha256:{digest[:12]}"


class ModelRegistry:
    """model id -> published checkpoint revisions (module docstring).

    `version` increments on every publish/activation so consumers can
    cache derived views and refresh only on change — the same contract
    as TenantRegistry."""

    _GUARDED_BY = {
        "_revisions": "_lock",
        "_active": "_lock",
        "version": "_lock",
    }

    def __init__(self):
        self._lock = threading.RLock()
        # model -> revision id -> Revision, insertion-ordered (publish
        # order is the rollback lineage)
        self._revisions: Dict[str, Dict[str, Revision]] = {}
        self._active: Dict[str, str] = {}
        self.version = 1

    # ----------------------------------------------------------- publish
    def publish(self, model_id: str, weights, engine_config=None,
                cost_model="auto", artifact_dir: Optional[str] = None,
                activate: Optional[bool] = None) -> str:
        """Publish one revision of `model_id` and return its id.

        The revision id is the sha256 of the checkpoint manifest:
        loaded from `artifact_dir/checksums.json` when an artifact
        directory is given (missing manifest = hard IOError), computed
        from the live parameter tree otherwise. Re-publishing identical
        weights is idempotent — same manifest, same id, no new entry.

        `cost_model="auto"` prices admission with the committed jaxplan
        prefill model (falls back to the flat token budget when no plan
        is committed); pass an explicit PrefillCostModel to pin a
        revision's own pricing, or None to force the flat budget.
        `activate=None` activates only the model's FIRST revision (new
        revisions of a live model go live through a DeployController,
        never by publish)."""
        manifest = (_manifest_from_artifact(artifact_dir)
                    if artifact_dir is not None
                    else _manifest_from_weights(weights))
        rev_id = _revision_id(manifest)
        if cost_model == "auto":
            from ...analysis import jaxplan
            cost_model = jaxplan.default_admission_model()
        if engine_config is None:
            from .engine import EngineConfig
            engine_config = EngineConfig()
        with self._lock:
            revs = self._revisions.setdefault(model_id, {})
            if rev_id not in revs:
                revs[rev_id] = Revision(
                    model=model_id, revision=rev_id, weights=weights,
                    manifest=dict(manifest), cost_model=cost_model,
                    engine_config=engine_config)
                self.version += 1
            if activate or (activate is None
                            and model_id not in self._active):
                self._active[model_id] = rev_id
                self.version += 1
            return rev_id

    def set_active(self, model_id: str, revision: str) -> None:
        """Flip the model's active revision (DeployController commit)."""
        with self._lock:
            self._resolve(model_id, revision)
            self._active[model_id] = revision
            self.version += 1

    # ------------------------------------------------------------ lookup
    def _resolve(self, model_id: str, revision: Optional[str]
                 ) -> Revision:
        revs = self._revisions.get(model_id)
        if not revs:
            raise ValueError(
                f"unknown model {model_id!r}; published: "
                f"{sorted(self._revisions)}")
        rev_id = self._active[model_id] if revision is None else revision
        rev = revs.get(rev_id)
        if rev is None:
            raise ValueError(
                f"model {model_id!r} has no revision {rev_id!r}; "
                f"published: {sorted(revs)}")
        return rev

    def has_model(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._revisions

    def models(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._revisions))

    def revisions(self, model_id: str) -> Tuple[str, ...]:
        """Publish-ordered revision ids (the rollback lineage)."""
        with self._lock:
            revs = self._revisions.get(model_id)
            if revs is None:
                raise ValueError(f"unknown model {model_id!r}")
            return tuple(revs)

    def active(self, model_id: str) -> str:
        with self._lock:
            rev = self._active.get(model_id)
            if rev is None:
                raise ValueError(
                    f"unknown model {model_id!r}; published: "
                    f"{sorted(self._revisions)}")
            return rev

    def manifest(self, model_id: str, revision: str = None
                 ) -> Dict[str, str]:
        with self._lock:
            return dict(self._resolve(model_id, revision).manifest)

    def cost_model(self, model_id: str, revision: str = None):
        with self._lock:
            return self._resolve(model_id, revision).cost_model

    def describe(self) -> dict:
        """Telemetry snapshot: per model, the publish lineage and the
        active revision."""
        with self._lock:
            return {m: {"revisions": list(revs),
                        "active": self._active.get(m)}
                    for m, revs in sorted(self._revisions.items())}

    # ------------------------------------------------------------- build
    def build_engine(self, model_id: str, revision: Optional[str],
                     index: int, incarnation: int, label: str = None):
        """Build one engine of `model_id` at `revision` (None: active)
        for replica slot `index`. The config template is stamped with
        the (model, revision) key — every KV payload the engine exports
        carries it — and the revision's own prefill cost model."""
        with self._lock:
            rev = self._resolve(model_id, revision)
        return _engine_from_revision(rev, index, label=label)

    def engine_factory(self, model_id: str, revision: str) -> Callable:
        """The `engine_factory(index, incarnation)` a replica slot
        installs at swap_revision — pinned to ONE resolved Revision
        OBJECT, right here, so the closure never re-enters the
        registry: restarts of the swapped incarnation rebuild the same
        weights even after the registry moves on, and a swap or
        restart (which runs the factory under EngineReplica._lock)
        takes no ModelRegistry._lock."""
        with self._lock:
            rev = self._resolve(model_id, revision)

        def factory(index, incarnation):
            return _engine_from_revision(rev, index)

        return factory


# --------------------------------------------------------------- deploys
@dataclass
class DeployConfig:
    # pinned canary prompt set: greedy outputs on these must match the
    # OLD revision's within `canary_tolerance` mismatching prompts. The
    # defaults use tiny token ids so any test-sized vocab covers them;
    # production pins real regression prompts here.
    canary_prompts: tuple = ((1, 2, 3, 4), (2, 4, 6), (5, 1, 5, 1, 5))
    canary_max_tokens: int = 8
    # committed tolerance: how many of the canary prompts may diverge
    # from the old revision before the deploy aborts. 0 = the revisions
    # must agree greedily on every pinned prompt (a weight-format
    # migration); raise it only for deploys that INTEND output drift.
    canary_tolerance: int = 0
    # ticks a single replica may spend draining before the deploy gives
    # up and rolls back (the harness steps the router between ticks, so
    # one tick ~ one router step of drain progress)
    drain_wait_ticks: int = 600
    # steer new admissions toward the swapped revision in proportion to
    # pool progress (False: traffic follows the registry-active
    # revision until commit — a dark launch)
    shift_weights: bool = True

    def __post_init__(self):
        if not self.canary_prompts:
            raise ValueError("canary_prompts must not be empty")
        if self.canary_max_tokens < 1:
            raise ValueError("canary_max_tokens must be >= 1")
        if self.canary_tolerance < 0:
            raise ValueError("canary_tolerance must be >= 0")
        if self.drain_wait_ticks < 1:
            raise ValueError("drain_wait_ticks must be >= 1")


def _greedy_outputs(engine, prompts, max_tokens: int,
                    max_steps_each: int = 256) -> List[List[int]]:
    """Reference half of the canary parity gate: greedy decode of the
    pinned prompts on a PRIVATE engine (never in rotation), returning
    the emitted token lists. Every prompt must run to its full token
    budget — a reference that cannot serve is a failed deploy
    precondition, not a tolerable mismatch."""
    outs: List[List[int]] = []
    for i, prompt in enumerate(prompts):
        rid = engine.add_request(
            list(prompt),
            SamplingParams(max_tokens=max_tokens, temperature=0.0),
            request_id=f"canary-ref-p{i}")
        for _ in range(max_steps_each):
            engine.step()
            if engine.get_request(rid).finished:
                break
        req = engine.get_request(rid)
        if req.state != "finished_length":
            raise RuntimeError(
                f"canary reference {rid!r} ended {req.state!r} instead "
                f"of serving its tokens")
        outs.append([int(t) for t in req.output_ids])
    return outs


class DeployController:
    """Rolling revision deploy over one model's replica pool (module
    docstring). Usage:

        ctl = DeployController(rs, "chat", new_rev)
        ctl.start()
        while not ctl.done():
            rs.step()            # traffic keeps flowing
            ctl.tick()           # one bounded rollout action
        assert ctl.outcome == "committed"

    `tick()` performs at most ONE phase action (wait-for-drain, swap,
    canary, rejoin, commit/rollback) so the caller interleaves rollout
    progress with live traffic — the zero-downtime property is the
    interleaving, not a background thread."""

    _GUARDED_BY = {
        "phase": "_lock",
        "outcome": "_lock",
        "error": "_lock",
        "ticks": "_lock",
        "_queue": "_lock",
        "_pos": "_lock",
        "_swapped": "_lock",
        "_reference": "_lock",
        "_drain_waited": "_lock",
    }

    # phase machine: idle -> drain -> swap -> canary -> rejoin -> (next
    # slot: drain) ... -> committed | rolled_back | aborted
    TERMINAL = ("committed", "rolled_back", "aborted")

    def __init__(self, rs, model: str, revision: str,
                 config: DeployConfig = None, faults=None):
        registry = rs.config.models
        if registry is None:
            raise ValueError(
                "DeployController needs a ReplicaSet built over a "
                "ModelRegistry (RouterConfig.models)")
        self.rs = rs
        self.registry = registry
        self.model = model
        self.to_revision = revision
        self.from_revision = registry.active(model)
        if self.from_revision == revision:
            raise ValueError(
                f"model {model!r} is already at {revision!r}")
        registry.engine_factory(model, revision)   # must be published
        self.config = config or DeployConfig()
        self.faults = faults if faults is not None else rs.faults
        self.deploy_id = f"deploy-{model}-{next(_DEPLOY_IDS)}"
        self._lock = threading.RLock()
        self.phase = "idle"
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.ticks = 0
        self._queue: List[int] = []
        self._pos = 0
        self._swapped: List[int] = []
        self._reference: Optional[List[List[int]]] = None
        self._drain_waited = 0
        self._c_deploys = obs.counter(
            "serving_deploys_total",
            "weight rollouts by outcome (committed|rolled_back|"
            "aborted)", labels=("router", "outcome"))
        self._c_canary = obs.counter(
            "serving_canary_mismatches_total",
            "canary prompts whose greedy output diverged from the old "
            "revision during a deploy", labels=("router",)).labels(
                router=rs.label)
        self._g_rev = obs.gauge(
            "serving_model_revision",
            "1 for the revision a model's pool is actively serving "
            "(flips at deploy commit, snaps back on rollback)",
            labels=("router", "model", "revision"))

    # ------------------------------------------------------------ control
    def start(self) -> None:
        """Validate the rollout and build the canary reference outputs
        from a PRIVATE old-revision engine (never in rotation — replica
        engines keep serving while the reference decodes). Records
        deploy_start; the first tick() begins draining."""
        with self._lock:
            if self.phase != "idle":
                raise ValueError(
                    f"deploy {self.deploy_id} already {self.phase}")
            pool = self.rs.pool(self.model)
            if not pool:
                self._finish("aborted", "empty_pool")
                return
            span = obs.span("deploy.start", cat="deploy",
                            annotate=False,
                            args={"deploy": self.deploy_id})
            span.begin()
            try:
                ref_engine = self.registry.build_engine(
                    self.model, self.from_revision, 0, 0,
                    label=f"{self.deploy_id}-ref")
                self._reference = _greedy_outputs(
                    ref_engine, self.config.canary_prompts,
                    self.config.canary_max_tokens)
            except Exception as e:          # noqa: BLE001 — a deploy
                # that cannot build its reference aborts cleanly, it
                # does not crash the serving loop driving it
                self._finish("aborted", f"reference_failed: {e}")
                return
            finally:
                span.end()
            self._queue = list(pool)
            obs.reqtrace.record(
                "deploy_start", self.deploy_id, self.deploy_id,
                router=self.rs.label, model=self.model,
                from_revision=self.from_revision,
                to_revision=self.to_revision, replicas=len(pool))
            self._g_rev.labels(router=self.rs.label, model=self.model,
                               revision=self.from_revision).set(1)
            self._g_rev.labels(router=self.rs.label, model=self.model,
                               revision=self.to_revision).set(0)
            self.phase = "drain"
            self._drain_waited = 0
            self.rs.drain(self._queue[0], recompute=False)

    def done(self) -> bool:
        with self._lock:
            return self.phase in self.TERMINAL

    def status(self) -> dict:
        with self._lock:
            return {"deploy_id": self.deploy_id, "phase": self.phase,
                    "outcome": self.outcome, "error": self.error,
                    "model": self.model,
                    "from_revision": self.from_revision,
                    "to_revision": self.to_revision,
                    "swapped": list(self._swapped),
                    "pool": list(self._queue), "ticks": self.ticks}

    def tick(self) -> dict:
        """Advance the rollout by at most one bounded action; returns
        status(). Call interleaved with rs.step() — a tick never blocks
        on traffic, it only observes drain progress the router steps
        make."""
        with self._lock:
            if self.phase in self.TERMINAL:
                return self.status()
            if self.phase == "idle":
                raise ValueError("tick() before start()")
            self.ticks += 1
            span = obs.span("deploy.tick", cat="deploy", annotate=False,
                            args={"deploy": self.deploy_id,
                                  "phase": self.phase,
                                  "tick": self.ticks})
            span.begin()
            try:
                if self.phase == "drain":
                    self._tick_drain()
                elif self.phase == "swap":
                    self._tick_swap()
                elif self.phase == "canary":
                    self._tick_canary()
                elif self.phase == "rejoin":
                    self._tick_rejoin()
            finally:
                span.end()
            return self.status()

    # ------------------------------------------------------------- phases
    def _current(self):
        return self.rs.replicas[self._queue[self._pos]]

    def _tick_drain(self) -> None:
        from .replica import ReplicaState
        rep = self._current()
        if rep.state == ReplicaState.DRAINED:
            self.phase = "swap"
            return
        if rep.state in (ReplicaState.FAILED, ReplicaState.DOWN):
            # the slot died while draining (chaos): its requests
            # already failed over; roll the deploy back
            self._rollback(f"replica {rep.index} died while draining")
            return
        self._drain_waited += 1
        if self._drain_waited > self.config.drain_wait_ticks:
            # undrain so the slot rejoins rotation as-was
            self.rs.undrain(rep.index)
            self._rollback(
                f"replica {rep.index} still draining after "
                f"{self.config.drain_wait_ticks} ticks")

    def _tick_swap(self) -> None:
        rep = self._current()
        factory = self.registry.engine_factory(self.model,
                                               self.to_revision)
        if not rep.swap_revision(factory):
            self._rollback(
                f"replica {rep.index}: new revision failed to build "
                f"or probe")
            return
        self._swapped.append(rep.index)
        obs.reqtrace.record(
            "replica_swap", self.deploy_id, self.deploy_id,
            router=self.rs.label, replica=rep.index, model=self.model,
            revision=self.to_revision)
        # chaos window: the new engine is installed and probed but the
        # canary gate has NOT run — a kill here must roll back cleanly
        # (the swapped slot never served, so there is nothing to lose)
        if self.faults is not None and self.faults.kill_deploy(
                self.ticks, rep.index):
            rep.quarantine("kill_deploy: died between swap and canary")
            self._rollback(
                f"replica {rep.index} killed in the swap->canary "
                f"window")
            return
        self.phase = "canary"

    def _tick_canary(self) -> None:
        rep = self._current()
        try:
            outs = rep.canary_outputs(
                self.config.canary_prompts,
                max_tokens=self.config.canary_max_tokens)
        except Exception as e:              # noqa: BLE001 — a canary
            # that cannot serve is a failed candidate revision
            obs.reqtrace.record(
                "canary", self.deploy_id, self.deploy_id,
                router=self.rs.label, replica=rep.index,
                mismatches=-1, passed=False)
            self._rollback(f"replica {rep.index}: canary failed: {e}")
            return
        mism = sum(1 for got, want in zip(outs, self._reference)
                   if got != want)
        passed = mism <= self.config.canary_tolerance
        obs.reqtrace.record(
            "canary", self.deploy_id, self.deploy_id,
            router=self.rs.label, replica=rep.index, mismatches=mism,
            passed=passed)
        if mism:
            self._c_canary.inc(mism)
        if not passed:
            self._rollback(
                f"replica {rep.index}: {mism} canary prompts diverged "
                f"(tolerance {self.config.canary_tolerance})")
            return
        self.phase = "rejoin"

    def _tick_rejoin(self) -> None:
        rep = self._current()
        if not self.rs.probe_grow(rep.index):
            self._rollback(
                f"replica {rep.index}: swapped slot failed its rejoin "
                f"probe")
            return
        self._pos += 1
        if self.config.shift_weights:
            done, total = self._pos, len(self._queue)
            weights = {self.to_revision: float(done)}
            if total - done:
                weights[self.from_revision] = float(total - done)
            self.rs.set_route_weights(self.model, weights)
        if self._pos == len(self._queue):
            self._commit()
            return
        self.phase = "drain"
        self._drain_waited = 0
        self.rs.drain(self._queue[self._pos], recompute=False)

    # ---------------------------------------------------------- terminal
    def _commit(self) -> None:
        self.registry.set_active(self.model, self.to_revision)
        for idx in self._swapped:
            self.rs.replicas[idx].commit_revision()
        # active now IS the new revision: explicit weights come off
        self.rs.set_route_weights(self.model, None)
        obs.reqtrace.record(
            "deploy_commit", self.deploy_id, self.deploy_id,
            router=self.rs.label, model=self.model,
            revision=self.to_revision, replicas=len(self._swapped))
        self._g_rev.labels(router=self.rs.label, model=self.model,
                           revision=self.to_revision).set(1)
        self._g_rev.labels(router=self.rs.label, model=self.model,
                           revision=self.from_revision).set(0)
        self._finish("committed", None)

    def _rollback(self, reason: str) -> None:
        """Atomic rollback: every swapped slot restores its warm
        old-revision engine (newest swap first — the reverse of the
        rollout), rejoins through the probe gate, and the route weights
        snap back to the old revision. A swapped slot that already
        rejoined rotation may hold live new-revision requests; those
        evacuate through the router's zero-lost failover FIRST
        (rs.evict — re-admission re-prefills from the token log and
        _repin records the fresh `admitted` that keeps invariant 8
        honest), because restore_revision replaces the engine object
        and would strand them. Slots that never swapped were never
        touched beyond a drain, which undrain/probe_grow reverses."""
        restored = 0
        for idx in reversed(self._swapped):
            rep = self.rs.replicas[idx]
            if rep.is_serving() and rep.has_unfinished():
                self.rs.evict(idx, "rollback",
                              f"{self.deploy_id}: {reason}")
            if rep.restore_revision():
                restored += 1
                self.rs.probe_grow(idx)
        # a mid-drain slot (never swapped) rejoins as-was
        if self._pos < len(self._queue):
            rep = self._current()
            from .replica import ReplicaState
            if rep.state == ReplicaState.DRAINING:
                self.rs.undrain(rep.index)
            elif rep.state == ReplicaState.DRAINED \
                    and rep.index not in self._swapped:
                self.rs.probe_grow(rep.index)
        self.rs.set_route_weights(self.model, None)
        obs.reqtrace.record(
            "rollback", self.deploy_id, self.deploy_id,
            router=self.rs.label, model=self.model,
            reason=reason, restored=restored,
            revision=self.from_revision)
        self._g_rev.labels(router=self.rs.label, model=self.model,
                           revision=self.from_revision).set(1)
        self._g_rev.labels(router=self.rs.label, model=self.model,
                           revision=self.to_revision).set(0)
        self._finish("rolled_back" if self._swapped else "aborted",
                     reason)

    def _finish(self, outcome: str, error: Optional[str]) -> None:
        self.phase = outcome
        self.outcome = outcome
        self.error = error
        self._c_deploys.labels(router=self.rs.label,
                               outcome=outcome).inc()

    # -------------------------------------------------------- convenience
    def run(self, max_ticks: int = 5000) -> dict:
        """Drive the rollout to a terminal state, stepping the router
        between ticks (tests and offline deploys; live callers
        interleave tick() with their own serving loop)."""
        with self._lock:
            idle = self.phase == "idle"
        if idle:
            self.start()
        ticks = 0
        while not self.done() and ticks < max_ticks:
            self.rs.step()
            self.tick()
            ticks += 1
        if not self.done():
            with self._lock:
                self._rollback(f"deploy incomplete after {max_ticks} "
                               f"ticks")
        return self.status()
