"""Deterministic fault injectors for the training runtime and the
serving engine.

Port of paddle_tpu/testing/faults.py (host Python in both packages).
Training spec grammar (env `PADDLE_TPU_FAULTS` or constructor arg),
comma-separated `fault@step[:arg]` items:

    kill@12          SIGKILL-style death (os._exit) at the top of step 12
    nan@5            poison the loss with NaN at step 5
    stall@7:3600     hang for 3600s at step 7
    corrupt@12       truncate the NEWEST checkpoint snapshot at step 12

Every training injector fires ONCE per fault-injection state dir
(`PADDLE_TPU_FAULT_STATE_DIR`, marker files created O_CREAT|O_EXCL), so
a restarted worker sails past the step that killed its predecessor.
`ServingFaultInjector` (env `PADDLE_TPU_SERVE_FAULTS`) is the serving
engine's twin; its docstring lists its kinds.

Differences from the JAX package: `corrupt_cache` writes NaN in place
into layer 0's K pool (in int8 pool mode, into that block's layer-0 K
scales, which is what the JAX setter's re-encode of a NaN block
amounts to); the JAX version rebinds the pool. The fleet kinds
(kill_replica, wedge_replica, kill_migration, kill_deploy) parse and
claim as in the reference; their callers (the replica set, migration
and deploy controller) are not ported yet.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["FaultInjector", "ServingFaultInjector", "corrupt_checkpoint"]

SPEC_ENV = "PADDLE_TPU_FAULTS"
STATE_DIR_ENV = "PADDLE_TPU_FAULT_STATE_DIR"
SERVE_SPEC_ENV = "PADDLE_TPU_SERVE_FAULTS"

KINDS = ("kill", "nan", "stall", "corrupt")
SERVE_KINDS = ("nan_logits", "stall", "cache_corrupt", "burst",
               "kill_replica", "wedge_replica", "kill_migration",
               "kill_promotion", "kill_demotion", "corrupt_host_block",
               "kill_deploy")
KILL_EXIT_CODE = 37  # distinctive, so supervisors/tests can assert on it


def _parse(spec: str,
           kinds: Tuple[str, ...] = KINDS
           ) -> List[Tuple[str, int, Optional[float]]]:
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        kind, _, rest = item.partition("@")
        if kind not in kinds:
            raise ValueError(f"unknown fault kind {kind!r} in {spec!r} "
                             f"(known: {kinds})")
        step_s, _, arg_s = rest.partition(":")
        out.append((kind, int(step_s), float(arg_s) if arg_s else None))
    return out


def corrupt_checkpoint(save_dir: str, mode: str = "truncate"):
    """Damage the NEWEST complete snapshot under `save_dir` the way a
    remote filesystem does (truncation after the atomic rename), to drive
    AutoCheckpointManager.restore_latest's quarantine path. Returns the
    path corrupted, or None when no snapshot exists."""
    import json
    snaps = []
    for name in os.listdir(save_dir):
        kind, _, idx = name.partition("_")
        if kind in ("epoch", "step") and idx.isdigit():
            meta = os.path.join(save_dir, name, "meta.json")
            if os.path.exists(meta):
                try:
                    with open(meta) as f:
                        t = json.load(f).get("time", 0)
                except (OSError, ValueError):
                    t = 0
                snaps.append((t, os.path.join(save_dir, name)))
    if not snaps:
        return None
    snaps.sort(reverse=True)
    target = os.path.join(snaps[0][1], "state.pdparams")
    if mode == "truncate":
        with open(target, "rb") as f:
            head = f.read(10)
        with open(target, "wb") as f:
            f.write(head)
    elif mode == "delete":
        os.remove(target)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return target


class FaultInjector:
    """Step-addressed fault injection with fire-once semantics.

    Construct with an explicit spec, or leave both args None to read the
    `PADDLE_TPU_FAULTS` / `PADDLE_TPU_FAULT_STATE_DIR` env contract — the
    form a supervised worker uses, since env survives the restart while
    process state does not. With no spec the injector is inert (every call
    is a cheap no-op), so production code paths may call it
    unconditionally.
    """

    def __init__(self, spec: Optional[str] = None,
                 state_dir: Optional[str] = None):
        spec = os.environ.get(SPEC_ENV) if spec is None else spec
        self.state_dir = (os.environ.get(STATE_DIR_ENV)
                          if state_dir is None else state_dir)
        self.faults: Dict[int, List[Tuple[str, Optional[float]]]] = {}
        for kind, step, arg in _parse(spec or ""):
            self.faults.setdefault(step, []).append((kind, arg))
        if self.faults and self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return bool(self.faults)

    # ------------------------------------------------------------ markers
    def _fire_once(self, kind: str, step: int) -> bool:
        """Atomically claim this (kind, step) fault; False if a previous
        incarnation already fired it (or no state dir tracks firing)."""
        if not self.state_dir:
            return True  # untracked: fire every time (unit-test mode)
        marker = os.path.join(self.state_dir, f"fired.{kind}.{step}")
        try:
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.write(fd, str(time.time()).encode())
        os.close(fd)
        return True

    def fired(self, kind: str, step: int) -> bool:
        if not self.state_dir:
            return False
        return os.path.exists(os.path.join(self.state_dir,
                                           f"fired.{kind}.{step}"))

    # ------------------------------------------------------------- firing
    def step(self, step: int, checkpoint_dir: Optional[str] = None):
        """Trigger the non-loss faults scheduled for `step`; call at the
        top of the training step. Order within a step: stall → corrupt →
        kill, so `corrupt@N,kill@N` models a crash that tears the newest
        snapshot on its way down."""
        if not self.enabled or step not in self.faults:
            return
        planned = dict()
        for kind, arg in self.faults[step]:
            planned[kind] = arg
        if "stall" in planned and self._fire_once("stall", step):
            time.sleep(planned["stall"] if planned["stall"] else 3600.0)
        if "corrupt" in planned and self._fire_once("corrupt", step):
            if checkpoint_dir is None:
                raise ValueError("corrupt@N needs checkpoint_dir")
            corrupt_checkpoint(checkpoint_dir)
        if "kill" in planned and self._fire_once("kill", step):
            # os._exit: no atexit/finally handlers — models SIGKILL-grade
            # preemption where nothing gets to clean up or checkpoint
            os.sys.stdout.flush()
            os.sys.stderr.flush()
            os._exit(KILL_EXIT_CODE)

    def poison_loss(self, step: int, loss):
        """Return `loss` NaN-poisoned if a nan@step fault is armed (framework
        Tensor or torch/numpy array; preserves type via multiplication)."""
        if not self.enabled or step not in self.faults:
            return loss
        if any(k == "nan" for k, _ in self.faults[step]) \
                and self._fire_once("nan", step):
            return loss * float("nan")
        return loss


class ServingFaultInjector:
    """Deterministic step-addressed fault injection for the serving
    engine — the serving twin of FaultInjector, exercising the hardened
    LLMEngine step (anomaly quarantine, watchdog, cache rebuild,
    admission control) instead of the training supervisor.

    Spec grammar (env `PADDLE_TPU_SERVE_FAULTS` or constructor arg),
    comma-separated `fault@step[:arg]`:

        nan_logits@5[:row]    poison row `row` (default 0) of the first
                              logits computed at/after engine step 5 —
                              models a poisoned device step
        stall@7:0.2           sleep 0.2s inside the decode phase of step
                              7 — models a stuck device call; trips the
                              engine watchdog when step_timeout_s < arg
        cache_corrupt@9       overwrite the first allocated block of the
                              earliest live sequence with NaN — models
                              torn paged-cache state; detected as
                              non-finite logits on that sequence's next
                              decode
        burst@3:8             report 8 extra arrivals due at step 3 —
                              consumed by chaos harnesses (burst())
                              to drive admission control
        kill_replica@6[:r]    replica-level crash: replica `r` (default
                              0) of a ReplicaSet raises ReplicaCrashed
                              at the top of its step at/after ROUTER
                              step 6 — models a dead engine process;
                              the router quarantines it and fails its
                              requests over to survivors
        wedge_replica@8[:r]   replica-level hang: replica `r` stops
                              making progress AND stops beating its
                              heartbeat — models a hung device call;
                              detected by the router's heartbeat-based
                              wedge check (heartbeat_timeout_s)
        kill_migration@6[:r]  replica `r` dies INSIDE a KV-block
                              migration it is the SOURCE of, in the
                              window after the destination admitted but
                              before the source released — the
                              narrowest transactional window; the
                              coordinator rolls the destination back
                              and the router fails the source over
                              (kill_replica can never land there: the
                              replica's own step claims it first)
        kill_promotion@4      cut the next host→device prefix promotion
                              short at/after step 4 — the entry stays
                              host-resident (retryable) and the request
                              degrades to re-prefill of the suffix
        kill_demotion@6       cut the next device→host spill short —
                              nothing reaches the host tier half-written;
                              the victim block is plainly evicted instead
        corrupt_host_block@8  flip one value in the LRU-oldest host-tier
                              entry WITHOUT updating its sha256 — models
                              torn host RAM; caught by the digest check
                              on the next promotion/export (outcome
                              "integrity" → re-prefill). Slides while
                              the host tier is empty
        kill_deploy@5[:r]     replica `r` dies INSIDE a rolling weight
                              deploy, in the window after its new
                              revision swapped in but before the canary
                              parity gate ran — the narrowest rollout
                              window (serving/deploy.py); the controller
                              quarantines the slot and rolls the whole
                              deploy back to the old revision

    Each fault fires ONCE per injector instance, at the first
    opportunity AT OR AFTER its step (a fault armed for a step where its
    hook has nothing to act on — no live sequences, empty decode — slides
    to the next step), which keeps seeded chaos schedules deterministic
    without hand-aligning them to the engine's phase timing. With no
    spec the injector is inert and every hook is a cheap no-op, so the
    engine calls it unconditionally."""

    def __init__(self, spec: Optional[str] = None):
        spec = os.environ.get(SERVE_SPEC_ENV) if spec is None else spec
        self.faults = _parse(spec or "", kinds=SERVE_KINDS)
        self._fired = set()
        self.fired_log: List[Tuple[str, int]] = []  # (kind, engine step)

    @property
    def enabled(self) -> bool:
        return bool(self.faults)

    def _claim(self, kind: str, step: int) -> Optional[float]:
        """First unfired `kind` fault armed for a step <= `step`; marks
        it fired and returns its arg (None if nothing due)."""
        for i, (k, s, arg) in enumerate(self.faults):
            if k == kind and s <= step and i not in self._fired:
                self._fired.add(i)
                self.fired_log.append((kind, step))
                return arg if arg is not None else float("nan")
        return None

    def _claim_targeted(self, kind: str, step: int, target: int) -> bool:
        """Replica-targeted twin of _claim: only a fault whose arg names
        `target` (default replica 0) fires, and only the ROUTER calls
        these hooks — the same at-or-after slide applies per target."""
        for i, (k, s, arg) in enumerate(self.faults):
            if k == kind and s <= step and i not in self._fired:
                t = 0 if arg is None or arg != arg else int(arg)
                if t == target:
                    self._fired.add(i)
                    self.fired_log.append((kind, step))
                    return True
        return False

    # ------------------------------------------------------------- hooks
    def stall(self, step: int):
        """Engine hook, top of the decode phase: sleep `arg` seconds
        (default 0.05) — long enough to overrun a test-sized
        step_timeout_s, short enough for CI."""
        if not self.enabled:
            return
        arg = self._claim("stall", step)
        if arg is not None:
            time.sleep(0.05 if arg != arg else arg)   # NaN -> default

    def poison_logits(self, step: int, logits):
        """Engine hook on every host-side logits array ([V] prefill row
        or [N, V] decode batch): NaN-poison the armed row of the first
        logits seen at/after the armed step."""
        if not self.enabled:
            return logits
        arg = self._claim("nan_logits", step)
        if arg is None:
            return logits
        import numpy as np
        logits = np.array(logits)                     # private copy
        if logits.ndim == 1:
            logits[0] = np.nan
        else:
            row = 0 if arg != arg else int(arg)
            logits[min(row, logits.shape[0] - 1), 0] = np.nan
        return logits

    def poison_chunk(self, step: int, bad):
        """Engine hook on the fetched per-row not-finite flags of a
        fused decode chunk (the device-resident twin of poison_logits:
        with sampling on device there are no host logits to poison, so
        the fault flips the armed row's anomaly flag instead — the
        engine's quarantine path downstream of the flags is identical).
        Claims a 'nan_logits' fault so chaos specs stay
        decode-path-agnostic."""
        if not self.enabled:
            return bad
        arg = self._claim("nan_logits", step)
        if arg is None:
            return bad
        import numpy as np
        bad = np.array(bad)                           # private copy
        row = 0 if arg != arg else int(arg)           # NaN -> default
        bad[min(row, len(bad) - 1)] = True
        return bad

    def corrupt_cache(self, step: int, cache):
        """Engine hook, top of step: overwrite the first block of the
        earliest live sequence with NaN in layer 0's K pool (enough to
        poison that sequence's next decode logits). Slides to a later
        step while no sequence holds blocks."""
        if not self.enabled or not cache._tables:
            return
        if self._claim("cache_corrupt", step) is None:
            return
        seq_id = next(iter(cache._tables))
        cache.corrupt_block(cache._tables[seq_id][0])

    def kill_replica(self, step: int, replica: int) -> bool:
        """Router hook, top of replica `replica`'s step: True exactly
        once when a kill_replica fault targeting this replica is due at
        or after router step `step` — the replica raises ReplicaCrashed,
        modelling SIGKILL-grade engine death (host state unreachable)."""
        if not self.enabled:
            return False
        return self._claim_targeted("kill_replica", step, replica)

    def wedge_replica(self, step: int, replica: int) -> bool:
        """Router hook, top of replica `replica`'s step: True exactly
        once when a wedge_replica fault targeting this replica is due —
        the replica latches wedged (no progress, no heartbeat) until the
        router's heartbeat check quarantines and restarts it."""
        if not self.enabled:
            return False
        return self._claim_targeted("wedge_replica", step, replica)

    def kill_migration(self, step: int, replica: int) -> bool:
        """Migration-coordinator hook, between destination-admit and
        source-release of a migration whose SOURCE is `replica`: True
        exactly once when a kill_migration fault targeting it is due —
        the coordinator rolls the destination back and raises
        ReplicaCrashed for the source, driving the half-migrated
        re-prefill path end to end."""
        if not self.enabled:
            return False
        return self._claim_targeted("kill_migration", step, replica)

    def kill_deploy(self, step: int, replica: int) -> bool:
        """DeployController hook, between swap_revision and the canary
        gate on replica `replica`: True exactly once when a kill_deploy
        fault targeting it is due at or after deploy tick `step` — the
        freshly-swapped (never-served) incarnation dies, the controller
        quarantines the slot and rolls the deploy back."""
        if not self.enabled:
            return False
        return self._claim_targeted("kill_deploy", step, replica)

    def kill_promotion(self, step: int) -> bool:
        """Cache hook, inside `PagedKVCache._promote_node`: True exactly
        once when a kill_promotion fault is due — the in-flight
        host→device fill stops before touching the device pool, the
        promotion reports outcome "timeout" (entry stays host-resident,
        retryable) and the request re-prefills the missing suffix."""
        if not self.enabled:
            return False
        return self._claim("kill_promotion", step) is not None

    def kill_demotion(self, step: int) -> bool:
        """Cache hook, in `PagedKVCache._evict_cached`'s victim
        selection: True exactly once when a kill_demotion fault is due
        — the spill aborts before anything of the victim's is read or
        reaches the host store (no half-written entry) and the victim
        block falls back to plain eviction."""
        if not self.enabled:
            return False
        return self._claim("kill_demotion", step) is not None

    def corrupt_host_block(self, step: int, cache) -> None:
        """Engine hook, top of step: flip one value in the LRU-oldest
        host-tier entry without updating its digest (HostTierStore.
        corrupt_oldest) — torn host RAM, detected by the sha256 check on
        the next fill. Slides to a later step while the cache has no
        host tier or it is empty."""
        if not self.enabled:
            return
        host = getattr(cache, "host_tier", None)
        if host is None or len(host) == 0:
            return
        if self._claim("corrupt_host_block", step) is None:
            return
        host.corrupt_oldest()

    def burst(self, step: int) -> int:
        """Harness hook: number of extra arrivals due now (0 if none) —
        drives admission-control/shed paths in chaos runs."""
        if not self.enabled:
            return 0
        arg = self._claim("burst", step)
        return 0 if arg is None or arg != arg else int(arg)
