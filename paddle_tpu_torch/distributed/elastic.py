"""Elastic fault-tolerant launch: supervised workers with restart and a
heartbeat (port of paddle_tpu/distributed/elastic.py).

Host Python in both packages. The supervisor runs a gang of worker
processes, restarts one that crashed with capped exponential backoff
and jitter (`BackoffPolicy`, the schedule the serving replica
supervisor shares), and kills and restarts one whose heartbeat went
stale. A restarted worker re-enters training through
`AutoCheckpointManager.restore_latest()` (its `train_step_range` /
`train_epoch_range` do it), so a restart loses at most one save
interval.

The environment contract is the reference's: each incarnation gets
`PADDLE_TRAINER_ID` / `PADDLE_TRAINERS_NUM`, its own heartbeat file
(`PADDLE_ELASTIC_HEARTBEAT_FILE`), `PADDLE_ELASTIC_RESTART_COUNT` and
`PADDLE_ELASTIC_MAX_RESTARTS`. `heartbeat()` touches the file; the
checkpoint manager's ranges, `LLMEngine.step` and `ServingPredictor.run`
beat it, as in the JAX package. A worker counts as hung once no new
beat has been seen for `heartbeat_timeout` seconds; before its first
beat (imports, CUDA start-up, the first step) it never does. The report
(`nprocs`, `restarts`, `history`), the `elastic.start` span and the
`elastic_restarts_total` counter are the reference's.

One addition: a keyword-only `clock` (default `time.monotonic`). The
supervisor notes the clock's reading when it first sees each new beat,
and decides hangs and backoff deadlines on it; a clock with `tick()` is
advanced once a monitor pass, so the verdicts can be made a function of
the passes, as the fleet's are (`tools/chaos_serve.SteppedClock`). The
reference reads the beat's age from the file's wall-clock mtime; here
the age starts when the supervisor sees the beat, at most one monitor
interval later.

Workers given as a callable start in a `spawn` context (never `fork`:
a CUDA process cannot fork).

    python -m paddle_tpu_torch.distributed.elastic --max_restarts 2 \\
        --heartbeat_timeout 30 worker.py [worker args]
"""
from __future__ import annotations

import os
import random
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Union

__all__ = ["BackoffPolicy", "ElasticSupervisor", "ElasticJobError",
           "WorkerSpec", "elastic_spawn", "heartbeat"]

# env contract (in addition to the PADDLE_TRAINER_* launch contract)
HEARTBEAT_FILE_ENV = "PADDLE_ELASTIC_HEARTBEAT_FILE"
RESTART_COUNT_ENV = "PADDLE_ELASTIC_RESTART_COUNT"
MAX_RESTARTS_ENV = "PADDLE_ELASTIC_MAX_RESTARTS"


def heartbeat():
    """Touch this worker's heartbeat file (a no-op outside a supervised
    run). Long custom loops call it at least once a heartbeat_timeout."""
    path = os.environ.get(HEARTBEAT_FILE_ENV)
    if not path:
        return
    try:
        with open(path, "a"):
            os.utime(path, None)
    except OSError:
        pass  # a beat lost to the filesystem must never kill the step


class BackoffPolicy:
    """Capped exponential restart backoff with seeded multiplicative
    jitter: delay(n) = min(max_delay, base * factor**n) * (1 + U[0,
    jitter)). One object serves every worker of a job (or replica of a
    fleet), so a correlated failure never restarts them in lockstep. The
    same seeded `random.Random` stream as the reference, so a seed gives
    the reference's delays exactly."""

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


class ElasticJobError(RuntimeError):
    """A worker exhausted its restart budget; carries the failure
    history [(incarnation, reason), ...]."""

    def __init__(self, msg, history=None):
        super().__init__(msg)
        self.history = history or []


class WorkerSpec:
    """One supervised worker: a subprocess argv or a picklable callable.

    cmd       : list[str] argv (subprocess) OR a callable (multiprocessing
                spawn; importable from the child).
    args      : positional args for a callable target.
    env       : extra env vars over os.environ (the supervisor's elastic
                vars are applied after them).
    log_path  : file receiving stdout+stderr (subprocess targets only),
                appended across restarts.
    """

    def __init__(self, cmd, args=(), env=None, log_path=None):
        self.cmd = cmd
        self.args = tuple(args)
        self.env = dict(env or {})
        self.log_path = log_path


class _Handle:
    """Supervisor-side state for one worker rank."""

    def __init__(self, rank, spec, heartbeat_path):
        self.rank = rank
        self.spec = spec
        self.heartbeat_path = heartbeat_path
        self.proc = None            # Popen or mp.Process
        self.restarts = 0           # completed restarts (incarnation - 1)
        self.done = False
        self.restart_at = None      # clock deadline while backing off
        self.started_at = None
        self.beat_mtime = None      # mtime of the newest beat seen
        self.beat_at = None         # clock reading when it was seen
        self.history = []           # [(incarnation, reason)]

    def alive(self):
        if self.proc is None:
            return False
        if hasattr(self.proc, "poll"):
            return self.proc.poll() is None
        return self.proc.is_alive()

    def exitcode(self):
        if hasattr(self.proc, "poll"):
            return self.proc.poll()
        return self.proc.exitcode

    def kill(self):
        if self.proc is None:
            return
        try:
            if hasattr(self.proc, "poll"):
                self.proc.kill()
            else:
                self.proc.terminate()
                if self.proc.is_alive():
                    self.proc.kill()
        except (OSError, AttributeError, ValueError):
            pass


def _mp_worker(func, rank, nprocs, args, env):
    os.environ.update(env)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    func(*args)


class ElasticSupervisor:
    """Supervise a gang of workers: restart crashes, detect hangs.

      max_restarts       per-worker restart budget; exceeding it kills
                         the gang and raises ElasticJobError
      backoff_base/factor/max, jitter
                         the restart delay of one rank: min(max, base *
                         factor**n) * (1 + U[0, jitter))
      heartbeat_timeout  seconds without a new beat before a worker
                         counts as hung (None: no hang detection)
      monitor_interval   supervisor poll period (seconds of real time)
      heartbeat_dir      where the heartbeat files go (a fresh temporary
                         directory when None)
      seed               the backoff jitter's seed
      clock              (keyword-only, port-only) the clock that hang
                         and backoff verdicts read; see the module
                         docstring
    """

    def __init__(self, max_restarts: int = 3, backoff_base: float = 0.25,
                 backoff_factor: float = 2.0, backoff_max: float = 30.0,
                 jitter: float = 0.25,
                 heartbeat_timeout: Optional[float] = None,
                 monitor_interval: float = 0.05,
                 heartbeat_dir: Optional[str] = None,
                 seed: Optional[int] = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.heartbeat_timeout = heartbeat_timeout
        self.monitor_interval = float(monitor_interval)
        self.heartbeat_dir = heartbeat_dir
        self.clock = clock
        self._backoff = BackoffPolicy(base=backoff_base,
                                      factor=backoff_factor,
                                      max_delay=backoff_max,
                                      jitter=jitter, seed=seed)

    # ------------------------------------------------------------- backoff
    def backoff_delay(self, n_prev_restarts: int) -> float:
        """Delay before restart #(n_prev_restarts+1) of one rank."""
        return self._backoff.delay(n_prev_restarts)

    # -------------------------------------------------------------- launch
    def _start(self, h: _Handle, nprocs: int):
        from .. import obs
        with obs.span("elastic.start", cat="restart", annotate=False,
                      args={"rank": h.rank, "incarnation": h.restarts}):
            self._start_inner(h, nprocs)

    def _start_inner(self, h: _Handle, nprocs: int):
        spec = h.spec
        env = dict(os.environ)
        # spec.env may override the rank mapping (a multi-node launch
        # numbers PADDLE_TRAINER_ID globally); the supervisor's elastic
        # vars are applied last and always win
        env.update({"PADDLE_TRAINER_ID": str(h.rank),
                    "PADDLE_TRAINERS_NUM": str(nprocs)})
        env.update(spec.env)
        env.update({
            RESTART_COUNT_ENV: str(h.restarts),
            MAX_RESTARTS_ENV: str(self.max_restarts),
            HEARTBEAT_FILE_ENV: h.heartbeat_path,
        })
        # a fresh heartbeat baseline per incarnation: the killed
        # incarnation's last beat must not trip the detector at once
        try:
            os.remove(h.heartbeat_path)
        except OSError:
            pass
        h.beat_mtime = h.beat_at = None
        if callable(spec.cmd):
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            child_env = {k: env[k] for k in
                         (RESTART_COUNT_ENV, MAX_RESTARTS_ENV,
                          HEARTBEAT_FILE_ENV)}
            child_env.update(spec.env)
            h.proc = ctx.Process(
                target=_mp_worker,
                args=(spec.cmd, h.rank, nprocs, spec.args, child_env))
            h.proc.start()
        else:
            out = open(spec.log_path, "a") if spec.log_path else None
            try:
                h.proc = subprocess.Popen(
                    list(spec.cmd), env=env, stdout=out,
                    stderr=subprocess.STDOUT if out else None)
            finally:
                if out is not None:
                    out.close()  # the child holds its own descriptor
        h.started_at = self.clock()
        h.restart_at = None

    def _hung(self, h: _Handle) -> bool:
        if self.heartbeat_timeout is None:
            return False
        try:
            mtime = os.path.getmtime(h.heartbeat_path)
        except OSError:
            return False  # no beat yet: still starting up
        now = self.clock()
        if mtime != h.beat_mtime:
            h.beat_mtime, h.beat_at = mtime, now
            return False
        return (now - h.beat_at) > self.heartbeat_timeout

    def _fail(self, h: _Handle, reason: str, handles: List[_Handle]):
        h.history.append((h.restarts, reason))
        if h.restarts >= self.max_restarts:
            for other in handles:
                other.kill()
            raise ElasticJobError(
                f"worker rank {h.rank} failed ({reason}) and exhausted its "
                f"restart budget ({self.max_restarts}); history: "
                f"{h.history}", history=h.history)
        delay = self.backoff_delay(h.restarts)
        h.restarts += 1
        h.proc = None
        h.restart_at = self.clock() + delay
        # restart decisions labelled hang or crash (the free-form reason
        # has too many values for a label)
        from .. import obs
        kind = "hang" if reason.startswith("hang") else "crash"
        obs.counter("elastic_restarts_total",
                    "worker restarts scheduled by the elastic supervisor",
                    labels=("kind",)).labels(kind=kind).inc()

    # ----------------------------------------------------------------- run
    def run(self, workers: Union[Callable, Sequence], args=(), nprocs=None):
        """Run the gang to completion; returns the per-rank report
        {"nprocs", "restarts": {rank: n}, "history": {rank: [(incarnation,
        reason)]}}.

        `workers` is a list of WorkerSpec / argv lists, OR one callable
        (with `args` / `nprocs`, spawn-style). Raises ElasticJobError once
        a rank exceeds max_restarts.
        """
        if callable(workers):
            specs = [WorkerSpec(workers, args=args)
                     for _ in range(nprocs or 1)]
        else:
            specs = [w if isinstance(w, WorkerSpec) else WorkerSpec(list(w))
                     for w in workers]
        n = len(specs)
        hb_dir = self.heartbeat_dir
        if hb_dir is None:
            import tempfile
            hb_dir = tempfile.mkdtemp(prefix="paddle_elastic_hb_")
        os.makedirs(hb_dir, exist_ok=True)
        handles = [_Handle(r, s, os.path.join(hb_dir, f"hb.{r}"))
                   for r, s in enumerate(specs)]
        tick = getattr(self.clock, "tick", None)
        for h in handles:
            self._start(h, n)
        try:
            while not all(h.done for h in handles):
                if tick is not None:
                    tick()
                for h in handles:
                    if h.done:
                        continue
                    if h.proc is None:  # backing off
                        if self.clock() >= h.restart_at:
                            self._start(h, n)
                        continue
                    if h.alive():
                        if self._hung(h):
                            h.kill()
                            # reap before restarting, so the dead
                            # incarnation is not polled as a crash next
                            self._join(h)
                            self._fail(h, "hang (heartbeat timeout)",
                                       handles)
                        continue
                    code = self.exit_of(h)
                    if code == 0:
                        h.done = True
                    else:
                        self._fail(h, f"exit code {code}", handles)
                time.sleep(self.monitor_interval)
        except BaseException:
            for h in handles:
                h.kill()
            raise
        return {
            "nprocs": n,
            "restarts": {h.rank: h.restarts for h in handles},
            "history": {h.rank: list(h.history) for h in handles},
        }

    @staticmethod
    def _join(h: _Handle):
        try:
            if hasattr(h.proc, "wait"):
                h.proc.wait(timeout=10)
            else:
                h.proc.join(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass

    @staticmethod
    def exit_of(h: _Handle) -> int:
        code = h.exitcode()
        return 1 if code is None else code


def elastic_spawn(func, args=(), nprocs=1, max_restarts=3,
                  heartbeat_timeout=None, **options):
    """`spawn` with supervision: crashed workers restart with backoff and
    resume from the last auto-checkpoint instead of failing the job."""
    sup = ElasticSupervisor(max_restarts=max_restarts,
                            heartbeat_timeout=heartbeat_timeout, **options)
    return sup.run(func, args=args, nprocs=nprocs)


def main(argv=None):
    """python -m paddle_tpu_torch.distributed.elastic [--flags] script
    args...: each of --nproc_per_node workers restarted on a crash or a
    hang up to --max_restarts times."""
    import argparse
    ap = argparse.ArgumentParser("paddle_tpu_torch.distributed.elastic")
    ap.add_argument("--nproc_per_node", type=int, default=1)
    ap.add_argument("--max_restarts", type=int, default=3)
    ap.add_argument("--heartbeat_timeout", type=float, default=None)
    ap.add_argument("--backoff_base", type=float, default=0.25)
    ap.add_argument("--backoff_max", type=float, default=30.0)
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("training_script")
    ap.add_argument("training_script_args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    if ns.log_dir:
        os.makedirs(ns.log_dir, exist_ok=True)
    # the reference names its TPU (FLAGS_selected_tpus); a worker here
    # sees only the card of its rank (the rank-th of the cards this
    # process sees), which is then its cuda:0, the port's default device
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (visible.split(",") if visible
             else [str(r) for r in range(ns.nproc_per_node)])
    specs = []
    for rank in range(ns.nproc_per_node):
        log = (os.path.join(ns.log_dir, f"worker.{rank}.log")
               if ns.log_dir else None)
        specs.append(WorkerSpec(
            [sys.executable, ns.training_script] + ns.training_script_args,
            env={"CUDA_VISIBLE_DEVICES": cards[rank % len(cards)]},
            log_path=log))
    sup = ElasticSupervisor(max_restarts=ns.max_restarts,
                            heartbeat_timeout=ns.heartbeat_timeout,
                            backoff_base=ns.backoff_base,
                            backoff_max=ns.backoff_max)
    report = sup.run(specs)
    print(f"elastic job done: restarts={report['restarts']}")


if __name__ == "__main__":
    main()
