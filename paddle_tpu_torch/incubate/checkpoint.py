"""Auto-checkpoint: periodic training snapshots with automatic resume
(port of paddle_tpu/incubate/checkpoint.py; reference:
incubate/checkpoint/auto_checkpoint.py and checkpoint_saver.py).

The same on-disk format as the JAX module, so a snapshot written by one
package restores in the other: `epoch_<i>` / `step_<i>` directories
renamed into place atomically, each with `state.pdparams` (the
framework_io pickle of {epoch, step, time, models, optimizers,
lr_schedulers, rng}), the sha256 manifest `checksums.json` and
`meta.json`. Restores quarantine snapshots that fail to parse or to
verify and fall back to the next newest. The `checkpoint.save` /
`checkpoint.restore` spans and the save / restore histograms and the
quarantine counter are the JAX module's (:206-326). The ranges beat
the elastic heartbeat once an epoch or step (distributed/elastic.py),
so a supervisor sees a hung step, as in the JAX module (:375, :403).

Differences, each for the port's reasons:
- `_to_host` copies: a CPU tensor's `.numpy()` is a view of its
  storage, and an async save would otherwise write whatever the
  optimizer steps that follow it put there (JAX arrays are immutable,
  so the reference never met this).
- `rng` is the CPU torch generator's state (a uint8 array). A snapshot
  of the JAX package carries (seed, draw counter) of a threefry stream;
  restoring one here reseeds with its seed.
- `save_sharded_state` takes torch tensors, each written as one whole
  shard (the port has no device mesh yet).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Iterator, List, Optional

import hashlib

import numpy as np
import torch

from ..distributed.elastic import heartbeat

__all__ = ["AutoCheckpointManager", "train_epoch_range", "register",
           "save_sharded_state", "load_sharded_state", "CHECKSUM_FILE"]

CHECKSUM_FILE = "checksums.json"


def _to_host(obj):
    """Recursively copy every tensor to host numpy (bfloat16 as
    ml_dtypes' bfloat16), preserving container structure. Always a copy,
    never a view of live storage."""
    if isinstance(obj, torch.Tensor):
        from ..framework_io import _to_numpy
        a = _to_numpy(obj)
        return a.copy() if obj.device.type == "cpu" else a
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_host(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _array_manifest(state, prefix="$"):
    """sha256 per array leaf of a (host-side) state tree, keyed by JSON
    path. Hashes contiguous raw bytes, so the digest is layout-
    independent."""
    out = {}
    if isinstance(state, np.ndarray):
        out[prefix] = hashlib.sha256(
            np.ascontiguousarray(state).tobytes()).hexdigest()
    elif isinstance(state, dict):
        for k in sorted(state):
            out.update(_array_manifest(state[k], f"{prefix}.{k}"))
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            out.update(_array_manifest(v, f"{prefix}[{i}]"))
    return out


class AutoCheckpointManager:
    """Periodic save + resume of the full training state
    (paddle_tpu/incubate/checkpoint.py:67).

    Usage:
        acp = AutoCheckpointManager("ckpt_dir", models=[m], optimizers=[o])
        for epoch in acp.train_epoch_range(10):
            train_one_epoch(...)
    A killed-and-restarted run resumes from the last finished epoch with
    identical subsequent state (tests/test_checkpoint.py).
    """

    def __init__(self, save_dir: str, models=(), optimizers=(),
                 lr_schedulers=(), max_keep: int = 3,
                 save_interval_epochs: int = 1, async_save: bool = False,
                 save_every_n_steps: Optional[int] = None,
                 require_manifest: bool = False):
        self.save_dir = save_dir
        # strict-manifest mode (serving/deploy.py publishes revisions
        # through this): a snapshot with no checksums.json is treated as
        # corrupt instead of tolerated — a deploy must never load
        # weights it cannot verify. Default False keeps pre-manifest
        # snapshots restorable for ordinary training resume.
        self.require_manifest = bool(require_manifest)
        self.models = list(models)
        self.optimizers = list(optimizers)
        self.lr_schedulers = list(lr_schedulers)
        self.max_keep = max_keep
        self.save_interval = max(int(save_interval_epochs), 1)
        # step-granular mode (elastic restart window bound): train_step_range
        # snapshots every N steps into step_N dirs, so a supervised worker
        # killed mid-epoch resumes at most N-1 steps back, not epoch-0
        self.save_every_n_steps = (None if save_every_n_steps is None
                                   else max(int(save_every_n_steps), 1))
        self.async_save = async_save
        self._pending = None  # in-flight async save (threading.Thread)
        self._async_error = None
        # (kind, index) of the snapshot restore_latest() actually loaded
        self.restored_kind: Optional[str] = None
        self.restored_index: Optional[int] = None
        os.makedirs(save_dir, exist_ok=True)

    # ---------------------------------------------------------------- state
    def _collect(self, epoch: int, step: Optional[int] = None) -> dict:
        from ..core import random as _random
        state = {"epoch": epoch, "step": step, "time": time.time(),
                 "models": [m.state_dict() for m in self.models],
                 "optimizers": [o.state_dict() for o in self.optimizers],
                 "lr_schedulers": [s.state_dict()
                                   for s in self.lr_schedulers],
                 "rng": _random.get_rng_state().numpy()}
        return state

    def _restore(self, state: dict):
        from ..core import random as _random
        for m, sd in zip(self.models, state["models"]):
            m.set_state_dict(sd)
        for o, sd in zip(self.optimizers, state["optimizers"]):
            o.set_state_dict(sd)
        for s, sd in zip(self.lr_schedulers, state["lr_schedulers"]):
            s.set_state_dict(sd)
        if "rng" in state:
            rng = _to_host(state["rng"])
            rng = np.asarray(rng)
            if rng.dtype == np.uint8 and rng.size > 2:
                _random.set_rng_state(torch.from_numpy(rng.copy()))
            else:
                # the JAX package's (seed, draw counter): its stream is
                # threefry, which no torch generator continues, so the
                # seed alone carries over
                _random.seed(int(rng.reshape(-1)[0]))

    # ----------------------------------------------------------------- save
    def _snap_dir(self, kind: str, idx: int) -> str:
        return os.path.join(self.save_dir, f"{kind}_{idx}")

    def _epoch_dir(self, epoch: int) -> str:
        return self._snap_dir("epoch", epoch)

    def save(self, epoch: int):
        """Atomic snapshot: write to a temp dir, rename into place, then
        prune old epochs (the reference's HDFS tmp+mv pattern). Joins any
        in-flight async save first — two concurrent _write threads would
        race _prune's '.tmp_*' sweep against the other's live temp dir."""
        self.wait()
        self._write(self._collect(epoch), epoch)

    def save_step(self, step: int, epoch: int = 0):
        """Step-granular atomic snapshot (step_N dir). Same durability
        contract as save(); used by train_step_range so an elastic restart
        replays at most save_every_n_steps-1 steps."""
        self.wait()
        self._write(self._collect(epoch, step=step), epoch,
                    kind="step", idx=step)

    def save_async(self, epoch: int):
        """Snapshot the state synchronously (cheap: the training state is
        functional, so collecting is reference-capture + host fetch), then
        serialize + write + rename in a background thread so disk/remote-fs
        latency overlaps the next epoch's compute. At most one save is in
        flight: a new save (or restore/exit) first joins the previous one.
        A failed background save re-raises at the next save/wait call —
        never silently dropped."""
        self._save_async_snapshot(self._collect(epoch), epoch)

    def save_step_async(self, step: int, epoch: int = 0):
        """Async twin of save_step (same contract as save_async)."""
        self._save_async_snapshot(self._collect(epoch, step=step), epoch,
                                  kind="step", idx=step)

    def _save_async_snapshot(self, state, epoch, kind="epoch", idx=None):
        import threading
        self.wait()
        # host-materialise now, as COPIES: after this the background
        # thread touches nothing the training loop updates in place (a
        # CPU tensor's .numpy() is a view of its storage, which the next
        # optimizer step would rewrite under the writer)
        state = _to_host(state)

        def work():
            try:
                if kind == "epoch":  # two-arg form: the stable test seam
                    self._write(state, epoch)
                else:
                    self._write(state, epoch, kind=kind, idx=idx)
            except BaseException as e:  # surfaced on next wait()
                self._async_error = e

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self):
        """Join the in-flight async save (if any); re-raise its failure."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise err

    def _write(self, state: dict, epoch: int, kind: str = "epoch",
               idx: Optional[int] = None):
        from .. import framework_io, obs
        idx = epoch if idx is None else idx
        t0 = time.perf_counter()
        # span + histogram cover serialize/hash/rename (may run on the
        # async save thread — the obs sinks are thread-safe)
        span = obs.span("checkpoint.save", cat="checkpoint",
                        annotate=False,
                        args={"kind": kind, "index": idx})
        span.begin()
        tmp = tempfile.mkdtemp(dir=self.save_dir, prefix=".tmp_")
        try:
            framework_io.save(state, os.path.join(tmp, "state.pdparams"))
            # integrity manifest: hash what a verifier will actually load
            # back (round-trip through the serialized file), so dtype
            # normalisation inside save/load can't drift the digests
            digests = _array_manifest(framework_io.load(
                os.path.join(tmp, "state.pdparams"), return_numpy=True))
            with open(os.path.join(tmp, CHECKSUM_FILE), "w") as f:
                json.dump(digests, f)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"epoch": epoch, "kind": kind, "index": idx,
                           "time": time.time()}, f)
            final = self._snap_dir(kind, idx)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        finally:
            span.end()
        obs.histogram("checkpoint_save_seconds",
                      "snapshot write duration (serialize+hash+rename)",
                      labels=("kind",),
                      unit="seconds").labels(kind=kind).observe(
                          time.perf_counter() - t0)
        self._prune()

    def _prune(self):
        for kind in ("epoch", "step"):
            done = sorted(self._saved(kind))
            for e in done[:-self.max_keep]:
                shutil.rmtree(self._snap_dir(kind, e), ignore_errors=True)
        # stale temp dirs from crashed saves (the writer died before its
        # rename): harmless to restores (no meta outside a renamed dir)
        # but they accumulate on slow/remote filesystems — sweep them
        for name in os.listdir(self.save_dir):
            if name.startswith(".tmp_"):
                shutil.rmtree(os.path.join(self.save_dir, name),
                              ignore_errors=True)

    def _saved(self, kind: str) -> List[int]:
        out = []
        pre = kind + "_"
        if not os.path.isdir(self.save_dir):
            return out
        for name in os.listdir(self.save_dir):
            if name.startswith(pre) and name[len(pre):].isdigit():
                # (quarantined *.corrupt dirs don't count)
                meta = os.path.join(self.save_dir, name, "meta.json")
                if os.path.exists(meta):
                    out.append(int(name[len(pre):]))
        return out

    def _saved_epochs(self) -> List[int]:
        return self._saved("epoch")

    def _snapshots_newest_first(self):
        """All complete snapshots as (kind, idx), newest save first (by
        meta save time; epoch and step snapshots share one ordering so a
        mixed-mode run resumes from whichever landed last)."""
        snaps = []
        for kind in ("epoch", "step"):
            for idx in self._saved(kind):
                t = idx
                try:
                    with open(os.path.join(self._snap_dir(kind, idx),
                                           "meta.json")) as f:
                        t = json.load(f).get("time", idx)
                except (OSError, ValueError):
                    pass
                snaps.append((t, kind, idx))
        snaps.sort(reverse=True)
        return [(kind, idx) for _, kind, idx in snaps]

    def restore_latest(self) -> Optional[int]:
        """Load the newest complete snapshot; returns its epoch (or step,
        for step-granular snapshots) or None. Which kind was restored is
        left in .restored_kind/.restored_index.
        A snapshot that fails to parse (disk-level truncation/corruption
        AFTER the atomic rename — the failure mode remote filesystems add
        beyond the tmp+mv contract) OR whose per-array sha256 digests no
        longer match its checksums.json manifest (silent bit rot: the
        pickle still parses, the data is wrong) is quarantined with a
        warning and the next-newest snapshot is tried, so one bad file
        never bricks the resume path."""
        from .. import framework_io, obs
        self.wait()  # a restore racing an in-flight save would read torn
        t0 = time.perf_counter()
        for kind, idx in self._snapshots_newest_first():
            path = os.path.join(self._snap_dir(kind, idx), "state.pdparams")
            try:
                with obs.span("checkpoint.restore", cat="checkpoint",
                              annotate=False,
                              args={"kind": kind, "index": idx}):
                    state = framework_io.load(path)
                    self._verify_checksums(kind, idx, path)
            except Exception as e:
                import warnings
                obs.counter(
                    "checkpoint_quarantined_total",
                    "snapshots quarantined by restore (corrupt/bit-rot)"
                ).inc()
                bad = self._snap_dir(kind, idx)
                warnings.warn(
                    f"auto-checkpoint: snapshot {kind}_{idx} is corrupt "
                    f"({e!r}); quarantining {bad} and falling back",
                    RuntimeWarning)
                try:
                    os.rename(bad, bad + ".corrupt")
                except OSError:
                    shutil.rmtree(bad, ignore_errors=True)
                continue
            self._restore(state)
            self.restored_kind, self.restored_index = kind, idx
            obs.histogram(
                "checkpoint_restore_seconds",
                "restore_latest duration incl. quarantine fallbacks",
                unit="seconds").observe(time.perf_counter() - t0)
            return idx
        self.restored_kind = self.restored_index = None
        return None

    def _verify_checksums(self, kind: str, idx: int, path: str):
        """Recompute every array digest of a snapshot and compare against
        its checksums.json. Raises on any mismatch. A missing manifest
        is tolerated by default (pre-manifest snapshots stay restorable)
        but is a hard error under require_manifest=True — the
        strict-manifest mode published revisions (serving/deploy.py)
        restore with, so unverifiable weights never deploy. The data is
        re-loaded with return_numpy=True so digests see exactly the bytes
        the manifest hashed at save time."""
        manifest_path = os.path.join(os.path.dirname(path), CHECKSUM_FILE)
        if not os.path.exists(manifest_path):
            if self.require_manifest:
                raise IOError(
                    f"snapshot {kind}_{idx} has no {CHECKSUM_FILE} "
                    f"manifest (require_manifest=True refuses "
                    f"unverifiable weights)")
            return
        with open(manifest_path) as f:
            want = json.load(f)
        from .. import framework_io
        got = _array_manifest(framework_io.load(path, return_numpy=True))
        bad = sorted(k for k in set(want) | set(got)
                     if want.get(k) != got.get(k))
        if bad:
            raise IOError(
                f"checksum mismatch in snapshot {kind}_{idx} at "
                f"{bad[:3]}{'...' if len(bad) > 3 else ''} "
                f"({len(bad)}/{len(want)} arrays)")

    # ---------------------------------------------------------------- range
    def train_epoch_range(self, max_epoch_num: int) -> Iterator[int]:
        """reference: auto_checkpoint.py train_epoch_range — yields epoch
        indices, skipping epochs already completed by a previous run."""
        last = self.restore_latest()
        # restore_latest returns the newest snapshot of EITHER kind; a step
        # snapshot's index is not an epoch, so only an epoch snapshot may
        # advance the start (mirrors train_step_range's symmetric guard)
        start = 0 if self.restored_kind != "epoch" else last + 1
        try:
            for epoch in range(start, max_epoch_num):
                heartbeat()  # no-op outside a supervised run
                yield epoch
                if (epoch + 1) % self.save_interval == 0 \
                        or epoch == max_epoch_num - 1:
                    if self.async_save:
                        self.save_async(epoch)
                    else:
                        self.save(epoch)
        finally:
            # also runs on generator close (caller `break`): the last
            # dispatched snapshot must be durable — the writer thread is a
            # daemon and would be killed mid-rename at interpreter exit
            self.wait()

    def train_step_range(self, max_steps: int) -> Iterator[int]:
        """Step-granular twin of train_epoch_range for supervised elastic
        workers: yields step indices, snapshotting every
        `save_every_n_steps` (and at the final step), and resumes from the
        newest step snapshot after a kill — the restart window is bounded
        by the save interval instead of an epoch. Each step also beats the
        elastic heartbeat, so a hung step is detectable by the
        supervisor."""
        every = self.save_every_n_steps or 1
        last = self.restore_latest()
        start = 0 if self.restored_kind != "step" else last + 1
        try:
            for step in range(start, max_steps):
                heartbeat()
                yield step
                if (step + 1) % every == 0 or step == max_steps - 1:
                    if self.async_save:
                        self.save_step_async(step)
                    else:
                        self.save_step(step)
        finally:
            self.wait()


# module-level convenience mirroring the reference's implicit API ----------
_default_mgr: Optional[AutoCheckpointManager] = None


def register(save_dir: str = None, models=(), optimizers=(),
             lr_schedulers=(), **kw):
    """Bind training objects for the module-level train_epoch_range
    (the reference discovers state via the global Scope; eager mode needs
    explicit registration)."""
    global _default_mgr
    save_dir = save_dir or os.environ.get("PADDLE_CHECKPOINT_DIR",
                                          "./auto_checkpoint")
    _default_mgr = AutoCheckpointManager(save_dir, models, optimizers,
                                         lr_schedulers, **kw)
    return _default_mgr


def train_epoch_range(max_epoch_num: int, save_checkpoint_inter=None):
    if _default_mgr is None:
        raise RuntimeError(
            "call paddle.incubate.checkpoint.register(save_dir, models=..., "
            "optimizers=...) before train_epoch_range")
    return _default_mgr.train_epoch_range(max_epoch_num)


# ------------------------------------------------------------ sharded save
def save_sharded_state(state: dict, path: str, process_index: int = None):
    """Save a name -> tensor state dict as the JAX package does
    (paddle_tpu/incubate/checkpoint.py:418): each process writes the
    shards it holds to shard_<process>.npz, keyed `name||start:stop,...`,
    and process 0 writes manifest.json with the global shapes and dtypes.
    A torch tensor is one whole shard (every dim `0:`, the key a
    single-device jax array gets), so the files load in either package.
    The process index defaults to the torch.distributed rank, else 0."""
    if process_index is None:
        import torch.distributed as dist
        process_index = dist.get_rank() if dist.is_available() \
            and dist.is_initialized() else 0
    pi = process_index
    os.makedirs(path, exist_ok=True)
    manifest = {}
    shards = {}
    for name, arr in state.items():
        a = _to_host(arr)
        a = np.asarray(a)
        manifest[name] = {"shape": list(a.shape), "dtype": str(a.dtype)}
        shards[_flat_key(name, (slice(None),) * a.ndim)] = a
    np.savez(os.path.join(path, f"shard_{pi}.npz"), **shards)
    if pi == 0:
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)


def _flat_key(name, index):
    parts = [f"{sl.start or 0}:{'' if sl.stop is None else sl.stop}"
             for sl in index]
    return name + "||" + ",".join(parts)


def load_sharded_state(path: str) -> dict:
    """Reassemble the global arrays from all shard files (single-host
    restore; multi-host jobs restore per-process shards the same way)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {name: np.zeros(m["shape"], dtype=m["dtype"])
           for name, m in manifest.items()}
    for fn in os.listdir(path):
        if not fn.startswith("shard_") or not fn.endswith(".npz"):
            continue
        data = np.load(os.path.join(path, fn))
        for key in data.files:
            name, idx = key.split("||")
            target = out[name]
            if idx:
                slices = []
                for part in idx.split(","):
                    a, b = part.split(":")
                    slices.append(slice(int(a), None if b == "" else int(b)))
                target[tuple(slices)] = data[key]
            else:
                out[name] = data[key]
    return out
