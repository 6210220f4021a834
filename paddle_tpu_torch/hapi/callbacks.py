"""hapi callbacks (port of paddle_tpu/hapi/callbacks.py; reference:
python/paddle/hapi/callbacks.py Callback:116, CallbackList:35,
ProgBarLogger:294, ModelCheckpoint:478, LRScheduler:532,
EarlyStopping:594, config_callbacks:72, VisualDL:661).

Host Python, line for line the JAX module: the same event protocol, the
same progress lines, ModelCheckpoint's `<save_dir>/<epoch>` and `final`
saves through Model.save, LRScheduler stepping the optimizer's
scheduler per batch (or epoch), EarlyStopping on the eval logs, and
VisualDL writing its scalars as JSON lines (`<log_dir>/<mode>.jsonl`,
one {"tag", "step", "value"} record each; the VisualDL package is not
used).
"""
from __future__ import annotations

import numbers
import os
import time
from typing import List, Optional

import numpy as np


class Callback:
    """reference: callbacks.py Callback:116 — every hook is optional."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a: self._call(name, *a)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """reference: callbacks.py ProgBarLogger:294. verbose: 0 silent,
    1 epoch summaries, 2 per-log_freq lines."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def _fmt(self, logs):
        bits = []
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple, np.ndarray)):
                v = np.asarray(v).ravel()
                v = float(v[0]) if v.size else 0.0
            if isinstance(v, numbers.Number):
                bits.append(f"{k}: {v:.4f}")
            else:
                bits.append(f"{k}: {v}")
        return " - ".join(bits)

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._epoch_t0 = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and (step + 1) % self.log_freq == 0:
            total = self.steps if self.steps else "?"
            print(f"step {step + 1}/{total} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._epoch_t0
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - {self._fmt(logs)}")

    def on_eval_begin(self, logs=None):
        self._eval_t0 = time.time()
        if self.verbose:
            n = (logs or {}).get("steps")
            print(f"Eval begin ({n} steps)" if n else "Eval begin")

    def on_eval_end(self, logs=None):
        if self.verbose:
            dt = time.time() - self._eval_t0
            print(f"Eval done ({dt:.1f}s) - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """reference: callbacks.py ModelCheckpoint:478 — saves every
    `save_freq` epochs plus `final` at train end."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """reference: callbacks.py LRScheduler:532 — steps the optimizer's
    LRScheduler each batch (or epoch)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    """reference: callbacks.py EarlyStopping:594."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = None
        self.stopped_epoch = 0

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = logs[self.monitor]
        if isinstance(cur, (list, tuple, np.ndarray)):
            cur = float(np.asarray(cur).ravel()[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and getattr(self.model, "_save_dir",
                                                None):
                self.model.save(os.path.join(self.model._save_dir,
                                             "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: {self.monitor} did not improve "
                          f"beyond {self.best}")


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    """reference: callbacks.py config_callbacks:72."""
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                    "metrics": metrics or []})
    return lst


class VisualDL(Callback):
    """Scalar-logging callback (reference: callbacks.py VisualDL:661 —
    writes train/eval metrics with a LogWriter). The VisualDL package
    itself is not available here; the same stream is written as JSONL
    (one {"tag", "step", "value"} record per line), which any plotting
    tool ingests and tests can assert on."""

    def __init__(self, log_dir: str = "./log"):
        self.log_dir = log_dir
        self._files = {}
        self._steps = {"train": 0, "eval": 0}

    def _writer(self, mode: str):
        f = self._files.get(mode)
        if f is None:
            os.makedirs(self.log_dir, exist_ok=True)
            f = open(os.path.join(self.log_dir, f"{mode}.jsonl"), "a")
            self._files[mode] = f
        return f

    def _log(self, mode: str, logs: dict):
        import json
        f = self._writer(mode)
        step = self._steps[mode]
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple, np.ndarray)):
                v = np.asarray(v).reshape(-1)
                v = float(v[0]) if v.size else 0.0
            if isinstance(v, numbers.Number):
                f.write(json.dumps({"tag": f"{mode}/{k}", "step": step,
                                    "value": float(v)}) + "\n")
        f.flush()
        self._steps[mode] = step + 1

    def on_epoch_end(self, epoch, logs=None):
        self._log("train", logs)

    def on_eval_end(self, logs=None):
        self._log("eval", logs)

    def on_train_end(self, logs=None):
        for f in self._files.values():
            f.close()
        self._files = {}
