"""hapi Model: the high-level train / eval / predict API (port of
paddle_tpu/hapi/model.py; reference: python/paddle/hapi/model.py
Model:810 — prepare:1244, fit:1299, evaluate:1489, predict:1570,
train_batch:903, save:1028, load:1083).

`train_batch` runs the port's `jit.TrainStep` with `return_outputs=True`
and the prepared anomaly guard, as the JAX Model runs its compiled step
(paddle_tpu/hapi/model.py:111-134): one forward, backward, clip and
update, the loss read to the host (`float(loss.numpy())`) and the
metrics fed from the step's outputs. `eval_batch` and `predict_batch`
run the network's forward in eval mode under `torch.no_grad()`. The
model runs on its parameters' device; batches are moved there (a
DeviceLoader's batches already are). `amp_configs` is accepted and
ignored, as in the JAX Model: decorate the network and optimizer with
`paddle.amp.decorate` before wrapping them for O2.

Host reads per training batch, as in JAX: the loss (one), and for each
metric its `compute` inputs (Accuracy: the predictions and labels) and
the compute result.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..core.tensor import box, plain
from ..io.dataloader import DataLoader
from ..metric.metrics import Metric
from ..nn.layer.layers import Layer
from .callbacks import config_callbacks

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _as_tensors(batch, device=None):
    """Batch elements as plain torch tensors (on `device` when given)."""
    out = []
    for b in _to_list(batch):
        t = plain(b) if torch.is_tensor(b) else torch.from_numpy(
            np.asarray(b))
        out.append(t if device is None else t.to(device))
    return out


class Model:
    """paddle_tpu/hapi/model.py:45 (reference: hapi/model.py Model:810)."""

    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self.stop_training = False
        self._save_dir = None
        self._anomaly_guard = None

    def _device(self) -> torch.device:
        p = next(iter(self.network.parameters()), None)
        return p.device if p is not None else torch.device("cpu")

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, anomaly=None):
        """paddle_tpu/hapi/model.py:62. anomaly: None, a policy string
        ('raise' | 'skip_step' | 'zero_grads') or a
        core.anomaly.AnomalyGuard guarding every train_batch; skipped
        steps show in the fit logs as 'anomaly_skipped'."""
        from ..core.anomaly import AnomalyGuard
        self._optimizer = optimizer
        if loss is not None and not isinstance(loss, Layer) \
                and not callable(loss):
            raise TypeError("loss must be a Layer or a callable")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be paddle.metric.Metric, "
                                f"got {type(m)}")
        if isinstance(anomaly, str):
            anomaly = AnomalyGuard(anomaly)
        self._anomaly_guard = anomaly
        self._train_step = None
        return self

    def _split_batch(self, batch):
        """A batch is [inputs..., labels...]: len(inputs) when declared,
        else all but the last as inputs when there is a loss."""
        batch = _to_list(batch)
        if self._inputs:
            n = len(self._inputs)
        elif self._loss is not None:
            n = max(1, len(batch) - max(1, len(self._labels) or 1))
        else:
            n = len(batch)
        return batch[:n], batch[n:]

    def _loss_value(self, outputs, labels):
        outs = _to_list(outputs)
        return self._loss(*(outs + labels)) if self._loss else outs[0]

    # ------------------------------------------------------ batch-level API
    def train_batch(self, inputs, labels=None):
        """paddle_tpu/hapi/model.py:111-134: one TrainStep."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before "
                               "training (reference model.py:1244)")
        from ..jit import TrainStep
        self.network.train()
        if self._train_step is None:
            def loss_fn(model, *args):
                n_in = len(_to_list(inputs))
                outs = model(*args[:n_in])
                loss = self._loss_value(outs, list(args[n_in:]))
                return (loss,) + tuple(_to_list(outs))

            self._train_step = TrainStep(self.network, loss_fn,
                                         self._optimizer,
                                         return_outputs=True,
                                         anomaly_guard=self._anomaly_guard)
        args = _as_tensors(_to_list(inputs) + _to_list(labels))
        loss, out = self._train_step(*args)
        outputs = list(out)[1:]
        metrics = self._update_metrics(outputs, _to_list(labels))
        return ([float(loss.numpy())], metrics) if self._metrics \
            else [float(loss.numpy())]

    def _forward(self, inputs):
        self.network.eval()
        with torch.no_grad():
            out = self.network(*_as_tensors(inputs, self._device()))
        return [box(plain(o)) for o in _to_list(out)]

    def eval_batch(self, inputs, labels=None):
        """paddle_tpu/hapi/model.py:160."""
        outputs = self._forward(inputs)
        labels = [box(t) for t in _as_tensors(labels, self._device())]
        losses = []
        if self._loss is not None and labels:
            with torch.no_grad():
                lv = self._loss_value(outputs, labels)
            losses = [float(lv.numpy())]
        metrics = self._update_metrics(outputs, labels)
        if self._metrics:
            return (losses, metrics) if losses else metrics
        return losses

    def predict_batch(self, inputs):
        """paddle_tpu/hapi/model.py:179: the outputs as numpy."""
        return [o.numpy() for o in self._forward(inputs)]

    def _update_metrics(self, outputs, labels):
        results = []
        labels = [box(t) for t in _as_tensors(labels)]
        for m in self._metrics:
            inp = m.compute(*(_to_list(outputs) + labels))
            r = m.update(*[i.numpy() if torch.is_tensor(i) else
                           np.asarray(i) for i in _to_list(inp)])
            results.append(r)
        return results[0] if len(results) == 1 else results

    # ------------------------------------------------------------ loop API
    def _make_loader(self, data, batch_size, shuffle, num_workers,
                     drop_last=False):
        if data is None or isinstance(data, DataLoader):
            return data
        if not hasattr(data, "__getitem__"):
            return data                   # any batch iterable (DeviceLoader)
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None):
        """paddle_tpu/hapi/model.py:214."""
        train_loader = self._make_loader(train_data, batch_size, shuffle,
                                         num_workers, drop_last)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        self._save_dir = save_dir
        steps = len(train_loader) if hasattr(train_loader, "__len__") \
            else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                verbose=verbose, save_freq=save_freq,
                                save_dir=save_dir,
                                metrics=self._metrics_name())
        self.stop_training = False
        cbks.on_train_begin()
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            logs = self._run_one_epoch(train_loader, cbks, "train")
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self._run_eval(eval_loader, cbks)
                logs.update({"eval_" + k if not k.startswith("eval_")
                             else k: v for k, v in eval_logs.items()})
        cbks.on_train_end(logs if epochs else {})
        return self

    def _metrics_name(self):
        return ["loss"] + [m.name() for m in self._metrics]

    def _metric_logs(self, logs):
        for m in self._metrics:
            r = m.accumulate()
            name = m.name()
            if isinstance(name, (list, tuple)):
                logs.update(dict(zip(name, _to_list(r))))
            else:
                logs[name] = r
        return logs

    def _run_one_epoch(self, loader, cbks, mode):
        logs = {}
        for m in self._metrics:
            m.reset()
        for step, batch in enumerate(loader):
            inputs, labels = self._split_batch(batch)
            cbks.on_train_batch_begin(step)
            res = self.train_batch(inputs, labels)
            losses = res[0] if self._metrics else res
            logs = {"loss": losses}
            if self._anomaly_guard is not None:
                logs["anomaly_skipped"] = (self._anomaly_guard.skipped_steps
                                           + self._anomaly_guard.zeroed_steps)
            cbks.on_train_batch_end(step, self._metric_logs(logs))
            if self.stop_training:
                break
        return logs

    def _run_eval(self, loader, cbks):
        cbks.on_eval_begin({"steps": len(loader)
                            if hasattr(loader, "__len__") else None})
        for m in self._metrics:
            m.reset()
        logs = {}
        losses = []
        for step, batch in enumerate(loader):
            inputs, labels = self._split_batch(batch)
            cbks.on_eval_batch_begin(step)
            res = self.eval_batch(inputs, labels)
            if self._loss is not None and self._metrics:
                bl, _ = res
                losses.extend(_to_list(bl))
            elif self._loss is not None:
                losses.extend(_to_list(res))
            logs = {}
            if losses:
                logs["loss"] = [float(np.mean(losses))]
            cbks.on_eval_batch_end(step, self._metric_logs(logs))
        cbks.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        """paddle_tpu/hapi/model.py:306: the metric dict."""
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, log_freq=log_freq,
                                verbose=verbose,
                                metrics=self._metrics_name())
        return self._run_eval(loader, cbks)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """paddle_tpu/hapi/model.py:315: a list per output of the
        batches' numpy outputs (concatenated when stack_outputs)."""
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose,
                                metrics=[])
        cbks.on_predict_begin()
        outputs = []
        for step, batch in enumerate(loader):
            inputs, _ = self._split_batch(batch)
            cbks.on_predict_batch_begin(step)
            outputs.append(self.predict_batch(inputs))
            cbks.on_predict_batch_end(step, {})
        cbks.on_predict_end()
        n_out = len(outputs[0]) if outputs else 0
        result = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            result = [np.concatenate(r, axis=0) for r in result]
        return result

    # ------------------------------------------------------------ state i/o
    def save(self, path, training=True):
        """paddle_tpu/hapi/model.py:338: <path>.pdparams (+ .pdopt), in
        the JAX package's format."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        from ..framework_io import save as _save
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """paddle_tpu/hapi/model.py:349."""
        from ..framework_io import load as _load
        state = _load(path + ".pdparams", return_numpy=True)
        if skip_mismatch:
            own = self.network.state_dict()
            state = {k: v for k, v in state.items()
                     if k in own and tuple(np.shape(v))
                     == tuple(own[k].shape)}
        self.network.set_state_dict(state)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path,
                                                 return_numpy=True))
        self._train_step = None
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        """paddle_tpu/hapi/model.py:362 -> hapi/model_summary.py."""
        from .model_summary import summary as _summary
        if input_size is None and self._inputs:
            input_size = [tuple(s.shape) for s in self._inputs]
        return _summary(self.network, input_size, dtypes=dtype)
