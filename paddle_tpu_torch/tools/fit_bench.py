"""Model.fit at the bench geometries: the pieces chip_smoke.py's phases
28-29 drive, on the port's training runtime (io, vision data, hapi,
incubate.checkpoint).

- `gpt_model`: `paddle.Model` over bench_gpt's GPT (train_bench.
  bench_config: vocab 32768, hidden 768, 12 layers, 6 heads of 128),
  AdamW(1e-4) with global-norm clipping, decorated O2 as bench_gpt is,
  its loss the next-token cross-entropy of train_bench's step;
  `TokenRows` is its seeded data: rows of seq + 1 tokens drawn from the
  first TOKEN_SUBSET ids (a unigram a few steps of AdamW can learn, so
  the loss falls from ln(vocab) towards ln(TOKEN_SUBSET)).
- `resnet_model`: `paddle.Model(resnet50())` at bench_resnet's width, O2,
  Momentum(FIT_LR) on a StepDecay schedule the LRScheduler callback steps,
  Accuracy(topk=(1, 5)); its input is cast to bfloat16 by `CastInput`,
  since the image pipeline yields float32 (an O2 model in the port takes
  its parameters' dtype, where the JAX package's promoted). Its data is
  an image folder `write_image_folder` fills with seeded 256 x 256 x 3
  uint8 .npy images, read through `image_transform()`'s pipeline.
- `run_resnet_fit` is phase 29's run: that model fit 2 epochs over the
  folder through DataLoader(shuffle, num_workers=8) and
  DeviceLoader(size=2) with LossLog, ModelCheckpoint, the LRScheduler
  callback and `EpochProfiler` (torch.profiler over epoch 2: device busy
  time and idle share), then evaluate and predict.
- Callbacks and wrappers the phases read: `EpochSeeder` (numpy's global
  stream reseeded at each epoch, so a shuffled epoch draws the same
  order in every run), `LossLog`, `TimedLoader` (host seconds the fit
  loop waits on each batch) and `TimedCheckpoint` (ModelCheckpoint's
  save seconds and bytes).

Sizes are module constants; a CPU rehearsal shrinks them (and
`gpt_config`) before calling. On the card:

    python -m paddle_tpu_torch.tools.fit_bench --probe
        # the image pipeline's imgs/s on 1 and 8 threads, each at one
        # torch thread and at torch's default, by stage
    python -m paddle_tpu_torch.tools.fit_bench --ab-worker-threads
        # run_resnet_fit with the DataLoader's workers at one torch
        # thread and at the default, in turns (1, default, default, 1)
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from ..hapi.callbacks import Callback, ModelCheckpoint
from ..io import Dataset
from ..nn.layer.layers import Layer

__all__ = ["TOKEN_SUBSET", "GPT_STEPS_PER_EPOCH", "IMAGE_SIDE",
           "RESNET_CLASSES", "gpt_config", "gpt_loss", "gpt_model",
           "TokenRows", "image_transform", "write_image_folder",
           "CastInput", "resnet_model", "EpochSeeder", "LossLog",
           "TimedLoader", "TimedCheckpoint", "EpochProfiler",
           "run_resnet_fit", "probe_pipeline", "main"]

TOKEN_SUBSET = 512
GPT_STEPS_PER_EPOCH = 4
IMAGE_SIDE = 256
RESNET_CLASSES = 10
# phase 29's image folder: 8 steps of bench_resnet's batch an epoch, and
# an eval pass
RESNET_IMAGES = {"train": 1024, "eval": 256}
LOADER_WORKERS = 8
# phase 29's Momentum learning rate (StepDecay's start). At 0.1, the
# fixed-batch bench's rate, with no warm-up, the fit's augmented
# batches swing its loss several times above its first, and a run can
# end there (PERF.md, phase 29); at 0.01 it falls step by step.
FIT_LR = 0.01


def gpt_config():
    """bench_gpt's GPT (tools/train_bench.py bench_config, 6 heads)."""
    from .train_bench import bench_config
    return bench_config(6)


def gpt_loss(logits, labels):
    """Mean next-token cross-entropy (models/gpt.py GPT.loss) of the
    logits [B, T, V] against labels [B, T]."""
    from ..nn import functional as F
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def gpt_model(seed: int, device, anomaly=None):
    """(Model, network, optimizer): bench_gpt's GPT from `seed` on
    `device`, AdamW(1e-4) with ClipGradByGlobalNorm(1.0), amp.decorate
    O2 bfloat16, prepared with gpt_loss."""
    from .. import amp
    from ..hapi import Model
    from ..models.gpt import GPT
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    net = GPT(gpt_config(), device=device, seed=seed)
    opt = AdamW(1e-4, parameters=net.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    net, opt = amp.decorate(net, opt, level="O2", dtype="bfloat16")
    model = Model(net)
    model.prepare(opt, gpt_loss, anomaly=anomaly)
    return model, net, opt


class TokenRows(Dataset):
    """n rows of (input ids [seq], next-token labels [seq]) int64, row i
    drawn from RandomState(seed * 1000003 + i) over TOKEN_SUBSET ids."""

    def __init__(self, n: int, seq: int, seed: int):
        self.n, self.seq, self.seed = n, seq, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 1000003 + i)
        row = rng.randint(0, TOKEN_SUBSET, self.seq + 1).astype(np.int64)
        return row[:-1], row[1:]


def image_transform(side: int = 224):
    """RandomResizedCrop(side), RandomHorizontalFlip, HWC -> CHW and
    ImageNet's mean / std on 0..255 pixels."""
    from ..vision import transforms as T
    return T.Compose([T.RandomResizedCrop(side), T.RandomHorizontalFlip(),
                      T.Transpose(),
                      T.Normalize([123.675, 116.28, 103.53],
                                  [58.395, 57.12, 57.375])])


def write_image_folder(root: str, n: int, seed: int,
                       classes: int = RESNET_CLASSES,
                       side: int = IMAGE_SIDE) -> int:
    """n seeded uint8 [side, side, 3] images as .npy files in `classes`
    class directories under root (DatasetFolder's layout), image i in
    class i % classes: uniform noise of amplitude 64 around a colour the
    class draws once (a task a few steps can start to learn); returns
    the bytes written."""
    rng = np.random.RandomState(seed)
    colours = rng.randint(32, 224, (classes, 3))
    total = 0
    for c in range(classes):
        os.makedirs(os.path.join(root, f"class_{c:03d}"), exist_ok=True)
    for i in range(n):
        noise = rng.randint(-32, 32, (side, side, 3))
        img = (colours[i % classes] + noise).astype(np.uint8)
        path = os.path.join(root, f"class_{i % classes:03d}",
                            f"{i:05d}.npy")
        np.save(path, img)
        total += os.path.getsize(path)
    return total


class CastInput(Layer):
    """net(x.to(dtype)): feeds a float32 image batch to an O2 model."""

    def __init__(self, net, dtype):
        super().__init__()
        self.net = net
        self.dtype = dtype

    def forward(self, x):
        return self.net(x.to(self.dtype))


def resnet_model(seed: int, device, lr_step: int = 1000):
    """(Model, network, optimizer): bench_resnet's ResNet-50 from `seed`
    (1000 classes), Momentum over StepDecay(FIT_LR, lr_step, 0.1),
    amp.decorate O2 bfloat16, behind CastInput; prepared with
    CrossEntropyLoss and Accuracy(topk=(1, 5))."""
    import torch
    from .. import amp
    from ..hapi import Model
    from ..metric import Accuracy
    from ..nn import CrossEntropyLoss
    from ..optimizer import Momentum
    from ..optimizer.lr import StepDecay
    from ..vision.models import resnet50
    net = resnet50(num_classes=1000, device=device, seed=seed)
    opt = Momentum(StepDecay(FIT_LR, step_size=lr_step, gamma=0.1),
                   parameters=net.parameters())
    net, opt = amp.decorate(net, opt, level="O2", dtype="bfloat16")
    wrapped = CastInput(net, torch.bfloat16)
    model = Model(wrapped)
    model.prepare(opt, CrossEntropyLoss(), Accuracy(topk=(1, 5)))
    return model, net, opt


class EpochSeeder(Callback):
    """np.random.seed(base + offset + epoch) at each epoch's start: the
    samplers shuffle from numpy's global stream, so every run of an
    epoch draws the same order."""

    def __init__(self, base: int, offset: int = 0):
        super().__init__()
        self.base, self.offset = base, offset

    def on_epoch_begin(self, epoch, logs=None):
        np.random.seed(self.base + self.offset + epoch)


class LossLog(Callback):
    """Each train batch's logged loss and host time at its end, and each
    epoch's host start time."""

    def __init__(self):
        super().__init__()
        self.losses, self.times, self.epoch_starts = [], [], []

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch_starts.append(time.perf_counter())

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))
        self.times.append(time.perf_counter())


class TimedLoader:
    """Iterates `loader`, recording the host seconds each next() waited
    (the fit loop's wait on the input pipeline)."""

    def __init__(self, loader):
        self.loader = loader
        self.waits = []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch


class TimedCheckpoint(ModelCheckpoint):
    """ModelCheckpoint recording each save's seconds and the bytes of the
    files it wrote (<path>.pdparams and .pdopt)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__(save_freq, save_dir)
        self.saves = []

    def _timed(self, name):
        import torch
        path = os.path.join(self.save_dir, name)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.model.save(path)
        dt = time.perf_counter() - t0
        size = sum(os.path.getsize(path + ext) for ext in
                   (".pdparams", ".pdopt") if os.path.exists(path + ext))
        self.saves.append((dt, size))

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self._timed(str(epoch))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self._timed("final")


class EpochProfiler(Callback):
    """torch.profiler over one fit epoch: its host wall time, the
    device's busy time (the CUDA kernels' own time) and idle share."""

    def __init__(self, epoch: int):
        super().__init__()
        self.epoch, self.prof, self.result = epoch, None, None

    def on_epoch_begin(self, epoch, logs=None):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if epoch != self.epoch:
            return
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def on_epoch_end(self, epoch, logs=None):
        import torch
        from torch.autograd import DeviceType
        if epoch != self.epoch:
            return
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        busy = sum(e.self_device_time_total
                   for e in self.prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e6
        self.result = {"wall_s": wall, "busy_s": busy,
                       "idle_share": 1 - busy / wall}


def run_resnet_fit(device, seed: int, tmp: str, wrap_step=None,
                   epoch_seed: int = 1000) -> dict:
    """Phase 29's run (module docstring) in a folder made under `tmp`
    and removed after. `wrap_step` wraps Model.train_batch for the fit
    (chip_smoke counts its host reads); its `calls` come back as
    "step_calls". Returns the losses, the epoch-1 rates (from the
    epoch's start, and from its first step's end), the loader's waits,
    the profiled epoch, the checkpoints' (seconds, bytes), the
    scheduler's steps, evaluate's dict and predict's output."""
    import numpy as np
    from .. import io
    from ..vision.datasets import DatasetFolder
    from .train_bench import RESNET_BATCH, RESNET_SIDE
    B = RESNET_BATCH
    root = tempfile.mkdtemp(dir=tmp, prefix="images_")
    try:
        t0 = time.perf_counter()
        written = sum(write_image_folder(os.path.join(root, k), n,
                                         seed + i)
                      for i, (k, n) in enumerate(RESNET_IMAGES.items()))
        write_s = time.perf_counter() - t0
        train = DatasetFolder(os.path.join(root, "train"),
                              transform=image_transform(RESNET_SIDE))
        evald = DatasetFolder(os.path.join(root, "eval"),
                              transform=image_transform(RESNET_SIDE))
        model, net, opt = resnet_model(seed, device)
        loader = TimedLoader(io.DeviceLoader(io.DataLoader(
            train, batch_size=B, shuffle=True,
            num_workers=LOADER_WORKERS, drop_last=True), size=2,
            device=device))
        log = LossLog()
        ckpt = TimedCheckpoint(1, os.path.join(root, "ckpt"))
        prof = EpochProfiler(1)
        step_fn = model.train_batch
        if wrap_step is not None:
            model.train_batch = wrap_step(step_fn)
        t0 = time.perf_counter()
        model.fit(loader, epochs=2, verbose=0,
                  callbacks=[EpochSeeder(epoch_seed), log, prof, ckpt])
        fit_s = time.perf_counter() - t0
        calls = getattr(model.train_batch, "calls", [])
        model.train_batch = step_fn
        steps = len(loader)
        t = log.times[:steps]
        ev = model.evaluate(io.DeviceLoader(io.DataLoader(
            evald, batch_size=B, num_workers=LOADER_WORKERS),
            device=device), verbose=0)
        pred = model.predict(io.DeviceLoader(io.DataLoader(
            io.Subset(evald, range(B)), batch_size=B,
            num_workers=LOADER_WORKERS), device=device), verbose=0)
        return {"images": sum(RESNET_IMAGES.values()),
                "image_bytes": written, "write_s": write_s,
                "losses": log.losses, "steps": steps, "fit_s": fit_s,
                "imgs_per_sec": B * steps / (t[-1] - log.epoch_starts[0]),
                "steady_imgs_per_sec": B * (steps - 1) / (t[-1] - t[0]),
                "waits": loader.waits,
                "loader_wait_s": float(np.mean(loader.waits)),
                "profile": prof.result, "step_calls": calls,
                "saves": ckpt.saves, "lr_steps": opt._lr_scheduler.last_epoch,
                "evaluate": ev, "predict_shape": pred[0][0].shape,
                "predict_finite": bool(np.isfinite(pred[0][0]).all())}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def probe_pipeline(n_images: int = 64) -> list:
    """The image pipeline's throughput on this host: imgs/s of np.load
    alone, the whole pipeline, its resize and its normalize, on 1 thread
    and on LOADER_WORKERS threads, each thread at one torch thread or at
    torch's default. Returns [(stage, threads, one_torch_thread,
    imgs/s)]."""
    import numpy as np
    import torch
    from ..vision import transforms as T
    root = tempfile.mkdtemp(prefix="probe_")
    try:
        write_image_folder(root, n_images, 0)
        paths = [os.path.join(d, f) for d, _, fs in os.walk(root)
                 for f in fs]
        tr = image_transform(224)
        norm = T.Normalize([123.675, 116.28, 103.53],
                           [58.395, 57.12, 57.375])
        stages = {
            "load": np.load,
            "pipeline": lambda p: tr(np.load(p)),
            "resize": lambda p: T.functional.resize(
                np.load(p)[:200, :180], (224, 224)),
            "normalize": lambda p: norm(
                np.load(p).transpose(2, 0, 1).astype(np.float32))}
        out = []
        for name, fn in stages.items():
            for n, one in ((1, True), (LOADER_WORKERS, True),
                           (LOADER_WORKERS, False)):
                def work():
                    if one:
                        torch.set_num_threads(1)
                    for p in paths:
                        fn(p)
                threads = [threading.Thread(target=work) for _ in range(n)]
                t0 = time.perf_counter()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                out.append((name, n, one, n * len(paths)
                            / (time.perf_counter() - t0)))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--ab-worker-threads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    from ..core.place import resolve_device
    from ..io import dataloader
    from .measure import card_line
    print(json.dumps({"card": card_line()}))
    if args.probe:
        for stage, n, one, rate in probe_pipeline():
            print(json.dumps({"stage": stage, "threads": n,
                              "one_torch_thread": one,
                              "imgs_per_sec": round(rate, 1)}))
    if args.ab_worker_threads:
        torch.backends.cudnn.allow_tf32 = False
        device = resolve_device(None)
        tmp = tempfile.mkdtemp(prefix="fit_bench_")
        try:
            for setting in (1, None, None, 1):
                dataloader.WORKER_TORCH_THREADS = setting
                r = run_resnet_fit(device, args.seed, tmp)
                print(json.dumps({
                    "worker_torch_threads": setting,
                    "imgs_per_sec": round(r["imgs_per_sec"], 1),
                    "steady_imgs_per_sec": round(
                        r["steady_imgs_per_sec"], 1),
                    "loader_wait_s": round(r["loader_wait_s"], 4),
                    "idle_share": round(r["profile"]["idle_share"], 4)}))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
