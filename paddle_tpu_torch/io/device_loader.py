"""DeviceLoader: batches copied to the card ahead of the step (port of
paddle_tpu/io/device_loader.py:48-74).

The JAX DeviceLoader overlaps the host-to-device copy with the step only
because `jax.device_put` returns before the DMA ends; it keeps `size`
dispatched batches in a deque. PyTorch gives that overlap only when it
is asked for, so the port asks explicitly:

- a helper thread pulls batches from the wrapped loader (a DataLoader's
  host batches, before its own placement) and copies each CPU tensor
  into pinned host memory (`pin_memory()`; a `non_blocking` copy
  from pageable memory would be synchronous), at most `size` batches
  ahead;
- the consumer issues `.to(device, non_blocking=True)` for each pinned
  tensor on a side CUDA stream and records an event after the batch;
  `size` batches are in flight, as in the JAX version;
- before a batch is handed over, the consumer's current stream waits on
  that batch's event, and `record_stream` marks every tensor of the
  batch as used on the current stream, so the caching allocator does not
  reuse its memory while a step that reads it is still running. The
  pinned source stays reserved by PyTorch's pinned-memory allocator
  until its copy has finished.

On the CPU (device="cpu") it is a plain pass-through: numpy arrays
become Tensors, the loader's batches pass unchanged, nothing is
buffered. `size < 1` raises, as in JAX. The device is CUDA unless the
caller passes device="cpu" (core/place.py); strings, None and scalars
pass through untouched.

Usage::

    loader = paddle.io.DataLoader(ds, batch_size=128, num_workers=4)
    for x, y in paddle.io.DeviceLoader(loader, size=2):
        loss = train_step(x, y)        # x, y on the card; their copies
                                       # overlapped the previous step
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Optional

import numpy as np
import torch

from ..core.place import resolve_device
from ..core.tensor import box, plain

__all__ = ["DeviceLoader"]

_END = object()


def _map(item, fn):
    """Apply fn to every tensor leaf of one batch element (numpy arrays
    become tensors first), keeping the container structure."""
    if isinstance(item, (np.ndarray, np.generic)):
        item = torch.from_numpy(np.asarray(item))
    if isinstance(item, torch.Tensor):
        return fn(plain(item))
    if isinstance(item, dict):
        return {k: _map(v, fn) for k, v in item.items()}
    if isinstance(item, tuple) and hasattr(item, "_fields"):  # namedtuple
        return type(item)(*(_map(v, fn) for v in item))
    if isinstance(item, (list, tuple)):
        return type(item)(_map(v, fn) for v in item)
    return item


class DeviceLoader:
    """Wraps a batch iterable; yields batches whose tensors were sent to
    the device `size` iterations ahead of consumption (module docstring).
    size=2 is double buffering: batch N+1 copies while N computes."""

    def __init__(self, loader: Iterable, size: int = 2,
                 device: Optional[object] = None):
        if size < 1:
            raise ValueError(f"DeviceLoader size must be >= 1, got {size}")
        self.loader = loader
        self.size = size
        self.device = resolve_device(device)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        if self.device.type != "cuda":
            for batch in self.loader:
                yield _map(batch, box)
            return
        yield from self._iter_cuda()

    def _produce(self, pinned: "queue.Queue", stop: threading.Event):
        """Helper thread: pin each batch, at most `size` ahead."""
        def put(item):
            while not stop.is_set():
                try:
                    pinned.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def pin(t):
            return t.pin_memory() if t.device.type == "cpu" else t

        from .dataloader import DataLoader
        source = self.loader._host_iter() \
            if isinstance(self.loader, DataLoader) else self.loader
        try:
            for batch in source:
                if not put((_map(batch, pin), None)):
                    return
            put((_END, None))
        except BaseException as e:        # surfaced in the consumer
            put((None, e))

    def _iter_cuda(self):
        dev = self.device
        copy_stream = torch.cuda.Stream(dev)
        pinned: "queue.Queue" = queue.Queue(maxsize=self.size)
        stop = threading.Event()
        producer = threading.Thread(target=self._produce,
                                    args=(pinned, stop), daemon=True)
        producer.start()
        inflight: collections.deque = collections.deque()
        exhausted = False
        try:
            while True:
                while not exhausted and len(inflight) < self.size:
                    batch, err = pinned.get()
                    if err is not None:
                        raise err
                    if batch is _END:
                        exhausted = True
                        break
                    moved = []

                    def copy(t):
                        d = t.to(dev, non_blocking=True)
                        moved.append(d)
                        return box(d)

                    with torch.cuda.stream(copy_stream):
                        out = _map(batch, copy)
                    done = torch.cuda.Event()
                    done.record(copy_stream)
                    inflight.append((out, moved, done))
                if not inflight:
                    return
                out, moved, done = inflight.popleft()
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(done)
                for t in moved:
                    t.record_stream(cur)
                yield out
        finally:
            stop.set()
            producer.join()
