"""DataLoader (port of paddle_tpu/io/dataloader.py:30-179).

As in the JAX package: batches are collated on the host, either in the
calling thread (num_workers=0) or by PERSISTENT worker threads
(`_iter_threaded`, paddle_tpu/io/dataloader.py:116) that each run
`worker_init_fn` once, keep a stable `get_worker_info().id`, pull
batch tasks from a shared queue, and hand results back in sampler
order; an IterableDataset is batched in the caller's thread.
`default_collate_fn` builds CPU torch tensors (the port's `Tensor`) in
the workers; the consumer's thread then moves each batch to `places`
(default: the default device, CUDA unless set_device("cpu"), resolved
when iteration starts), as JAX's collate lands its arrays on JAX's
default device and Paddle's DataLoader on its places. That copy is
synchronous (pageable memory). DeviceLoader (io/device_loader.py) takes
a DataLoader's CPU batches instead (`_host_iter`), pins them and
overlaps the copy with the step: wrap a loader in it on the training
path.

Threads: each worker sets its own torch intra-op thread count to
WORKER_TORCH_THREADS, 1 (`torch.set_num_threads` is a per-thread OpenMP
setting; the caller's count stays as it was), so N workers occupy about
N cores rather than N times torch's intra-op pool. The transforms' work
per sample is small numpy / torch on one image. None leaves each worker
at torch's default.

`feed_list`, `return_list`, `use_buffer_reader`, `use_shared_memory`,
`timeout` and `persistent_workers` are accepted and ignored, as the JAX
DataLoader ignores them (its workers are always persistent threads and
share memory by construction); `places` names the batches' device (the
first, given a list).
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Optional

import numpy as np
import torch

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler
from ..core.tensor import box, plain

_worker_info = threading.local()
# torch intra-op threads of each worker thread (module docstring)
WORKER_TORCH_THREADS = 1


def get_worker_info():
    """The calling worker thread's WorkerInfo (id, num_workers,
    dataset), or None outside a worker."""
    return getattr(_worker_info, "info", None)


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def default_collate_fn(batch):
    """paddle_tpu/io/dataloader.py:41-60 (reference:
    fluid/dataloader/collate.py default_collate_fn): stacks samples into
    CPU Tensors; strings stay lists; mappings and sequences collate per
    field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return box(torch.stack([plain(s).detach() for s in batch]))
    if isinstance(sample, np.ndarray):
        return box(torch.from_numpy(np.stack(batch)))
    if isinstance(sample, (int, float, np.generic)):
        return box(torch.from_numpy(np.asarray(batch)))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, collections.abc.Mapping):
        return {k: default_collate_fn([b[k] for b in batch])
                for k in sample}
    if isinstance(sample, collections.abc.Sequence):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(s)) for s in transposed]
    raise TypeError(f"batch data can't be type {type(sample)}")


class DataLoader:
    """paddle_tpu/io/dataloader.py:63 (module docstring)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.places = places
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        batch = [self.dataset[i] for i in indices]
        return self.collate_fn(batch)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def __iter__(self):
        from ..core.place import resolve_device
        from .device_loader import _map
        places = self.places
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        device = resolve_device(places)
        for batch in self._host_iter():
            yield _map(batch, lambda t: box(t.to(device)))

    def _host_iter(self):
        """The collated batches as they leave the collate function (CPU
        tensors for default_collate_fn)."""
        if self._iterable_mode:
            yield from self._iter_iterable()
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        yield from self._iter_threaded()

    def _iter_threaded(self):
        """In-order prefetch with PERSISTENT worker threads (the analogue of
        the reference's per-epoch worker processes): each worker runs
        worker_init_fn once, keeps a stable get_worker_info().id, pulls
        batch tasks from a shared queue, and results are yielded in order."""
        index_iter = iter(self.batch_sampler)
        tasks: "queue.Queue" = queue.Queue()
        done: "queue.Queue" = queue.Queue()
        depth = self.num_workers * self.prefetch_factor

        def worker(wid):
            if WORKER_TORCH_THREADS is not None:
                torch.set_num_threads(WORKER_TORCH_THREADS)
            _worker_info.info = WorkerInfo(wid, self.num_workers,
                                           self.dataset)
            if self.worker_init_fn:
                self.worker_init_fn(wid)
            while True:
                task = tasks.get()
                if task is None:
                    return
                seq, indices = task
                try:
                    done.put((seq, self._fetch(indices), None))
                except BaseException as e:  # propagate to consumer
                    done.put((seq, None, e))

        workers = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in workers:
            t.start()

        submitted = 0

        def submit_one():
            nonlocal submitted
            try:
                indices = next(index_iter)
            except StopIteration:
                return False
            tasks.put((submitted, indices))
            submitted += 1
            return True

        try:
            for _ in range(depth):
                if not submit_one():
                    break
            buffered = {}
            next_seq = 0
            while next_seq < submitted:
                while next_seq not in buffered:
                    seq, value, err = done.get()
                    buffered[seq] = (value, err)
                value, err = buffered.pop(next_seq)
                next_seq += 1
                submit_one()
                if err is not None:
                    raise err
                yield value
        finally:
            for _ in workers:
                tasks.put(None)

    def __call__(self):
        return self.__iter__()
