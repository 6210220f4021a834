"""Device-resident embedding cache over the host parameter server (port of
paddle_tpu/distributed/ps/device_cache.py; reference:
paddle/fluid/framework/fleet/ps_gpu_wrapper.cc, PSGPU: hot embedding rows
in device memory, loaded from the PS at BuildGPUTask and dumped back at
EndPass).

The hot vocabulary [0, cache_rows) lives as a tensor on the card (f32
rows and, for adagrad, the f32 per-row accumulator), loaded from the PS
with both. `pull` gathers hot rows on the card; `push` applies the
optimizer rule there as indexed updates over the unique ids (sgd: the
rows -= lr g; adagrad: the accumulator's rows += g * g, then the rows
-= (lr g) / (sqrt(acc) + eps)), each a gather, the arithmetic and a
scatter (`index_copy_`): the arithmetic of distributed/ps/table.py's
host rules, operation for operation, so a step through the cache
equals the host PS's bitwise. Ids outside [0,
cache_rows), negative ones included (they would wrap around in a
tensor index), form the cold tail and ride `PsClient`'s pull_sparse /
push_sparse. `flush()` writes the hot rows and their accumulator back
to the PS (direct assignment, the EndPass analogue).

`device_pulls` counts pulls served by the card, `host_pulls` those that
needed an RPC. The JAX package can lay the hot table out row-sharded
over a mesh axis (`mesh`, `axis`); here a rank's cache lives on its
card, and those parameters take only their defaults.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.place import DeviceLike, resolve_device
from ...core.unported import require_defaults

__all__ = ["DeviceEmbeddingCache"]


class DeviceEmbeddingCache:
    """Hot-vocabulary embedding rows on the card, cold tail on the host PS
    (see the module docstring).

    client     : distributed.ps.PsClient serving the sparse table
    table_id   : sparse table id on the PS
    cache_rows : ids [0, cache_rows) live on the card
    dim        : embedding dim
    optimizer  : 'sgd' | 'adagrad', the PS table's rule
    device     : the card (the default) or "cpu"
    """

    def __init__(self, client, table_id: int, cache_rows: int, dim: int,
                 optimizer: str = "adagrad", lr: float = 0.1,
                 mesh=None, axis: Optional[str] = None,
                 device: DeviceLike = None):
        require_defaults("DeviceEmbeddingCache", mesh=(mesh, None),
                         axis=(axis, None))
        self._client = client
        self._table_id = table_id
        self.cache_rows = int(cache_rows)
        self.dim = int(dim)
        self._lr = float(lr)
        if optimizer in ("sgd", "SGD"):
            self._adagrad = False
        elif optimizer in ("adagrad", "Adagrad"):
            self._adagrad = True
        else:
            raise ValueError(
                f"DeviceEmbeddingCache supports sgd/adagrad, got "
                f"{optimizer!r} (match the PS table rule)")
        self.device = resolve_device(device)
        ids = np.arange(self.cache_rows, dtype=np.int64)
        self.table = torch.from_numpy(np.asarray(
            client.pull_sparse(table_id, ids), np.float32)).to(self.device)
        self._state = torch.from_numpy(np.asarray(
            client.pull_sparse_state(table_id, ids), np.float32)).to(
                self.device)
        self.device_pulls = 0
        self.host_pulls = 0

    def _hot_mask(self, uniq_ids: np.ndarray) -> np.ndarray:
        return (uniq_ids >= 0) & (uniq_ids < self.cache_rows)

    def _rows(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(ids).to(self.device, non_blocking=True)

    # ------------------------------------------------------------- pull
    def pull(self, uniq_ids) -> torch.Tensor:
        """Rows for UNIQUE ids -> [n, dim] on the card: a gather for hot
        ids, one pull_sparse RPC for cold ones."""
        uniq_ids = np.asarray(uniq_ids, np.int64)
        hot_mask = self._hot_mask(uniq_ids)
        self.device_pulls += 1
        if hot_mask.all():
            return self.table.index_select(0, self._rows(uniq_ids))
        cold_pos = np.nonzero(~hot_mask)[0]
        cold = np.asarray(self._client.pull_sparse(
            self._table_id, uniq_ids[cold_pos]), np.float32)
        self.host_pulls += 1
        out = torch.zeros((len(uniq_ids), self.dim), dtype=torch.float32,
                          device=self.device)
        hot_pos = np.nonzero(hot_mask)[0]
        if hot_pos.size:
            out[self._rows(hot_pos)] = self.table.index_select(
                0, self._rows(uniq_ids[hot_pos]))
        out[self._rows(cold_pos)] = torch.from_numpy(cold).to(self.device)
        return out

    # ------------------------------------------------------------- push
    @torch.no_grad()
    def push(self, uniq_ids, grads) -> None:
        """Apply gradients for UNIQUE ids: the rule's indexed update on
        the card for hot rows, push_sparse for the cold tail."""
        uniq_ids = np.asarray(uniq_ids, np.int64)
        g = grads.to(self.device, torch.float32) if torch.is_tensor(grads) \
            else torch.from_numpy(np.asarray(grads, np.float32)).to(
                self.device)
        hot_mask = self._hot_mask(uniq_ids)
        hot_pos = np.nonzero(hot_mask)[0]
        if hot_pos.size:
            rows = self._rows(uniq_ids[hot_pos])
            gh = g.index_select(0, self._rows(hot_pos))
            if self._adagrad:
                acc = self._state.index_select(0, rows) + gh * gh
                self._state.index_copy_(0, rows, acc)
                # the square root through f64, rounded once to f32: the
                # correctly rounded f32 root numpy's host rule takes
                # (torch's vectorised f32 root on the CPU is not)
                root = torch.sqrt(acc.double()).float()
                upd = (self._lr * gh) / (root + 1e-6)
            else:
                upd = self._lr * gh
            # a gather, the subtraction and a scatter (the ids are unique):
            # index_add_ runs as float atomics on the card, which flush
            # subnormal results to zero where the host rule keeps them
            self.table.index_copy_(
                0, rows, self.table.index_select(0, rows) - upd)
        cold_pos = np.nonzero(~hot_mask)[0]
        if cold_pos.size:
            self._client.push_sparse(
                self._table_id, uniq_ids[cold_pos],
                g.index_select(0, self._rows(cold_pos)).cpu().numpy())

    # ------------------------------------------------------------ flush
    def flush(self) -> None:
        """Write the hot rows and their accumulator back to the PS (direct
        assignment: a delta pushed through the table's own rule would
        apply the rule twice)."""
        self._client.set_sparse(
            self._table_id, np.arange(self.cache_rows, dtype=np.int64),
            self.table.cpu().numpy(), states=self._state.cpu().numpy())
