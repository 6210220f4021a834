"""Communication-optimizing strategies: LocalSGD, adaptive LocalSGD, DGC
and the fp16 allreduce (port of paddle_tpu/distributed/fleet/comm_opt.py).

Reference: fleet/meta_optimizers/localsgd_optimizer.py (k local steps,
then parameters averaged), dgc_optimizer.py with dgc_momentum_op.cc
(top-k sparsified gradient sync with momentum correction and error
feedback) and fp16_allreduce_optimizer.py (gradients cast to 16 bits
for the allreduce and back).

The JAX package runs one shard_map step whose parameters and moments
carry a leading per-rank axis over "dp". Here each rank is a process
that keeps its own parameters (the model it was given) and moments (the
optimizer's accumulators), so the per-rank state is simply this
process's; the collectives run over the dp group of the mesh (the
global one, or a dp mesh over every rank when the given mesh has other
axes, as the JAX package's `_dp_mesh` builds):
- each rank computes its loss and gradients on its rows of the global
  batch (dim 0 split over dp, the JAX step's in_specs), clips them as
  the JAX step does (the clip's `clip_arrays` in name order) and
  applies the optimizer locally;
- LocalSGD averages the parameters (one all-reduce each) on the steps
  its schedule names; Fp16AllReduceStep all-reduces the gradients in
  float16 or bfloat16 (bfloat16 by default, as in the JAX package) and
  casts them back before the update, so the copies stay equal;
- DGC, after rampup_begin_step, keeps per-parameter momentum u and error
  feedback v, selects |v| >= the `sparsity` quantile of |v| (numpy's
  and jnp.quantile's "linear" interpolation, computed from two order
  statistics with `kthvalue`, as torch.quantile refuses more than 2^24
  elements), averages v * mask over dp (dense, as the JAX package's
  pmean: one all-reduce of every parameter's masked v in one flat
  buffer), clears the sent entries of u and v and applies
  p -= lr * synced; before it, the dense baseline optimizer runs on
  all-reduced gradients. `last_density` is the kept fraction, averaged
  over the ranks.
The returned loss is the mean of the ranks' losses. `sync_to_model()`
averages the parameters and buffers over dp into the model (the JAX
package writes the ranks' mean into the Layer); `rank_params(rank)`
all-gathers one rank's copy (every rank calls it).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...core.tensor import box, plain, plain_dispatch
from ...parallel import mesh as _mesh
from ...parallel.api import shard_batch

__all__ = ["LocalSGDStep", "AdaptiveLocalSGDStep", "DGCStep",
           "Fp16AllReduceStep", "quantile_linear"]


def _dp_mesh(mesh):
    """A mesh whose only split axis is dp (every rank over dp otherwise)."""
    mesh = mesh or _mesh.get_global_mesh()
    if mesh is not None and all(mesh.shape[a] == 1 for a in _mesh.AXES
                                if a != "dp"):
        return mesh
    return _mesh.build_mesh(dp=_mesh.world_size())


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """jnp.quantile(x.ravel(), q) with the "linear" method, in f32 as
    the JAX package's DGC computes it: q (n - 1) in f32, its floor and
    ceiling as order statistics (`kthvalue`: any number of elements)
    and their weighted sum."""
    x = x.reshape(-1).float()
    n = torch.tensor(float(x.numel()), dtype=torch.float32)
    qi = torch.tensor(q, dtype=torch.float32) * (n - 1)
    low, high = torch.floor(qi), torch.ceil(qi)
    hw = qi - low
    lw = 1 - hw
    lo = int(low.clamp(0, n - 1).item())
    hi = int(high.clamp(0, n - 1).item())
    lo_v = torch.kthvalue(x, lo + 1).values
    hi_v = lo_v if hi == lo else torch.kthvalue(x, hi + 1).values
    return lo_v * lw.to(x.device) + hi_v * hw.to(x.device)


class _PerRankStep:
    """Shared skeleton: this rank's parameters and moments, its rows of
    the batch, the dp group's collectives."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 sync_dtype=None, k_steps: int = 1):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = _dp_mesh(mesh)
        self.ndp = self.mesh.shape["dp"]
        self._pg = self.mesh.group("dp")
        self._k = max(int(k_steps), 1)
        self._i = 0
        self._sync_dtype = sync_dtype

    def _params(self):
        from ...jit import _trains
        return [(k, p) for k, p in self.model.named_parameters()
                if _trains(p)]

    def _local_grads(self, args):
        """(loss, {name: gradient}) on this rank's rows, clipped."""
        params = self._params()
        dev = params[0][1].device
        local = [plain(shard_batch(
            plain(a).to(dev) if torch.is_tensor(a) else
            torch.from_numpy(np.asarray(a)).to(dev), self.mesh, ("dp",)))
            for a in args]
        out = self.loss_fn(self.model, *local)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        got = torch.autograd.grad(loss, [p for _, p in params],
                                  allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params, got)}
        return loss, grads

    def _clip(self, grads):
        clip = self.optimizer._grad_clip
        if clip is None:
            return grads
        names = sorted(grads)
        return dict(zip(names, clip.clip_arrays([grads[k] for k in names])))

    def _mean(self, t: torch.Tensor) -> torch.Tensor:
        """t averaged over dp (in place; the identity without a group)."""
        from .. import collective as C
        if self._pg is not None:
            C._all_reduce(t, C.ReduceOp.AVG, self._pg)
        return t

    def _mean_flat(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor averaged over dp through one flat all-reduce."""
        if not tensors:
            return []
        flat = self._mean(torch.cat([t.reshape(-1) for t in tensors]))
        out, o = [], 0
        for t in tensors:
            out.append(flat[o:o + t.numel()].view(t.shape))
            o += t.numel()
        return out

    def _apply(self, grads):
        params = dict(self._params())
        state_for = self.optimizer._state_for
        self.optimizer.apply_updates(
            {k: params[k].detach() for k in grads}, grads,
            {k: state_for(params[k]) for k in grads})

    def _should_sync(self) -> bool:
        return (self._i + 1) % self._k == 0

    @plain_dispatch
    def __call__(self, *args):
        loss, grads = self._local_grads(args)
        if self._sync_dtype is not None:
            names = sorted(grads)
            low = self._mean_flat([grads[k].to(self._sync_dtype)
                                   for k in names])
            grads = {k: g.to(grads[k].dtype) for k, g in zip(names, low)}
        with torch.no_grad():
            self._apply(self._clip(grads))
            synced_now = bool(self._should_sync())
            if synced_now:
                self.sync_to_model()
        self._i += 1
        self.optimizer._global_step += 1
        return box(self._mean(loss.detach().reshape(()).clone()))

    @torch.no_grad()
    def sync_to_model(self):
        """Average the parameters and buffers over dp (f32 means cast
        back) into the model; under AMP O2 the f32 masters are averaged
        and cast into the parameters."""
        params = [p for _, p in self._params()]
        masters = [self.optimizer._state_for(p).get("master")
                   for p in params]
        ts = [p.detach() if m is None else m
              for p, m in zip(params, masters)] + [
            b for b in self.model.buffers()
            if b is not None and b.is_floating_point()]
        means = self._mean_flat([t.float() for t in ts])
        for t, m in zip(ts, means):
            t.copy_(m)
        for p, m in zip(params, masters):
            if m is not None:
                p.detach().copy_(m)

    @torch.no_grad()
    def rank_params(self, rank: int) -> Dict[str, torch.Tensor]:
        """One rank's parameter copy (every rank calls it)."""
        from .. import collective as C
        out = {}
        for k, p in self._params():
            t = p.detach().contiguous()
            if self._pg is None:
                out[k] = t.clone()
                continue
            rows = torch.empty((self.ndp,) + tuple(t.shape), dtype=t.dtype,
                               device=t.device)
            C._all_gather(rows, t, self._pg)
            out[k] = rows[rank]
        return out


class LocalSGDStep(_PerRankStep):
    """k local steps per rank, then parameter averaging (reference:
    localsgd_optimizer.py; strategy.localsgd_configs['k_steps'])."""

    def __init__(self, model, loss_fn, optimizer, k_steps: int = 4,
                 mesh=None, begin_step: int = 1):
        super().__init__(model, loss_fn, optimizer, mesh=mesh,
                         sync_dtype=None, k_steps=k_steps)
        self._begin = max(int(begin_step), 1)

    def _should_sync(self):
        if self._i + 1 < self._begin:
            return False
        return (self._i + 1 - self._begin) % self._k == self._k - 1 \
            if self._k > 1 else True


class AdaptiveLocalSGDStep(LocalSGDStep):
    """Adaptive comm period (AdaComm): k_t = ceil(sqrt(loss_0 / loss_t)
    k0), clipped to [1, max_k_steps]."""

    def __init__(self, model, loss_fn, optimizer, init_k_steps: int = 1,
                 max_k_steps: int = 16, mesh=None, begin_step: int = 1):
        super().__init__(model, loss_fn, optimizer, k_steps=init_k_steps,
                         mesh=mesh, begin_step=begin_step)
        self._k0 = max(int(init_k_steps), 1)
        self._kmax = max_k_steps
        self._loss0 = None

    def __call__(self, *args):
        loss = super().__call__(*args)
        lv = float(plain(loss))
        if self._loss0 is None:
            self._loss0 = max(lv, 1e-12)
        ratio = self._loss0 / max(lv, 1e-12)
        self._k = int(np.clip(np.ceil(np.sqrt(ratio) * self._k0),
                              1, self._kmax))
        return loss


class DGCStep(_PerRankStep):
    """Deep Gradient Compression (reference: dgc_momentum_op.cc, dgc_op.cc,
    dgc_optimizer.py; Lin et al. 2018); see the module docstring. Before
    rampup_begin_step the dense baseline optimizer runs; then sparsity
    steps through `sparsity` over `rampup_step` steps."""

    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 rampup_begin_step: int = 0, rampup_step: int = 1,
                 sparsity=(0.999,), momentum: Optional[float] = None):
        super().__init__(model, loss_fn, optimizer, mesh=mesh,
                         sync_dtype=None, k_steps=1)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(int(rampup_step), 1)
        self._sparsity = [float(s) for s in sparsity]
        self._m = float(momentum if momentum is not None
                        else getattr(optimizer, "_momentum", 0.9))
        self.last_density = None
        # kept fraction of each parameter on this rank at the last step
        self.last_densities: Dict[str, float] = {}
        self._u: Dict[str, torch.Tensor] = {}
        self._v: Dict[str, torch.Tensor] = {}

    def _sparsity_now(self) -> float:
        if self._i < self._rampup_begin:
            return 0.0
        k = (self._i - self._rampup_begin) * len(self._sparsity) \
            // self._rampup_step
        return self._sparsity[min(k, len(self._sparsity) - 1)]

    @plain_dispatch
    def __call__(self, *args):
        loss, grads = self._local_grads(args)
        q = self._sparsity_now()
        with torch.no_grad():
            grads = self._clip(grads)
            names = sorted(grads)
            if q > 0:
                density = self._dgc(grads, names, q)
            else:
                means = self._mean_flat([grads[k] for k in names])
                self._apply(dict(zip(names, means)))
                density = torch.ones((), device=means[0].device)
        self._i += 1
        self.optimizer._global_step += 1
        self.last_density = float(self._mean(density.float()))
        return box(self._mean(loss.detach().reshape(()).clone()))

    def _dgc(self, grads, names, q):
        params = dict(self._params())
        lr = self.optimizer.get_lr()
        masked, kept, total = [], 0.0, 0
        for k in names:
            # u, v and the synced update in f32 (the JAX package's state
            # has the parameters' dtype, f32 there; under AMP O2 the
            # update goes to the f32 master)
            g = grads[k].float()
            if k not in self._u:
                self._u[k] = torch.zeros_like(g)
                self._v[k] = torch.zeros_like(g)
            uu = self._m * self._u[k] + g
            vv = self._v[k] + uu
            thr = quantile_linear(vv.abs(), q)
            mask = (vv.abs() >= thr).to(vv.dtype)
            masked.append(vv * mask)
            self._v[k] = vv * (1 - mask)
            self._u[k] = uu * (1 - mask)
            n = float(mask.sum())
            self.last_densities[k] = n / mask.numel()
            kept += n
            total += mask.numel()
        state_for = self.optimizer._state_for
        for k, synced in zip(names, self._mean_flat(masked)):
            p = params[k].detach()
            # under AMP O2 the f32 master takes the update, as the
            # optimizer's own updates do
            master = state_for(params[k]).get("master")
            if master is None:
                p.sub_((lr * synced).to(p.dtype))
            else:
                master.sub_(lr * synced)
                p.copy_(master)
        return torch.tensor(kept / total, dtype=torch.float32,
                            device=masked[0].device)


class Fp16AllReduceStep(_PerRankStep):
    """Per-step gradient sync in 16 bits (reference:
    fp16_allreduce_optimizer.py; bfloat16 by default, as in the JAX
    package). The copies stay equal, so no parameter average runs."""

    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 dtype: str = "bfloat16"):
        dt = {"float16": torch.float16, "bfloat16": torch.bfloat16}[dtype]
        super().__init__(model, loss_fn, optimizer, mesh=mesh,
                         sync_dtype=dt, k_steps=1)

    def _should_sync(self):
        return False
