"""Optimizer base (port of paddle_tpu/optimizer/optimizer.py): the eager
API and the functional bridge of jit.TrainStep, over one update.

Each optimizer implements `_update(param, grad, state, lr)`. The JAX
version is pure and returns new arrays; the port updates the parameter
and its state IN PLACE (no second copy of ~3x the parameter bytes) and
returns them. Both routes run it through `_apply_one`:
- eager: `step()` reads each parameter's `.grad` (parameters that are
  trainable and have one), clips them with grad_clip
  (`ClipGradByGlobalNorm.__call__`), adds the parameter's regularizer or
  else the optimizer's weight decay, and updates with the learning rate
  times the parameter's own multiplier (ParamAttr learning_rate);
  `clear_grad`, `minimize`, `backward` and `apply_gradients` complete
  the surface; the state lives per parameter;
- functional: `init_opt_state` / `apply_updates` over name -> tensor
  dicts, which jit.TrainStep drives (optimizer.py:343-370).

The learning rate is a float or an LRScheduler (optimizer/lr.py), read
by `get_lr()` at every step; `set_lr` refuses a scheduler, as the
reference does. `state_dict()` holds every accumulator under the JAX
package's key `{param.name}_{accumulator}` (`master` too under master
weights), `global_step`, and the scheduler's state as `LR_Scheduler`.

Under master weights (AMP O2) a bf16/fp16 parameter's update runs on its
f32 `master` copy, which is then cast back into the parameter. A float
`weight_decay` becomes `L2Decay(weight_decay)` (optimizer.py:36-39),
added to the gradient before the update in the parameter's own dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.tensor import box, plain
from ..regularizer import L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer"]

_LOWP = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self.regularization = L2Decay(weight_decay) \
            if isinstance(weight_decay, float) else weight_decay
        # eager state per parameter, keyed by id(param)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0
        # the parameter being updated and its name (AdamW's
        # apply_decay_param_fun, Lamb's and Lars's exclusions read them)
        self._current_param = None
        self._current_param_name = None
        # AMP O2 master weights (amp.decorate turns this on)
        self._multi_precision = False
        # {parameter name: process group} for the parameters a sharded
        # train step updates in pieces split over the group's ranks:
        # Lamb's and Lars's norms are of the whole parameter
        self._norm_groups: Dict[str, object] = {}

    # --------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "set_lr is not allowed when the learning rate is an "
                "LRScheduler; call scheduler.step() instead")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        return self._learning_rate \
            if isinstance(self._learning_rate, LRScheduler) else None

    # ----------------------------------------------------------- update
    def _lowp(self, t: torch.Tensor) -> bool:
        return self._multi_precision and t.dtype in _LOWP

    def _fresh_state(self, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Accumulators for one parameter; low-precision parameters under
        master weights also get an f32 `master` copy."""
        t = plain(t).detach()
        if self._lowp(t):
            master = t.float().clone()
            st = self._init_state(master)
            st["master"] = master
            return st
        return self._init_state(t)

    def _whole_norm(self, t):
        """The L2 norm of the parameter being updated whose piece (or
        whole) is `t`: the square root of its pieces' sums of squares,
        all-reduced over the group in _norm_groups (none: `t` is
        whole)."""
        sq = t.square().sum()
        pg = self._norm_groups.get(self._current_param_name)
        if pg is not None:
            from ..distributed import collective as C
            C._all_reduce(sq, C.ReduceOp.SUM, pg)
        return sq.sqrt()

    def _apply_one(self, p, g, state, lr):
        if "master" in state:
            self._update(state["master"], g.float(), state, lr)
            p.copy_(state["master"])
            return p, state
        return self._update(p, g, state, lr)

    def _init_state(self, param) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, param, grad, state, lr):
        raise NotImplementedError

    def _param_lr(self, p) -> float:
        return (getattr(p, "optimize_attr", None)
                or {"learning_rate": 1.0}).get("learning_rate", 1.0)

    def _state_for(self, p) -> Dict[str, torch.Tensor]:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._fresh_state(p)
        return st

    def _regularized(self, p, g):
        reg = getattr(p, "regularizer", None) or self.regularization
        return g if reg is None else reg.apply(p, g)

    # ------------------------------------------------------- eager api
    def _guard_grads(self, params_grads) -> bool:
        """The process-wide anomaly guard (core/anomaly.py) over this
        step's gradients, before clipping (paddle_tpu/optimizer/
        optimizer.py:114-137): one host read of the not-finite flag.
        False drops the update (skip_step); zero_grads repairs the
        gradients in place; raise raises."""
        from ..core import anomaly
        guard = anomaly.current_guard()
        if guard is None or not params_grads:
            return True
        bad = bool(anomaly.tree_not_finite([g for _, g in params_grads]))
        if not guard.record(bad, where="gradients"):
            return True
        if guard.policy == "zero_grads":
            for _, g in params_grads:
                plain(g).copy_(anomaly.sanitize_tree(plain(g)))
            return True
        return False

    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter that has a .grad
        (dropped or repaired by an active anomaly guard)."""
        params_grads = [(p, p.grad) for p in self._parameter_list or []
                        if p.grad is not None
                        and getattr(p, "trainable", True)]
        if not self._guard_grads(params_grads):
            return
        self._apply(params_grads)

    def _apply(self, params_grads):
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        for p, g in params_grads:
            if g is None:
                continue
            w, g = plain(p).detach(), plain(g)
            self._current_param = p
            self._current_param_name = getattr(p, "name", None)
            self._apply_one(w, self._regularized(w, g), self._state_for(p),
                            lr * self._param_lr(p))
        self._global_step += 1

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or []:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def backward(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None, callbacks=None):
        loss.backward()
        return [(p, p.grad) for p in self._parameter_list or []]

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        from ..static.program import Variable
        if isinstance(loss, Variable):
            return self._static_minimize(loss, startup_program, parameters,
                                         no_grad_set)
        params_grads = self.backward(loss)
        self.step()
        return None, params_grads

    def _static_minimize(self, loss, startup_program=None, parameters=None,
                         no_grad_set=None, params_grads=None,
                         found_inf=None):
        """The static graph's minimize (paddle_tpu/optimizer/
        optimizer.py:189-283): append_backward, then one `optimize.clip`
        op over the gradients when there is a grad_clip, then one
        `optimize.update` op per parameter over this optimizer's own
        `_update` (in place on the parameter and its accumulators, which
        the startup program creates as `{param}_{key}_acc`), with the
        parameter's regularizer (else the optimizer's) and learning-rate
        multiplier, and the learning rate read at every run. Under AMP
        the update is dropped, on the device, when found_inf is set."""
        from ..static import backward as _B
        from ..static.program import OpDesc, default_startup_program
        prog = loss.block.program
        blk = prog.global_block
        startup = startup_program or default_startup_program()
        if params_grads is None:
            params_grads = _B.append_backward(loss, parameters, no_grad_set)

        if self._grad_clip is not None:
            gnames = [g.name for _, g in params_grads]
            clip = self._grad_clip

            def clip_fn(*gs):
                return tuple(clip.clip_arrays(list(gs)))

            blk.append_op(OpDesc("op", "optimize.clip", clip_fn, gnames,
                                 gnames))

        lr_name = prog.add_runtime_scalar("learning_rate", self.get_lr)
        update_ops = []
        for p, g in params_grads:
            with torch._C.DisableTorchFunction():  # stays on meta
                tmpl = self._init_state(torch.empty(
                    tuple(p.shape), dtype=p.dtype, device="meta"))
            skeys = sorted(tmpl)
            snames = [f"{p.name}_{k}_acc" for k in skeys]
            for k, sn in zip(skeys, snames):
                for b in (blk, startup.global_block):
                    b.create_var(name=sn, shape=tuple(tmpl[k].shape),
                                 dtype=tmpl[k].dtype, persistable=True)

                def init_fn(device, _k=k, _shape=tuple(p.shape),
                            _dtype=p.dtype):
                    return self._init_state(torch.zeros(
                        _shape, dtype=_dtype, device=device))[_k]

                startup.global_block.append_op(
                    OpDesc("init", "fill_accumulator", init_fn, [], [sn]))
            reg = getattr(p, "regularizer", None) or self.regularization

            def upd(pv, gv, lr, *rest, _skeys=tuple(skeys), _reg=reg,
                    _mult=self._param_lr(p), _param=p,
                    _gated=found_inf is not None):
                finf, svals = (rest[0], rest[1:]) if _gated else \
                    (None, rest)
                with torch.no_grad():
                    pv = pv.detach()
                    state = dict(zip(_skeys, svals))
                    keep = [pv.clone()] + [s.clone() for s in svals] \
                        if _gated else None
                    if _reg is not None:
                        gv = _reg.apply(pv, gv)
                    self._current_param = _param
                    self._current_param_name = _param.name
                    pv, state = self._update(pv, gv, state, lr * _mult)
                    outs = (pv,) + tuple(state[k] for k in _skeys)
                    if _gated:
                        # AMP: an overflowing step leaves the parameter
                        # and its state as they were
                        for o, k in zip(outs, keep):
                            torch.where(finf, k, o, out=o)
                return outs

            extra = [found_inf.name] if found_inf is not None else []
            update_ops.append(blk.append_op(OpDesc(
                "op", "optimize.update", upd,
                [p.name, g.name, lr_name] + extra + snames,
                [p.name] + snames)))
        return update_ops, params_grads

    @torch.no_grad()
    def apply_gradients(self, params_grads):
        """One update from explicit (param, grad) pairs."""
        self._apply(list(params_grads))

    # -------------------------------------------------------- state i/o
    def state_dict(self):
        out = {}
        for p in self._parameter_list or []:
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                out[f"{p.name}_{k}"] = box(v)
        out["global_step"] = self._global_step
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        self._global_step = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        for p in self._parameter_list or []:
            st = self._fresh_state(p)
            found = False
            for k, t in st.items():
                v = state_dict.get(f"{p.name}_{k}")
                if v is not None:
                    src = plain(v) if torch.is_tensor(v) else \
                        torch.as_tensor(v)
                    t.copy_(src.to(t.device))
                    found = True
            if found:
                self._accumulators[id(p)] = st

    set_dict = set_state_dict

    # ------------------------------------------ functional (TrainStep)
    @torch.no_grad()
    def init_opt_state(self, flat_params: Dict[str, torch.Tensor]):
        """{name: state dict} for `apply_updates`."""
        return {k: self._fresh_state(v) for k, v in flat_params.items()}

    @torch.no_grad()
    def apply_updates(self, flat_params, flat_grads, opt_state, lr=None):
        """Update every parameter that has a gradient, in place, over
        name -> tensor dicts; returns (flat_params, opt_state)."""
        lr = self.get_lr() if lr is None else float(lr)
        for k, p in flat_params.items():
            g = flat_grads.get(k)
            if g is None:
                continue
            if self.regularization is not None:
                g = self.regularization.apply(p, g)
            self._current_param, self._current_param_name = p, k
            self._apply_one(p, g, opt_state[k], lr)
        return flat_params, opt_state

