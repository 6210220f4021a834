"""Loss scaling (port of paddle_tpu/amp/grad_scaler.py): GradScaler and
its alias AmpScaler, with the reference's dynamic-scale state machine
(scale up by incr_ratio after incr_every_n_steps good steps; on an
inf/nan gradient skip the optimizer step and scale down by decr_ratio
after decr_every_n_nan_or_inf bad ones, never below 1).

The found-inf check reads the host once a step. The reference reads one
flag per parameter; here `unscale_` multiplies every gradient by 1/scale
and checks them all with torch's fused multi-tensor unscale-and-check
(`torch._amp_foreach_non_finite_check_and_unscale_`, a library kernel
that is no port of a TPU kernel), one flag per device, and then reads
that one flag. `host_syncs` counts those reads.
"""
from __future__ import annotations

from collections import defaultdict

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        # host reads of the found-inf flag, and the optimizer steps
        # skipped for an inf/nan gradient
        self.host_syncs = 0
        self.skipped_steps = 0

    def scale(self, var):
        """var * the loss scale, in var's dtype."""
        if not self._enable:
            return var
        return var * self._scale

    def _unscale(self, optimizer):
        if not self._enable or self._unscaled:
            return
        grads = defaultdict(list)
        for p in optimizer._parameter_list or []:
            g = p.grad
            if g is not None:
                grads[(g.device, g.dtype)].append(g)
        flags = []
        with torch.no_grad():
            for (dev, _), gs in grads.items():
                found = torch.zeros(1, device=dev)
                inv = torch.full((1,), 1.0 / self._scale, device=dev)
                torch._amp_foreach_non_finite_check_and_unscale_(
                    gs, found, inv)
                flags.append(found.to(flags[0].device) if flags else found)
            if flags:
                self.host_syncs += 1
                self._found_inf = bool(torch.stack(flags).sum().item())
        self._unscaled = True

    def unscale_(self, optimizer):
        return self._unscale(optimizer)

    def minimize(self, optimizer, scaled_loss, *args, **kwargs):
        """Unscale, step unless a gradient is inf/nan, update the scale.
        scaled_loss has been backpropagated by the caller."""
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self._unscale(optimizer)
        if self._found_inf:
            self.skipped_steps += 1
            # an overflow step is an anomaly skip (paddle_tpu/amp/
            # grad_scaler.py:73-83): an active guard not set to 'raise'
            # counts it as skipped
            from ..core.anomaly import current_guard
            guard = current_guard()
            if guard is not None and guard.policy != "raise":
                guard.record(True, where="amp overflow", counter="skipped")
        else:
            optimizer.step()
        self._unscaled = False

    def update(self):
        if not self._enable or not self._use_dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def get_init_loss_scaling(self):
        """The current loss scale (the reference's name)."""
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps,
                "use_dynamic_loss_scaling": self._use_dynamic}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
