"""L2Decay (port of paddle_tpu/regularizer.py `L2Decay`): weight decay
added to the gradient, grad + coeff * param, before the update."""
from __future__ import annotations

__all__ = ["L2Decay"]


class L2Decay:
    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    def apply(self, param, grad):
        return grad + self._coeff * param
