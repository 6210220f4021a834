"""Regularizers (port of paddle_tpu/regularizer.py): weight decay added to
the gradient before the update, L2Decay as grad + coeff * param and
L1Decay as grad + coeff * sign(param). An optimizer's float
weight_decay is an L2Decay; a parameter's own regularizer (ParamAttr)
takes the place of the optimizer's."""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L2Decay", "L1Decay",
           "L2DecayRegularizer", "L1DecayRegularizer"]


class WeightDecayRegularizer:
    def apply(self, param, grad):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def apply(self, param, grad):
        return grad + self._coeff * param

    def __str__(self):
        return f"L2Decay, coeff={self._coeff}"


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def apply(self, param, grad):
        return grad + self._coeff * torch.sign(param)

    def __str__(self):
        return f"L1Decay, coeff={self._coeff}"


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay
