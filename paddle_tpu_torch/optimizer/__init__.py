"""optimizer of the port (paddle_tpu/optimizer): the Optimizer base with
the eager API and TrainStep's functional bridge, SGD, Momentum, Adam,
AdamW, Adamax, Adadelta, Adagrad, RMSProp, Lamb and Lars, and the
learning-rate schedulers (`lr`), and the wrappers
ExponentialMovingAverage, ModelAverage and Lookahead."""
from . import lr
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         Lars, LarsMomentum, Momentum, RMSProp)
from .wrappers import (ExponentialMovingAverage, Lookahead,
                       LookaheadOptimizer, ModelAverage)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adadelta", "Adagrad", "RMSProp", "Lamb", "Lars", "LarsMomentum",
           "ExponentialMovingAverage", "ModelAverage", "LookaheadOptimizer",
           "Lookahead", "lr"]
