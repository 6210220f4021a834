"""incubate.optimizer (port of paddle_tpu/incubate/optimizer.py):
LookAhead, ModelAverage and ExponentialMovingAverage, the wrappers of
optimizer/wrappers.py."""
from ..optimizer.wrappers import (ExponentialMovingAverage,  # noqa: F401
                                  LookaheadOptimizer as LookAhead,
                                  ModelAverage)

__all__ = ["LookAhead", "ModelAverage", "ExponentialMovingAverage"]
