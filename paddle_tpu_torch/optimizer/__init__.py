"""optimizer of the port (paddle_tpu/optimizer): the Optimizer base with
the eager API and TrainStep's functional bridge, Momentum, Adam and
AdamW, and the learning-rate schedulers (`lr`)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Adam, AdamW, Momentum

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW", "lr"]
