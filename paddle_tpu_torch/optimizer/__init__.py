from .optimizer import Optimizer
from .optimizers import Adam, AdamW, Momentum

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]
