"""nn of the port (paddle_tpu/nn): the layers, functionals and clipping
the GPT train step uses."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["functional", "ClipGradByGlobalNorm", "Linear", "Embedding",
           "Dropout", "LayerNorm"]
