from .common import Dropout, Embedding, Linear
from .norm import LayerNorm

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm"]
