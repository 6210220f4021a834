"""nn of the port (paddle_tpu/nn): the layers, functionals and clipping
the GPT and ResNet train steps use."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                    Embedding, LayerNorm, Linear, MaxPool2D, ReLU, Sequential)

__all__ = ["functional", "ClipGradByGlobalNorm", "Linear", "Embedding",
           "Dropout", "LayerNorm", "BatchNorm2D", "Conv2D", "ReLU",
           "Sequential", "MaxPool2D", "AdaptiveAvgPool2D"]
