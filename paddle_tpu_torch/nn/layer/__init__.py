from .activation import ReLU
from .common import Dropout, Embedding, Linear
from .container import Sequential
from .conv import Conv2D
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "BatchNorm2D",
           "Conv2D", "ReLU", "Sequential", "MaxPool2D", "AdaptiveAvgPool2D"]
