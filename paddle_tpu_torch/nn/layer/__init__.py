from .activation import GELU, ReLU
from .base import ParamAttr
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import Conv2D
from .layers import HookRemoveHelper, Layer
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["Layer", "HookRemoveHelper", "ParamAttr", "Linear", "Embedding",
           "Dropout", "LayerNorm", "BatchNorm2D", "Conv2D", "ReLU", "GELU",
           "Sequential", "LayerList", "MaxPool2D",
           "AdaptiveAvgPool2D"]
