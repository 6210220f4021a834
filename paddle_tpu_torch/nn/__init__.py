"""nn of the port (paddle_tpu/nn): Layer and ParamAttr, the layers,
functionals, initializers and clipping that the eager surface and the
GPT, ResNet, BERT and LeNet train steps use."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm
from .layer import (GELU, AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                    Embedding, HookRemoveHelper, Layer, LayerList, LayerNorm,
                    Linear, MaxPool2D, ParamAttr, ReLU, Sequential)

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm", "Layer",
           "HookRemoveHelper", "ParamAttr", "Linear", "Embedding", "Dropout",
           "LayerNorm", "BatchNorm2D", "Conv2D", "ReLU", "GELU",
           "Sequential", "LayerList", "MaxPool2D", "AdaptiveAvgPool2D"]
