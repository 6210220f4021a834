"""Functionals of the GPT, ResNet, BERT and LeNet train steps and the
eager surface (port of paddle_tpu/nn/functional)."""
from .activation import gelu, relu, softmax, tanh
from .attention import scaled_dot_product_attention
from .common import dropout, embedding, linear
from .conv import conv2d
from .loss import cross_entropy, softmax_with_cross_entropy
from .norm import batch_norm, batch_norm_act, layer_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["scaled_dot_product_attention", "linear", "embedding",
           "dropout", "gelu", "relu", "tanh", "softmax", "layer_norm",
           "batch_norm", "batch_norm_act", "conv2d", "max_pool2d",
           "adaptive_avg_pool2d", "cross_entropy",
           "softmax_with_cross_entropy"]
