"""Functionals of the GPT train step (port of paddle_tpu/nn/functional)."""
from .attention import scaled_dot_product_attention
from .common import dropout, embedding, gelu, linear
from .loss import cross_entropy, softmax_with_cross_entropy
from .norm import layer_norm

__all__ = ["scaled_dot_product_attention", "linear", "embedding",
           "dropout", "gelu", "layer_norm", "cross_entropy",
           "softmax_with_cross_entropy"]
