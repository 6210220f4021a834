"""Functionals of the port (paddle_tpu/nn/functional): activations,
attention, the sequence-side common functionals, convolution, losses,
norms and pooling, and gather_tree (the JAX package exports it here
too)."""
from ...ops.extra_ops import gather_tree
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .attention import scaled_dot_product_attention
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv import conv2d
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import batch_norm, batch_norm_act, layer_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = [*_activation, *_common, *_loss, "scaled_dot_product_attention",
           "layer_norm", "batch_norm", "batch_norm_act", "conv2d",
           "max_pool2d", "adaptive_avg_pool2d", "gather_tree"]
