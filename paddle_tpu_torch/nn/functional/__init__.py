"""Functionals of the port (paddle_tpu/nn/functional): activations,
attention, the common functionals (the vision half too: interpolate,
unfold, pixel_shuffle), convolution, losses, norms and pooling, the
vision ops nn.functional exports (grid_sample, affine_grid, fold,
pixel_unshuffle, temporal_shift), pad, diag_embed, sigmoid_focal_loss
and gather_tree (the JAX package exports them here too)."""
from ...ops.creation import diag_embed
from ...ops.extra_ops import gather_tree, sigmoid_focal_loss
from ...ops.manipulation import pad
from ...ops.vision_ops import (affine_grid, fold, grid_sample,
                               pixel_unshuffle, temporal_shift)
from . import extension  # noqa: F401
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .attention import scaled_dot_product_attention
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling

__all__ = [*_activation, *_common, *_conv, *_loss, *_norm, *_pooling,
           "scaled_dot_product_attention", "gather_tree", "diag_embed",
           "sigmoid_focal_loss", "pad", "affine_grid", "fold",
           "grid_sample", "pixel_unshuffle", "temporal_shift", "extension"]
