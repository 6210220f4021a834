"""nn of the port (paddle_tpu/nn): Layer and ParamAttr, the layers
(activations, common, containers, losses, norms, convolution, pooling,
recurrent and Transformer), the functionals, initializers, clipping,
utils (weight and spectral norm) and seq2seq decoding, with the JAX
package's module aliases (`vision` is layer.common, PixelShuffle's
home; `extension` is functional.extension)."""
from . import functional, initializer, utils
from . import utils as weight_norm_hook  # noqa: F401 (the module's other name)
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, clip_grad_norm_)
from .decode import (BasicDecoder, BeamSearchDecoder, DecodeHelper, Decoder,
                     GreedyEmbeddingHelper, SampleEmbeddingHelper,
                     TrainingHelper, dynamic_decode)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .functional import extension  # noqa: F401
from .layer import common, conv, loss, norm, rnn  # noqa: F401
from .layer import common as vision  # noqa: F401

__all__ = ["functional", "initializer", "utils", *_layers,
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "clip_grad_norm_", "Decoder",
           "BeamSearchDecoder", "dynamic_decode", "BasicDecoder",
           "DecodeHelper", "TrainingHelper", "GreedyEmbeddingHelper",
           "SampleEmbeddingHelper"]
