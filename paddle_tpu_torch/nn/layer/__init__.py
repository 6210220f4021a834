from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .base import ParamAttr
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import Conv2D
from .layers import HookRemoveHelper, Layer
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import BatchNorm2D, LayerNorm, SpectralNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer

__all__ = ["Layer", "HookRemoveHelper", "ParamAttr", *_activation, *_common,
           *_loss, *_rnn, *_transformer, "Sequential", "LayerList",
           "ParameterList", "LayerDict", "Conv2D", "LayerNorm",
           "BatchNorm2D", "SpectralNorm", "MaxPool2D", "AdaptiveAvgPool2D"]
