"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

    import paddle_tpu_torch as paddle

The package mirrors paddle_tpu's layout (paddle_tpu/X/y.py ports to
paddle_tpu_torch/X/y.py) and keeps its parameter names and layouts, so
a parameter dict moves between the two packages unchanged. Hand-written
Hopper kernels live in ops/kernels/, each beside a plain PyTorch version
of the same math.

Entry points run on CUDA unless the caller asks for the CPU
(`set_device("cpu")` or device="cpu"); without a GPU and without that
request they raise (core/place.py).

Ported so far: serving (models/gpt.py, models/generation.py,
inference/serving/ over the ragged paged-attention kernel K3, with the
prefix cache, the host tier, int8 KV blocks, tenancy, obs/ and the
inference facade); the GPT, ResNet-50, BERT-base, ERNIE-large and LeNet
train steps (nn/, optimizer/, amp.decorate, jit.TrainStep) over the
flash-attention kernels K1 and K2, beside K4 at ResNet-50's block
boundaries; and the eager surface of this module: Tensor and
to_tensor, paddle.grad and the grad-mode contexts, seed, set_device,
the dtypes, the creation, math, shape and matmul ops, nn.Layer with
ParamAttr, the optimizers' step()/clear_grad() with the LR schedulers,
amp.auto_cast and GradScaler; the sequence-model half of nn
(Transformer, RNNs, seq2seq decoding, losses, activations,
initializers, clipping), the optimizers SGD to Lars, and save/load in
the JAX package's checkpoint format; the vision half of nn (every
convolution, pool, norm and resize layer, channel-first and
channel-last), MobileNetV1/V2, VGG, channel-last ResNet and the EMA,
ModelAverage and Lookahead wrappers. A name of paddle_tpu's top level
that is not ported is absent here.
"""
from .core import errors
from .core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from .core.dtypes import (bfloat16, bool_, complex64, complex128,
                          convert_dtype, float16, float32, float64,
                          get_default_dtype, int8, int16, int32, int64,
                          set_default_dtype, uint8)
from .core.flags import get_flags, set_flags
from .core.place import (CPUPlace, CUDAPlace, Place, device_count,
                         get_device, is_compiled_with_cuda, resolve_device,
                         set_device)
from .core.random import get_rng_state, seed
from .core.tensor import Tensor, to_tensor
from .core.unported import not_ported as _not_ported
from .ops.creation import (arange, full, full_like, ones, ones_like, rand,
                           randint, randn, zeros, zeros_like)
from .framework_io import load, save
from .ops.extra_ops import gather_tree
from .ops.linalg import bmm, matmul
from .ops.logic import logical_not, logical_or
from .ops.manipulation import (concat, expand, flatten, index_select,
                               reshape, split, squeeze, stack,
                               take_along_axis, transpose, unsqueeze, where)
from .ops.math import (abs, add, all, cast, clip, divide, exp, log, max,
                       maximum, mean, min, minimum, multiply, neg, pow,
                       sqrt, square, subtract, sum, tanh)
from .ops.search import argmax, topk

from . import (amp, distributed, incubate, inference, jit, models, nn, obs,
               optimizer, regularizer, vision)
from .nn.layer.base import ParamAttr

bool8 = bool_


def in_dygraph_mode() -> bool:
    """The port runs eagerly only: always True."""
    return True


def enable_dygraph(place=None):
    """Eager mode is the port's only mode: nothing to enable (place is
    accepted and ignored, as in the reference)."""


def disable_dygraph():
    """Static graphs are not ported yet."""
    _not_ported("paddle.disable_dygraph (static graph mode)",
                "ROADMAP Queue 1 item 8, static/")


__version__ = "0.1.0"
