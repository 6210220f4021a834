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
ModelAverage and Lookahead wrappers; the training runtime: io
(DataLoader, the samplers, DeviceLoader), vision datasets, transforms
and image loading, metric, hapi's Model.fit with its callbacks, summary
and flops, AutoCheckpointManager and the anomaly guard; the core op
corpus (math, logic, search, manipulation, creation, linalg, random and
array ops, with paddle.linalg) at the top level and as the Tensor's
Paddle methods; activation recompute (distributed.fleet.utils.recompute,
GPTConfig.use_recompute), the elastic supervisor (distributed.elastic),
and the data zoo's last sources: text (the text datasets), reader,
batch and the fluid-era dataset generators; data, ZeRO, tensor and
expert parallelism over torch.distributed (parallel.ShardedTrainStep
and the rank mesh, the collectives, spawn and launch, DataParallel, the
tensor-parallel layers, MoE, SyncBatchNorm and the fleet's collective
path); pipeline, ring / Ulysses context parallelism and the parameter
server; and the static graph (paddle.static: Program capture, the
Executor, append_backward, static.nn / amp / io, enable_static /
disable_static) with the DistributeTranspiler. A name of paddle_tpu's
top level that is not ported is absent here.
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
from .framework_io import load, save
from .ops import *  # noqa: F401,F403
from . import ops  # noqa: F401
from .ops import sum, max, min, abs, all, any, round, pow, slice  # noqa: F401,A004,E501
from .ops.extra_ops import gather_tree

from .core import anomaly, monitor
from . import (amp, distributed, incubate, inference, io, jit, metric,
               models, nn, obs, optimizer, regularizer, vision)
from . import onnx, text  # noqa: F401
from .batch import batch  # noqa: F401
from . import reader  # noqa: F401
from . import dataset  # noqa: F401
from . import hapi
from . import parallel  # noqa: F401
from .distributed.parallel import DataParallel  # noqa: F401
from .hapi import Model, callbacks, flops, summary
from .nn.layer.base import ParamAttr
from .ops.array_ops import TensorArray as LoDTensorArray
from .ops.extra_ops import register_legacy_aliases as _register_aliases

_register_aliases()

bool8 = bool_


from . import static, utils  # noqa: E402
from .static.mode import (  # noqa: E402
    disable_static, enable_static, in_dynamic_mode)
from .static.nn import create_global_var  # noqa: E402
from .static.program import create_parameter, data  # noqa: E402


def in_dygraph_mode() -> bool:
    """True unless enable_static() turned static capture on."""
    return in_dynamic_mode()


def enable_dygraph(place=None):
    """Leave static mode if it was entered (eager is the default; place
    is accepted and ignored, as in the reference)."""
    disable_static()


def disable_dygraph():
    """Enter static mode (paddle.enable_static)."""
    enable_static()


__version__ = "0.1.0"
