"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The package mirrors paddle_tpu's layout (paddle_tpu/X/y.py ports to
paddle_tpu_torch/X/y.py) and keeps its parameter names and layouts, so
a parameter dict moves between the two packages unchanged. Hand-written
Hopper kernels live in ops/kernels/, each beside a plain PyTorch version
of the same math.

Entry points run on CUDA unless the caller passes device="cpu"; without
a GPU and without that argument they raise (core/place.py).

Slice 1 ports the serving path: models/gpt.py, models/generation.py
and inference/serving/ (paged KV cache, scheduler, fused decode chunk,
LLMEngine) over the ragged paged-attention kernel. Slice 2 ports the
GPT train step: nn/ (layers, functionals, fused cross-entropy, global-
norm clip), distributed/tp_layers.py, optimizer/ (AdamW with master
weights), amp.decorate, jit.TrainStep and the training side of
models/gpt.py, over the flash-attention kernels K1 and K2. Slice 3
ports the ResNet-50 train step: conv2d, pooling, Paddle's batch norm
(fused BN + ReLU route, f32 running stats under O2), vision/models/
resnet.py and Momentum, beside kernel K4 (fused BN-apply + ReLU into a
1x1 convolution) at the block boundaries.
"""
from .core.place import resolve_device

__all__ = ["resolve_device"]
