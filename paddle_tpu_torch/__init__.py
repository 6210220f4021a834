"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The package mirrors paddle_tpu's layout (paddle_tpu/X/y.py ports to
paddle_tpu_torch/X/y.py) and keeps its parameter names and layouts, so
a parameter dict moves between the two packages unchanged. Hand-written
Hopper kernels live in ops/kernels/, each beside a plain PyTorch version
of the same math.

Entry points run on CUDA unless the caller passes device="cpu"; without
a GPU and without that argument they raise (core/place.py).

This slice ports the serving path: models/gpt.py, models/generation.py
and inference/serving/ (paged KV cache, scheduler, fused decode chunk,
LLMEngine) over the ragged paged-attention kernel.
"""
from .core.place import resolve_device

__all__ = ["resolve_device"]
