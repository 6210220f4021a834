"""paddle.onnx, the ONNX export facade (port of paddle_tpu/onnx/).

Reference: python/paddle/onnx/export.py:21 delegates to the external
`paddle2onnx` package, which this framework does not have. `export`
raises NotImplementedError naming the supported way out:
paddle.jit.save writes a torch.export artifact that
paddle_tpu_torch.inference.create_predictor and jit.load serve.

Left out: nothing of the JAX package.
"""
from .export import export  # noqa: F401
