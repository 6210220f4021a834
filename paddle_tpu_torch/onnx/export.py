"""ONNX export raises (reference onnx/export.py delegates to the external
paddle2onnx package; port of paddle_tpu/onnx/export.py)."""
from __future__ import annotations


def export(layer, path, input_spec=None, opset_version=9, **configs):
    raise NotImplementedError(
        "ONNX export is not supported: the reference implementation "
        "delegates to the external `paddle2onnx` package "
        "(reference onnx/export.py:21), which is not available here. Use "
        "paddle.jit.save(layer, path, input_spec) to write the port's "
        "torch.export artifact, served by "
        "paddle_tpu_torch.inference.create_predictor or jit.load.")
