"""paddle.inference, the deployment API (port of
paddle_tpu/inference/__init__.py).

`Config.enable_llm_engine(model=..., **options)` routes
`create_predictor` to the continuous-batching serving engine: it
returns a `serving.ServingPredictor` over `LLMEngine` (right-padded
`input_ids` and `prompt_lens` in, `sequences` out). The engine runs on
CUDA unless the Config asks for the CPU with `disable_gpu()`. The knob
methods of the reference's Config keep their API shape and record their
state (`summary()`), as in the reference.

Left out (ROADMAP Queue 1 item 8): the artifact `Predictor`, which the
reference builds from a serialized StableHLO program and whose port is
`torch.export`; `Predictor(config)`, `PredictorPool` and
`create_predictor` without `enable_llm_engine` raise
NotImplementedError. `capi_so_path` (the C predictor library) waits
with it.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..core.unported import not_ported

__all__ = ["Config", "Predictor", "create_predictor", "Tensor",
           "PredictorPool", "DataType", "PlaceType", "PrecisionType",
           "get_num_bytes_of_data_type"]

_ARTIFACT = "the artifact Predictor: its port over torch.export is " \
            "ROADMAP Queue 1 item 8; use Config.enable_llm_engine for " \
            "the serving engine"


class Config:
    """The reference's AnalysisConfig surface: the model files, the
    device and engine knobs, and the LLM serving switch."""

    def __init__(self, prog_file: str = None, params_file: str = None):
        # (model_dir) or (prog_file, params_file), like the reference
        self._model_dir = None
        self._prog_file = None
        self._params_file = None
        if prog_file is not None and params_file is None:
            if os.path.isdir(prog_file):
                self._model_dir = prog_file
            else:
                self._prog_file = prog_file
        else:
            self._prog_file = prog_file
            self._params_file = params_file
        # the port's entry points run on CUDA unless asked for the CPU
        self._use_gpu = True
        self._device_id = 0
        self._ir_optim = True
        self._memory_optim = True
        self._cpu_math_threads = 1
        self._enable_profile = False
        self._glog_info = True
        self._llm_engine = False
        self._llm_model = None
        self._llm_options: Dict = {}

    # --------------------------------------------------------------- model
    def set_model(self, prog_file: str, params_file: str = None):
        if params_file is None:
            self._model_dir = prog_file
        else:
            self._prog_file = prog_file
            self._params_file = params_file

    def set_prog_file(self, path: str):
        self._prog_file = path

    def set_params_file(self, path: str):
        self._params_file = path

    def model_dir(self) -> Optional[str]:
        return self._model_dir

    def prog_file(self) -> Optional[str]:
        return self._prog_file

    def params_file(self) -> Optional[str]:
        return self._params_file

    # -------------------------------------------------------------- device
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = device_id

    def disable_gpu(self):
        """Run on the CPU (the port's default is CUDA)."""
        self._use_gpu = False

    def use_gpu(self) -> bool:
        return self._use_gpu

    def enable_xpu(self, *a, **k):
        pass

    def gpu_device_id(self) -> int:
        return self._device_id

    # ------------------------------------------------------ engine options
    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = flag

    def ir_optim(self) -> bool:
        return self._ir_optim

    def enable_memory_optim(self, flag: bool = True):
        self._memory_optim = flag

    def set_cpu_math_library_num_threads(self, n: int):
        self._cpu_math_threads = n

    def enable_mkldnn(self):
        pass

    def enable_tensorrt_engine(self, *a, **k):
        raise NotImplementedError(
            "TensorRT subgraph offload is not part of this framework: "
            "the serving engine runs its own CUDA kernels")

    def enable_profile(self):
        self._enable_profile = True

    def disable_glog_info(self):
        self._glog_info = False

    def enable_llm_engine(self, model=None, **options):
        """Route create_predictor to the continuous-batching serving
        engine (inference/serving/) instead of the artifact Predictor.
        model: a models.gpt.GPT (live parameters). options: EngineConfig
        fields plus default SamplingParams fields (max_tokens,
        temperature, top_k, top_p, eos_token_id, seed, ...)."""
        self._llm_engine = True
        self._llm_model = model
        self._llm_options = dict(options)

    def llm_engine_enabled(self) -> bool:
        return self._llm_engine

    def summary(self) -> str:
        if self._llm_engine:
            prefix = "<llm serving engine>"
        else:
            prefix = self._prog_file or self._model_dir or "<no model>"
        device = f"cuda:{self._device_id}" if self._use_gpu else "cpu"
        lines = ["----- paddle_tpu_torch inference config -----",
                 f"model prefix: {prefix}",
                 f"device: {device}",
                 f"ir_optim: {self._ir_optim}",
                 f"memory_optim: {self._memory_optim}",
                 f"profiling: {self._enable_profile}"]
        if self._llm_engine:
            lines.append(f"llm engine: {self._llm_options}")
        return "\n".join(lines)


class Tensor:
    """Zero-copy-style IO handle: copy_from_cpu stages an input,
    copy_to_cpu fetches an output after run(). Holds a host array."""

    def __init__(self, name: str):
        self._name = name
        self._arr: Optional[np.ndarray] = None

    def name(self) -> str:
        return self._name

    def reshape(self, shape):
        if self._arr is not None:
            self._arr = self._arr.reshape(shape)

    def copy_from_cpu(self, data: np.ndarray):
        self._arr = np.array(data)

    def copy_to_cpu(self) -> np.ndarray:
        if self._arr is None:
            raise RuntimeError("output not populated; call predictor.run()")
        return np.asarray(self._arr)

    def shape(self):
        return list(self._arr.shape) if self._arr is not None else []

    def type(self):
        return str(self._arr.dtype) if self._arr is not None else "unset"


class Predictor:
    """The reference's artifact predictor (not ported: module
    docstring)."""

    def __init__(self, config: Config):
        not_ported("inference.Predictor", _ARTIFACT)


def create_predictor(config: Config):
    """Dispatch on the config, like the reference: enable_llm_engine()
    routes to the serving engine's ServingPredictor; anything else needs
    the artifact Predictor, which raises NotImplementedError."""
    if config.llm_engine_enabled():
        from .serving import ServingPredictor
        return ServingPredictor(config)
    return Predictor(config)


class PredictorPool:
    """A pool of artifact Predictors (raises with Predictor)."""

    def __init__(self, config: Config, size: int = 1):
        self._preds = [Predictor(config) for _ in range(size)]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]


class DataType:
    """The reference's PaddleDType enum surface."""
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6


class PlaceType:
    """The reference's PaddlePlace."""
    UNK = -1
    CPU = 0
    GPU = 1
    XPU = 2
    TPU = 2


class PrecisionType:
    """The reference's Precision."""
    Float32 = 0
    Int8 = 1
    Half = 2
    Bfloat16 = 3


_DTYPE_BYTES = {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
                DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
                DataType.BFLOAT16: 2}


def get_num_bytes_of_data_type(dtype):
    """Bytes per element of an inference DataType."""
    try:
        return _DTYPE_BYTES[dtype]
    except KeyError:
        raise ValueError(f"unknown inference DataType {dtype!r}")
