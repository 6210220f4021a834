"""paddle.inference, the deployment API (port of
paddle_tpu/inference/__init__.py).

`Config.enable_llm_engine(model=..., **options)` routes
`create_predictor` to the continuous-batching serving engine: it
returns a `serving.ServingPredictor` over `LLMEngine` (right-padded
`input_ids` and `prompt_lens` in, `sequences` out). The engine runs on
CUDA unless the Config asks for the CPU with `disable_gpu()`. The knob
methods of the reference's Config keep their API shape and record their
state (`summary()`), as in the reference.

Otherwise `create_predictor` builds the artifact `Predictor` over the
file the Config names (`<prefix>.pdmodel`, or the first one in a model
directory), told apart as the JAX package tells them apart
(paddle_tpu/inference/__init__.py:220-232): a `.pdiparams` that is a
dict with "feed_names" is static.save_inference_model's artifact (fed
by name, fetched by name); otherwise it is jit.save's, whose state it
holds (inputs x<i>, outputs out<i>). Both are torch.export programs
that launch the port's kernels as custom ops. The Predictor runs on
CUDA (the Config's gpu_device_id) unless the Config asks for the CPU
with `disable_gpu()`; an artifact runs only on the device type it was
exported on, and a Predictor on another raises ValueError. Inputs go in
through the `Tensor` handles' copy_from_cpu (or `run(inputs)`, which
returns the outputs as arrays); outputs stay on the device until
copy_to_cpu.

Left out: `capi_so_path` (the C predictor library) raises
NotImplementedError until `native/` is ported (ROADMAP Queue 1 item 8,
*Deployment*); `clear_intermediate_tensor` and `try_shrink_memory` do
nothing, as in the JAX package.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.unported import not_ported

__all__ = ["Config", "Predictor", "create_predictor", "Tensor",
           "PredictorPool", "get_version", "DataType", "PlaceType",
           "PrecisionType", "get_num_bytes_of_data_type"]


def get_version() -> str:
    from .. import __version__
    return __version__


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

    def _artifact_prefix(self) -> str:
        if self._prog_file:
            return self._prog_file[:-len(".pdmodel")] \
                if self._prog_file.endswith(".pdmodel") else self._prog_file
        if self._model_dir:
            for name in sorted(os.listdir(self._model_dir)):
                if name.endswith(".pdmodel"):
                    return os.path.join(self._model_dir,
                                        name[:-len(".pdmodel")])
            raise ValueError(f"no .pdmodel artifact in {self._model_dir}")
        raise ValueError("Config: no model set")

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
    """Zero-copy-style IO handle (reference: ZeroCopyTensor,
    paddle_tensor.h): copy_from_cpu stages an input (a host array),
    copy_to_cpu fetches an output after run() (a device tensor until
    then)."""

    def __init__(self, name: str):
        self._name = name
        self._arr = None

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
        if torch.is_tensor(self._arr):
            t = self._arr.detach()
            return (t.float() if t.dtype == torch.bfloat16 else t).cpu() \
                .numpy()
        return np.asarray(self._arr)

    def shape(self):
        return list(self._arr.shape) if self._arr is not None else []

    def type(self):
        return str(self._arr.dtype) if self._arr is not None else "unset"


class Predictor:
    """reference: AnalysisPredictor: load an artifact, bind IO handles,
    run it (module docstring; paddle_tpu/inference/__init__.py:208-285)."""

    def __init__(self, config: Config):
        from ..core import place as _place
        self._config = config
        prefix = config._artifact_prefix()
        self._device = _place.resolve_device(
            f"cuda:{config.gpu_device_id()}" if config.use_gpu() else "cpu")
        with open(prefix + ".pdiparams", "rb") as f:
            blob = pickle.load(f)
        artifact_device = torch.device(blob["device"])
        if artifact_device.type != self._device.type:
            raise ValueError(
                f"the artifact {prefix} was exported on {artifact_device}; "
                f"this Predictor runs on {self._device} (export on the "
                "device that serves, or set the Config's device to match)")
        if "feed_names" in blob:     # static save_inference_model artifact
            from ..static.io import load_inference_model
            self._program, self._input_names, self._output_names = \
                load_inference_model(prefix)
            self._state = None
        else:                        # jit.save artifact: it holds the state
            from ..jit import _load_artifact
            exported, self._state = _load_artifact(prefix, blob)
            self._program = exported.module()
            n_inputs = sum(1 for spec in exported.graph_signature.input_specs
                           if spec.kind.name == "USER_INPUT") - sum(
                len(g) for g in self._state.values())
            self._input_names = [f"x{i}" for i in range(n_inputs)]
            self._output_names = None
        self._inputs = {n: Tensor(n) for n in self._input_names}
        self._outputs: Dict[str, Tensor] = {}

    # ------------------------------------------------------------------ io
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> Tensor:
        return self._inputs[name]

    def get_output_names(self) -> List[str]:
        if self._output_names is None:
            return [f"out{i}" for i in range(len(self._outputs))] \
                if self._outputs else ["out0"]
        return list(self._output_names)

    def get_output_handle(self, name: str) -> Tensor:
        return self._outputs[name]

    # ----------------------------------------------------------------- run
    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """reference: AnalysisPredictor::ZeroCopyRun (handle style) and
        Run(inputs) (list style, returning the outputs as arrays)."""
        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(np.asarray(a))
        args = []
        for n in self._input_names:
            h = self._inputs[n]
            if h._arr is None:
                raise RuntimeError(f"input '{n}' not set; use "
                                   "get_input_handle(name).copy_from_cpu")
            args.append(torch.from_numpy(np.array(h._arr, copy=True))
                        .to(self._device))
        with torch.no_grad():
            if self._state is not None:
                outs = self._program(self._state["params"],
                                     self._state["buffers"], *args)
            else:
                outs = self._program(*args)
        flat = [o for o in torch.utils._pytree.tree_leaves(outs)
                if torch.is_tensor(o)]
        names = self._output_names or [f"out{i}" for i in range(len(flat))]
        self._outputs = {}
        for n, a in zip(names, flat):
            t = Tensor(n)
            t._arr = a
            self._outputs[n] = t
        if inputs is not None:
            return [self._outputs[n].copy_to_cpu() for n in names]
        return None

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass


def create_predictor(config: Config):
    """reference: paddle_infer::CreatePredictor. enable_llm_engine()
    routes to the serving engine's ServingPredictor, anything else to
    the artifact Predictor."""
    if config.llm_engine_enabled():
        from .serving import ServingPredictor
        return ServingPredictor(config)
    return Predictor(config)


class PredictorPool:
    """reference: paddle_infer::services::PredictorPool."""

    def __init__(self, config: Config, size: int = 1):
        self._preds = [Predictor(config) for _ in range(size)]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]


def capi_so_path() -> str:
    """The C predictor library (reference inference/capi/pd_predictor.cc)
    waits for the port of native/ (module docstring)."""
    not_ported("inference.capi_so_path",
               "the C predictor library is built from native/, whose port "
               "is ROADMAP Queue 1 item 8 (Deployment)")


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
