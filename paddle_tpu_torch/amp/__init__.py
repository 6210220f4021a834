"""Automatic mixed precision: `decorate` (port of paddle_tpu/amp/
__init__.py:19-39).

O2 casts every floating parameter and buffer of the model to the low
precision dtype (LayerNorm and the embeddings included, as
paddle_tpu/nn/layer/layers.py:329-340 does) and turns on the
optimizer's f32 master weights; O1 leaves the model as it is and master
weights off (auto_cast, which O1 relies on, is not ported yet, nor is
GradScaler)."""
from __future__ import annotations

import torch

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16"):
    if level not in ("O1", "O2"):
        raise ValueError(f"level {level!r}: expected 'O1' or 'O2'")
    if level == "O2" and models is not None:
        tdtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        for m in (models if isinstance(models, (list, tuple))
                  else [models]):
            m.to(dtype=tdtype)
    if optimizers is not None:
        for o in (optimizers if isinstance(optimizers, (list, tuple))
                  else [optimizers]):
            o._multi_precision = level == "O2"
    if optimizers is None:
        return models
    return models, optimizers
