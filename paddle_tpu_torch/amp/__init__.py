"""Automatic mixed precision (port of paddle_tpu/amp): `auto_cast` (O1 and
O2 over the op boundary, auto_cast.py), `GradScaler` (grad_scaler.py)
and `decorate`.

`decorate` at O2 casts every floating parameter and buffer of the model
to the low-precision dtype (LayerNorm and the embeddings included, as
paddle_tpu/nn/layer/layers.py:329-340 does) and turns on the
optimizer's float32 master weights; `master_weight` overrides that
choice (the reference's default: on for O2, off for O1). O1 leaves the
model as it is: auto_cast does the casting. save_dtype is accepted and
ignored, as in the reference."""
from __future__ import annotations

from ..core.dtypes import convert_dtype
from .auto_cast import amp_guard, auto_cast, black_list, white_list
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["decorate", "auto_cast", "amp_guard", "white_list", "black_list",
           "GradScaler", "AmpScaler"]


def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    if level not in ("O1", "O2"):
        raise ValueError(f"level {level!r}: expected 'O1' or 'O2'")
    if level == "O2" and models is not None:
        for m in (models if isinstance(models, (list, tuple))
                  else [models]):
            m.to(dtype=convert_dtype(dtype))
    if optimizers is not None:
        for o in (optimizers if isinstance(optimizers, (list, tuple))
                  else [optimizers]):
            o._multi_precision = (master_weight if master_weight is not None
                                  else level == "O2")
    if optimizers is None:
        return models
    return models, optimizers
