"""paddle.save and paddle.load (port of paddle_tpu/framework_io.py).

The format is the JAX package's: a pickle (protocol 4 by default) of
the saved object with every tensor replaced by a bare numpy array, in
the same nested dicts, lists and tuples. So a checkpoint moves between
the two packages in both directions: a state_dict of either package
loads into the other's model or optimizer (the port keeps the JAX
package's parameter names and accumulator keys). load() turns each
array back into a Tensor (stop_gradient True, on the default device),
or leaves it an array with return_numpy=True, and also reads the JAX
package's legacy form of a tensor, a dict {"__tensor__": True, "value":
array, "stop_gradient": ..., "name": ...}.

bfloat16: numpy has no bfloat16 type. The JAX package writes its bf16
arrays as numpy arrays of `ml_dtypes.bfloat16`, and the port writes and
reads the same (the bits move unchanged, through a uint16 view). Where
the `ml_dtypes` package is not installed, save() raises TypeError for
a bfloat16 tensor, rather than write it as another dtype, and load()
of a file holding bf16 arrays fails in the unpickler (pickle names
ml_dtypes' type). Cast such tensors (`astype("float32")`) before
saving where a machine without ml_dtypes must read the file.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .core.tensor import plain, to_tensor

__all__ = ["save", "load"]


def _bfloat16_type():
    try:
        import ml_dtypes
    except ImportError:
        return None
    return ml_dtypes.bfloat16


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = plain(t).detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bf16 = _bfloat16_type()
    if bf16 is None:
        raise TypeError(
            "paddle.save: a bfloat16 tensor needs the ml_dtypes package "
            "(numpy has no bfloat16), which is not installed; cast it to "
            "float32 first")
    return t.view(torch.int16).numpy().view(bf16)


def _to_tensor(a: np.ndarray, stop_gradient: bool = True):
    bf16 = _bfloat16_type()
    if bf16 is not None and a.dtype == bf16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
        return to_tensor(t, stop_gradient=stop_gradient)
    return to_tensor(a, stop_gradient=stop_gradient)


def _to_serializable(obj):
    if torch.is_tensor(obj):
        return _to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_serializable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_serializable(obj, return_numpy=False):
    if isinstance(obj, np.ndarray):
        return obj if return_numpy else _to_tensor(obj)
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["value"]
            t = _to_tensor(np.asarray(obj["value"]),
                           obj.get("stop_gradient", True))
            if obj.get("name") is not None:
                t.name = obj["name"]
            return t
        return {k: _from_serializable(v, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_serializable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle `obj` to `path` (its directory made if missing), tensors as
    numpy arrays."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _to_serializable(obj)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=protocol)


def load(path, **configs):
    """The object save() wrote (or the JAX package's paddle.save), arrays
    as Tensors unless configs has return_numpy=True."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_serializable(obj, configs.get("return_numpy", False))
