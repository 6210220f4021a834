"""paddle.summary / paddle.flops (port of paddle_tpu/hapi/model_summary.py;
reference: hapi/model_summary.py summary:27 and hapi/dynamic_flops.py
flops:16).

The probe forward runs in eval mode under torch.no_grad() on zeros
inputs made on the network's device; output shapes and per-layer counts
come from forward post-hooks on the leaf layers, as in the JAX module.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from ..core.dtypes import convert_dtype, get_default_dtype
from ..nn.layer.layers import Layer


def _device(net):
    p = next(iter(net.parameters()), None)
    return p.device if p is not None else torch.device("cpu")


def _leaf(layer) -> bool:
    return next(iter(layer.children()), None) is None


def _shapes(x):
    if isinstance(x, torch.Tensor):
        return list(x.shape)
    if isinstance(x, (list, tuple)):
        return [_shapes(i) for i in x]
    return []


def summary(net: Layer, input_size=None, dtypes=None, input=None):
    """reference: model_summary.py summary:27. Returns
    {'total_params': N, 'trainable_params': M} and prints the table."""
    if input is None:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        sizes = input_size if isinstance(input_size, list) and \
            isinstance(input_size[0], (list, tuple)) else [input_size]
        dts = dtypes if isinstance(dtypes, (list, tuple)) else \
            [dtypes] * len(sizes)
        dev = _device(net)
        input = [torch.zeros(
            [1 if (d is None or (isinstance(d, int) and d < 0)) else d
             for d in s],
            dtype=convert_dtype(dt) or get_default_dtype(), device=dev)
            for s, dt in zip(sizes, dts)]
    else:
        input = input if isinstance(input, (list, tuple)) else [input]

    records = OrderedDict()
    hooks = []
    counted = set()

    def register(layer, name):
        def hook(l, ins, out):
            params = 0
            trainable = 0
            for p in l._parameters.values():
                if p is None:
                    continue
                n = int(np.prod(p.shape))
                params += n
                if getattr(p, "trainable", True):
                    trainable += n
            records[name] = {
                "type": type(l).__name__,
                "output_shape": _shapes(out),
                "params": params if id(l) not in counted else 0,
                "trainable": trainable if id(l) not in counted else 0,
            }
            counted.add(id(l))
        hooks.append(layer.register_forward_post_hook(hook))

    for name, sub in net.named_sublayers(include_self=False):
        if _leaf(sub):  # leaves only, like the reference table
            register(sub, name or type(sub).__name__)
    if not hooks and _leaf(net):
        register(net, type(net).__name__)

    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*input)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()

    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if getattr(p, "trainable", True))

    line = "-" * 80
    print(line)
    print(f"{'Layer (type)':<28}{'Output Shape':<28}{'Param #':<12}")
    print("=" * 80)
    for name, r in records.items():
        print(f"{name + ' (' + r['type'] + ')':<28}"
              f"{str(r['output_shape']):<28}{r['params']:<12}")
    print("=" * 80)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print(line)
    return {"total_params": total, "trainable_params": trainable}


def flops(net: Layer, input_size, custom_ops=None, print_detail=False):
    """reference: hapi/dynamic_flops.py flops:16 — multiply-accumulate
    counts for the standard layer types via forward hooks."""
    from ..nn.layer import conv as conv_mod
    from ..nn.layer import common as common_mod

    total = [0]
    hooks = []

    def count(layer, name):
        def hook(l, ins, out):
            x = ins[0] if isinstance(ins, (list, tuple)) else ins
            cls = type(l).__name__
            if custom_ops and type(l) in custom_ops:
                total[0] += int(custom_ops[type(l)](l, ins, out))
                return
            if cls == "Linear":
                total[0] += 2 * int(np.prod(l.weight.shape)) * \
                    int(np.prod(x.shape[:-1]))
            elif cls.startswith("Conv"):
                out_el = int(np.prod(out.shape))
                k = int(np.prod(l.weight.shape[1:]))
                total[0] += 2 * out_el * k
            elif "Norm" in cls:
                total[0] += 2 * int(np.prod(x.shape))
            elif cls in ("ReLU", "GELU", "Sigmoid", "Tanh", "Softmax"):
                total[0] += int(np.prod(_flat_shape(out)))
        hooks.append(layer.register_forward_post_hook(hook))

    def _flat_shape(o):
        return o.shape if isinstance(o, torch.Tensor) else o[0].shape

    for name, sub in net.named_sublayers(include_self=True):
        if _leaf(sub):
            count(sub, name)

    sizes = input_size if isinstance(input_size[0], (list, tuple)) \
        else [input_size]
    dev = _device(net)
    inputs = [torch.zeros([1 if (d is None or d < 0) else d for d in s],
                          dtype=get_default_dtype(), device=dev)
              for s in sizes]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]
