"""Norm layers (port of paddle_tpu/nn/layer/norm.py): LayerNorm, the
batch norms (BatchNorm1D/2D/3D and the fluid-style BatchNorm), GroupNorm,
InstanceNorm1D/2D/3D, LocalResponseNorm and SpectralNorm (which backs
nn.utils.spectral_norm).

Parameter names and defaults are the JAX package's: weight ones and
bias zeros (InstanceNorm's are `scale` and `bias`), the batch norms'
buffers `_mean` (zeros) and `_variance` (ones). The fluid BatchNorm
applies `act` after the norm; its use_global_stats=False follows
train/eval mode, as the JAX package reads it. SyncBatchNorm takes its
training statistics over the data-parallel ranks
(nn.functional.sync_batch_norm); `convert_sync_batchnorm` swaps every
batch norm of a layer for one, with its weights and running stats."""
from __future__ import annotations

import math

import torch

from ...core import place as _place
from .. import functional as F
from .. import initializer as I
from ..functional.norm import batch_norm, layer_norm, sync_batch_norm
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class LayerNorm(Layer):
    """Normalizes over the trailing `normalized_shape` dims; weight ones,
    bias zeros (Paddle's defaults); weight_attr / bias_attr False drop
    them."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(shape=self._normalized_shape,
                                  attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)


class _BatchNormBase(Layer):
    """Paddle's batch norm layer: weight ones, bias zeros, buffers `_mean`
    (zeros) and `_variance` (ones), running = momentum * running +
    (1 - momentum) * batch. weight_attr / bias_attr False drop the
    parameter. use_global_stats None follows train/eval mode."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else \
            self.create_parameter(shape=[num_features], attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True)
        dev = self.weight.device if self.weight is not None else \
            _place.resolve_device(None)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    def forward(self, x):
        return batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    """The fluid-style BatchNorm(num_channels): `act` names the
    functional applied after the norm. dtype, in_place, the moving
    names, do_model_average_for_mean_and_var and trainable_statistics
    do not change the result and are accepted and ignored, as in the
    JAX package."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm (reference: operators/sync_batch_norm_op.cu,
    an NCCL all-reduce of the partial sums): in training, the statistics
    of the batch over every data-parallel rank."""

    def forward(self, x):
        return sync_batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training and not self._use_global_stats,
            momentum=self._momentum, epsilon=self._epsilon,
            data_format=self._data_format)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm replaced by a SyncBatchNorm that
        holds its weights and running statistics (a batch norm passed
        alone comes back converted)."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            w = layer.weight
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                weight_attr=None if w is not None else False,
                                bias_attr=None if layer.bias is not None
                                else False,
                                data_format=layer._data_format,
                                use_global_stats=layer._use_global_stats)
            with torch.no_grad():
                for name in ("weight", "bias"):
                    src = getattr(layer, name)
                    if src is not None:
                        getattr(new, name).data = src.detach().clone()
                new._mean.data = layer._mean.detach().clone()
                new._variance.data = layer._variance.detach().clone()
            new.train(layer.training)
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"num_channels {num_channels} is not "
                             f"divisible by num_groups {num_groups}")
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter(shape=[num_channels], attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    """weight_attr=False drops both `scale` and `bias`, as in the JAX
    package."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is False:
            self.scale = None
            self.bias = None
        else:
            self.scale = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                shape=[num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """weight / sigma, sigma its largest singular value by power
    iteration over the weight laid out [shape[axis], -1]: u and v
    (weight_u [h], weight_v [w], drawn from Normal(0, 1), no gradient)
    advance power_iters steps every forward, in place, and sigma =
    u^T W v. dtype is accepted for the reference's signature (the
    parameters take the layer's default dtype)."""

    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self._axis = axis
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[axis]
        w = math.prod(weight_shape) // h
        self.weight_u = self.create_parameter(
            shape=[h], default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            shape=[w], default_initializer=I.Normal(0.0, 1.0))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        perm = [self._axis] + [i for i in range(weight.ndim)
                               if i != self._axis]
        w = weight.permute(*perm) if self._axis != 0 else weight
        mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            u, v = self.weight_u.detach(), self.weight_v.detach()
            m = mat.detach()
            for _ in range(self._power_iters):
                v = m.t() @ u
                v = v / (torch.linalg.vector_norm(v) + self._epsilon)
                u = m @ v
                u = u / (torch.linalg.vector_norm(u) + self._epsilon)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = (mat * torch.outer(u, v)).sum()
        out = w / sigma
        if self._axis != 0:
            inv = sorted(range(len(perm)), key=perm.__getitem__)
            out = out.permute(*inv)
        return out
