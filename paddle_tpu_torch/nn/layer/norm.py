"""LayerNorm, RMSNorm, the batch norms, GroupNorm, the instance norms and
SpectralNorm (↔ paddle_tpu/nn/layer/norm.py): weight starts at one and
bias at zero (Constant(1) and zeros through `Layer.create_parameter`, so
a `weight_attr` / `bias_attr` applies as on every layer, and False drops
the parameter); LayerNorm and RMSNorm go through `nn.functional`, hence
through the fused norm kernel on CUDA tensors.

The batch norms keep f32 running statistics in the buffers `_mean` (zeros)
and `_variance` (ones), the reference's names (:47-48), which
`nn.functional.batch_norm` updates in place in training (Paddle's momentum
0.9, the biased batch variance; see there). `SyncBatchNorm` takes its
batch statistics over a process group: the step's batch ranks inside a
`DistributedTrainStep` (as every batch norm there does), else the world
group when one is initialised, else this process's batch, where it equals
`BatchNorm` as the reference's does in one process.

`GroupNorm` and `InstanceNorm1D/2D/3D` (:146-189) start with the weight
at one and the bias at zero and call `nn.functional.group_norm` /
`instance_norm` (f32 statistics; plain torch ops, as the reference's are
jnp). `amp.decorate` casts their parameters under O2 as the reference's
does (it keeps only LayerNorm and the batch norms in f32); their outputs
stay f32, the ops being on AMP's black list.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D", "LayerNorm",
           "RMSNorm", "SpectralNorm", "SyncBatchNorm"]


def _unit_and_zero(layer, shape, weight_attr, bias_attr, dev, dtype):
    """(weight of ones, bias of zeros) through `create_parameter`, None
    where the attr is False."""
    kw = dict(dtype=dtype, device=dev)
    return (layer.create_parameter(shape, weight_attr,
                                   default_initializer=I.Constant(1.0), **kw),
            layer.create_parameter(shape, bias_attr, is_bias=True, **kw))


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight, self.bias = _unit_and_zero(
            self, self._normalized_shape, weight_attr, bias_attr, device,
            dtype)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        if len(normalized_shape) != 1:
            raise ValueError("RMSNorm normalizes over the last axis only")
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, weight_attr, dtype=dtype, device=device,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight, self.bias = _unit_and_zero(
            self, [num_features], weight_attr, bias_attr, dev, dtype)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCDHW"
                         else data_format, use_global_stats, name, **kw)


class SyncBatchNorm(_BatchNormBase):
    """A batch norm over the batches of a process group (module
    docstring)."""

    def forward(self, x):
        group = F.batch_stats_group()
        if group is None and torch.distributed.is_initialized():
            group = torch.distributed.group.WORLD
        with F.batch_stats_over(group):
            return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm in it (itself included) replaced by
        a SyncBatchNorm holding its parameters and statistics."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            ref = layer._mean
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon, data_format=layer._data_format,
                                device=ref.device)
            with torch.no_grad():
                for name in ("weight", "bias"):
                    if getattr(layer, name) is not None:
                        getattr(new, name).data = getattr(layer, name).detach().clone()
                new._mean.copy_(layer._mean)
                new._variance.copy_(layer._variance)
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into "
                             f"{num_groups} groups")
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight, self.bias = _unit_and_zero(
            self, [num_channels], weight_attr, bias_attr, device, dtype)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)

    def extra_repr(self):
        return (f"num_groups={self._num_groups}, "
                f"num_channels={self._num_channels}, epsilon={self._epsilon}")


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        # weight_attr=False drops both, as in the reference (:173)
        self.weight, self.bias = _unit_and_zero(
            self, [num_features], weight_attr, False if weight_attr is False
            else bias_attr, device, dtype)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class SpectralNorm(Layer):
    """weight / sigma, sigma the largest singular value of `weight` viewed
    as [weight_shape[dim], rest], estimated by `power_iters` steps of power
    iteration from the vectors `weight_u` [h] and `weight_v` [rest] (↔
    :207): parameters drawn N(0, 1) that take no gradient, and that the
    forward reads and leaves as they are."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", *, generator=None, device=None):
        super().__init__(dtype=dtype)
        self._dim, self._power_iters, self._epsilon = dim, power_iters, epsilon
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        kw = dict(default_initializer=I.Normal(0.0, 1.0), generator=generator,
                  device=device)
        self.weight_u = self.create_parameter([h], **kw)
        self.weight_v = self.create_parameter([w], **kw)
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        from ..utils import _sigma

        sigma, _, _ = _sigma(weight, self.weight_u, self.weight_v, self._dim,
                             self._power_iters, self._epsilon)
        return weight / sigma
