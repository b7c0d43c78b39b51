"""LayerNorm and RMSNorm (↔ paddle_tpu/nn/layer/norm.py): weight starts at
one and bias at zero; forward goes through `nn.functional`, hence through the
fused norm kernel on CUDA tensors."""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, device=dev, dtype=dtype)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, device=dev, dtype=dtype)))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        if len(normalized_shape) != 1:
            raise ValueError("RMSNorm normalizes over the last axis only")
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(self._normalized_shape, device=dev, dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
