"""Activation layers (↔ paddle_tpu/nn/layer/activation.py)."""

from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["GELU", "ReLU", "Silu", "Tanh"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class GELU(nn.Module):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Tanh(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class Silu(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)
