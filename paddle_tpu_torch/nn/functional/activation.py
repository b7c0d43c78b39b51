"""Activations (↔ paddle_tpu/nn/functional/activation.py). Each casts its
input for AMP under the JAX package's op name."""

from __future__ import annotations

import torch

from ... import amp

__all__ = ["gelu", "relu", "silu", "tanh"]


def gelu(x, approximate=False, name=None):
    """GELU; exact erf form unless `approximate` (tanh form), as Paddle's.
    Casts for AMP as the op "gelu"."""
    (x,) = amp.cast_inputs("gelu", x)
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    (x,) = amp.cast_inputs("relu", x)
    return torch.relu(x)


def tanh(x, name=None):
    (x,) = amp.cast_inputs("tanh", x)
    return torch.tanh(x)


def silu(x, name=None):
    (x,) = amp.cast_inputs("silu", x)
    return torch.nn.functional.silu(x)
