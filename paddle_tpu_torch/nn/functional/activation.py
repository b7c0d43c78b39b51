"""Activations (↔ paddle_tpu/nn/functional/activation.py)."""

from __future__ import annotations

import torch

from ... import amp

__all__ = ["gelu"]


def gelu(x, approximate=False, name=None):
    """GELU; exact erf form unless `approximate` (tanh form), as Paddle's.
    Casts for AMP as the op "gelu"."""
    (x,) = amp.cast_inputs("gelu", x)
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")
