"""Linear and Embedding (↔ paddle_tpu/nn/layer/common.py).

Paddle's layout: `Linear.weight` is [in_features, out_features] and the
layer computes x @ W + b (`nn.functional.linear`, which casts for AMP).
Parameters are created on an explicit device and
dtype and initialised from an explicit `torch.Generator`:
`weight_std=None` keeps Paddle's default initializer (Xavier-uniform for a
Linear weight, N(0, 1) for an Embedding), a float draws N(0, weight_std)
(the GPT models' `_init_attr`). Biases start at zero.
"""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F

__all__ = ["Embedding", "Linear", "init_weight"]


def init_weight(w, std, default, generator):
    """Fill `w` in place: N(0, std) when `std` is given, else `default`
    ("xavier_uniform" | "xavier_normal" | "normal"), drawing from
    `generator` (None = torch's default generator)."""
    with torch.no_grad():
        if std is not None:
            w.normal_(0.0, std, generator=generator)
        elif default == "xavier_uniform":
            nn.init.xavier_uniform_(w, generator=generator)
        elif default == "xavier_normal":
            nn.init.xavier_normal_(w, generator=generator)
        elif default == "normal":
            w.normal_(0.0, 1.0, generator=generator)
        else:
            raise ValueError(f"unknown initializer {default!r}")
    return w


class Linear(nn.Module):
    """y = xW + b, weight stored [in_features, out_features]."""

    def __init__(self, in_features, out_features, bias_attr=None, *,
                 weight_std=None, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = nn.Parameter(init_weight(
            torch.empty(in_features, out_features, device=dev, dtype=dtype),
            weight_std, "xavier_uniform", generator))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = nn.Parameter(
                torch.zeros(out_features, device=dev, dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, out_features={self._out_features}"


class Embedding(nn.Module):
    """Token lookup table [num_embeddings, embedding_dim]."""

    def __init__(self, num_embeddings, embedding_dim, *, weight_std=None,
                 generator=None, device=None, dtype=torch.float32,
                 default_init="normal"):
        super().__init__()
        dev = resolve_device(device)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = nn.Parameter(init_weight(
            torch.empty(num_embeddings, embedding_dim, device=dev, dtype=dtype),
            weight_std, default_init, generator))

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f"num_embeddings={self._num_embeddings}, embedding_dim={self._embedding_dim}"
