"""Containers (↔ paddle_tpu/nn/layer/container.py)."""

from __future__ import annotations

from torch import nn

__all__ = ["LayerList"]


class LayerList(nn.ModuleList):
    """paddle.nn.LayerList (↔ container.py:44): torch's ModuleList under
    Paddle's name; sublayers are named "0", "1", ... in both packages, so
    state_dict keys agree."""
