"""Containers (↔ paddle_tpu/nn/layer/container.py)."""

from __future__ import annotations

import collections

from torch import nn
from .layers import Layer

__all__ = ["LayerDict", "LayerList", "ParameterList", "Sequential"]


class LayerList(nn.ModuleList, Layer):
    """paddle.nn.LayerList (↔ container.py:44): torch's ModuleList under
    Paddle's name; sublayers are named "0", "1", ... in both packages, so
    state_dict keys agree."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class LayerDict(nn.ModuleDict, Layer):
    """paddle.nn.LayerDict (↔ container.py:89): torch's ModuleDict under
    Paddle's name, sublayers named by their keys in insertion order; also
    takes (key, layer) pairs."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def update(self, sublayers):
        if isinstance(sublayers, dict):
            sublayers = sublayers.items()
        for key, layer in sublayers:
            self.add_module(str(key), layer)


class ParameterList(nn.ParameterList, Layer):
    """paddle.nn.ParameterList (↔ container.py:136): parameters named "0",
    "1", ..., as in the reference."""

    def __init__(self, parameters=None):
        super().__init__(parameters)


class Sequential(nn.Sequential, Layer):
    """paddle.nn.Sequential (↔ container.py:13): layers named "0", "1", ...,
    or by the keys of one OrderedDict, or by the names of (name, layer)
    pairs; called in order."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)
