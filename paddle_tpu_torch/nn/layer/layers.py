"""Layer: the base of every layer of the port (↔ paddle_tpu/nn/layer/layers.py).

`Layer` is a `torch.nn.Module` that carries the `Layer` methods of Paddle
whose names torch's Module lacks: `create_parameter`, `add_parameter`,
`add_sublayer`, `sublayers`, `set_state_dict`, `clear_gradients`,
`register_forward_post_hook` and `full_name`. Where the names collide
(`parameters`, `state_dict`, `to`, `train`, `apply`), torch's stay: the
port's optimizers, steps and converters use them.

**The boundary is `__call__`.** A call whose arguments hold a Paddle
`Tensor` (also inside lists, tuples and dicts) runs the layer on their
held torch tensors and wraps the outputs back into `Tensor`s; a call with
none runs as torch's. So a nested layer always receives plain tensors from
its parent and never wraps: the models' torch code and the kernel wrappers
in `ops/` see exactly what they see without the Paddle API, and a forward
costs one scan of its arguments per layer call and nothing per op.
"""

from __future__ import annotations

import collections

import torch
from torch import nn

from ...framework.core import Parameter, Tensor

__all__ = ["Layer"]

_layer_counter = collections.defaultdict(int)


def _holds_tensor(x):
    if isinstance(x, Tensor):
        return True
    if isinstance(x, (list, tuple)):
        return any(_holds_tensor(i) for i in x)
    if isinstance(x, dict):
        return any(_holds_tensor(i) for i in x.values())
    return False


def _rebuild(x, seq):
    if isinstance(x, list):
        return seq
    return type(x)(*seq) if hasattr(x, "_fields") else type(x)(seq)


def _unwrap_all(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (list, tuple)):
        return _rebuild(x, [_unwrap_all(i) for i in x])
    if isinstance(x, dict):
        return type(x)((k, _unwrap_all(i)) for k, i in x.items())
    return x


def _wrap_all(x):
    if isinstance(x, torch.Tensor):
        return Tensor(x)
    if isinstance(x, (list, tuple)):
        return _rebuild(x, [_wrap_all(i) for i in x])
    if isinstance(x, dict):
        return type(x)((k, _wrap_all(i)) for k, i in x.items())
    return x


class Layer(nn.Module):
    """paddle.nn.Layer over torch.nn.Module (module docstring)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        cls = self.__class__.__name__.lower()
        _layer_counter[cls] += 1
        self._full_name = f"{name_scope or cls}_{_layer_counter[cls] - 1}"
        self._dtype = dtype

    def __call__(self, *args, **kwargs):
        if not (_holds_tensor(args) or _holds_tensor(kwargs)):
            return super().__call__(*args, **kwargs)
        out = super().__call__(*_unwrap_all(args), **_unwrap_all(kwargs))
        return _wrap_all(out)

    # -- Paddle's names --------------------------------------------------- #

    def full_name(self):
        return self._full_name

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A `Parameter` of `shape` on the device of this layer's first
        parameter (the default device when it has none): zeros for a bias,
        Xavier-uniform for a weight, or `default_initializer(p)`."""
        from ...device import resolve_device
        from ...tensor.creation import create_parameter

        if attr is False:
            return None
        first = next(self.parameters(), None)
        dev = first.device if first is not None else resolve_device(None)
        p = create_parameter(shape, dtype or self._dtype, attr=attr,
                             is_bias=is_bias,
                             default_initializer=default_initializer)
        return p if p.device == dev else Parameter(
            p.detach().to(dev), requires_grad=p.requires_grad, name=p.name)

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def sublayers(self, include_self=False):
        layers = list(self.modules())
        return layers if include_self else layers[1:]

    def named_sublayers(self, prefix="", include_self=False):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def register_forward_post_hook(self, hook):
        """`hook(layer, inputs, outputs)` after each forward; it may return
        replacement outputs. Returns a handle with `remove()`."""
        return self.register_forward_hook(hook)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy the entries of `state_dict` (Tensors, torch tensors or numpy
        arrays, by the `state_dict` names) into this layer's parameters and
        buffers, cast to their dtypes and onto their devices; returns
        (missing_keys, unexpected_keys). Raises on a shape mismatch."""
        import numpy as np

        from ...framework.core import _from_numpy

        own = self.state_dict(keep_vars=True)
        missing = []
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            if isinstance(src, Tensor):
                src = src._value
            elif not isinstance(src, torch.Tensor):
                src = _from_numpy(np.asarray(src))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint "
                    f"{tuple(src.shape)} vs parameter {tuple(target.shape)}")
            target.copy_(src.detach().to(device=target.device,
                                         dtype=target.dtype))
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict
