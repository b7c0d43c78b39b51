"""Layer: the base of every layer of the port (↔ paddle_tpu/nn/layer/layers.py).

`ParamAttr` bundles what Paddle attaches to a parameter at its creation:
its name, its initializer, its learning-rate factor, its regularizer,
whether it trains and whether the gradient clip reads it.
`Layer.create_parameter` applies one: the parameter gets
`optimize_attr["learning_rate"]` (the optimizers scale their rate by it),
`regularizer` (added to its gradient before the clip), `need_clip` and
`trainable`. Its initializer is `attr.initializer`, else the layer's
default (`default_initializer`), else zeros for a bias and Xavier-uniform
for a weight. Paddle reads the attribute's initializer first; the JAX
package's `create_parameter` reads the layer's default first, so a
LayerNorm given `ParamAttr(initializer=...)` keeps its ones there
(ROADMAP queue C).

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
from .. import initializer as I

__all__ = ["Layer", "ParamAttr"]


class ParamAttr:
    """A parameter's attributes (module docstring; ↔ :26)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """A ParamAttr from None (the defaults), a ParamAttr, a name, an
        initializer, or False (no parameter: False back)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"cannot interpret {attr!r} as ParamAttr")


def set_param_attr(p, attr):
    """Give parameter p what `attr` (a `ParamAttr`) attaches: its
    learning-rate factor, regularizer, clipping, trainability and (when
    set) its name; returns p."""
    p.optimize_attr["learning_rate"] = attr.learning_rate
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    p.trainable = attr.trainable
    if attr.name is not None:
        p.name = attr.name
    return p


def make_parameter(shape, attr=None, dtype=torch.float32, is_bias=False,
                   default_initializer=None, *, generator=None, device=None):
    """A `Parameter` of `shape` on `device` with `attr` applied (module
    docstring), or None when `attr` is False; its random draws come from
    `generator` (None: the port's generator of the device)."""
    from ...device import resolve_device

    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    p = Parameter(torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                              device=resolve_device(device)))
    init = attr.initializer or default_initializer or (
        I.Constant(0.0) if is_bias else I.XavierUniform())
    init(p, generator=generator)
    return set_param_attr(p, attr)

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
                         default_initializer=None, *, generator=None,
                         device=None):
        """`make_parameter` in `dtype` (the layer's by default) on `device`,
        by default the device of this layer's first parameter (the default
        device when it has none)."""
        from ...framework.dtype import convert_dtype

        if device is None:
            first = next(self.parameters(), None)
            device = first.device if first is not None else None
        return make_parameter(shape, attr, convert_dtype(dtype or self._dtype),
                              is_bias, default_initializer,
                              generator=generator, device=device)

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
