"""Tensor creation (↔ paddle_tpu/tensor/creation.py). New tensors land on
the default device (`get_device()`); Python ints make int64 tensors (the
reference narrows them to int32, framework/dtype.py)."""

from __future__ import annotations

import numpy as np
import torch

from ..framework.core import Tensor, run_op, to_tensor
from ._common import device, dt, shape_tuple, v

__all__ = [
    "to_tensor",
    "zeros",
    "zeros_like",
    "ones",
    "ones_like",
    "full",
    "full_like",
    "empty",
    "empty_like",
    "arange",
    "linspace",
    "logspace",
    "eye",
    "diag",
    "diagflat",
    "meshgrid",
    "tril",
    "triu",
    "assign",
    "clone",
    "create_parameter",
]


def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(shape_tuple(shape), dtype=dt(dtype), device=device()))


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(shape_tuple(shape), dtype=dt(dtype), device=device()))


def _fill_dtype(fill_value, dtype):
    if dtype is not None:
        return dt(dtype)
    if isinstance(fill_value, bool):
        return torch.bool
    if isinstance(fill_value, (int, np.integer)):
        return torch.int64
    return dt(None)


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, (Tensor, torch.Tensor)):
        fill_value = v(fill_value).item()
    return Tensor(torch.full(shape_tuple(shape), fill_value,
                             dtype=_fill_dtype(fill_value, dtype),
                             device=device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(x, dtype):
    a = v(x)
    return a, (a.dtype if dtype is None else dt(dtype))


def zeros_like(x, dtype=None, name=None):
    a, d = _like(x, dtype)
    return Tensor(torch.zeros(a.shape, dtype=d, device=a.device))


def ones_like(x, dtype=None, name=None):
    a, d = _like(x, dtype)
    return Tensor(torch.ones(a.shape, dtype=d, device=a.device))


def full_like(x, fill_value, dtype=None, name=None):
    a, d = _like(x, dtype)
    if isinstance(fill_value, (Tensor, torch.Tensor)):
        fill_value = v(fill_value).item()
    return Tensor(torch.full(a.shape, fill_value, dtype=d, device=a.device))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = (v(b).item() if isinstance(b, (Tensor, torch.Tensor))
                        else b for b in (start, end, step))
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(b, (int, np.integer)) for b in (start, end, step))
        d = torch.int64 if ints else dt(None)
    else:
        d = dt(dtype)
    return Tensor(torch.arange(start, end, step, dtype=d, device=device()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor(torch.linspace(float(start), float(stop), int(num),
                                 dtype=dt(dtype), device=device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor(torch.logspace(float(start), float(stop), int(num),
                                 base=float(base), dtype=dt(dtype),
                                 device=device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return Tensor(torch.eye(n, m, dtype=dt(dtype), device=device()))


def diag(x, offset=0, padding_value=0, name=None):
    def fn(a):
        if a.dim() == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                mask = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
                out = torch.where(mask, out, torch.full_like(out, padding_value))
            return out
        return torch.diagonal(a, offset).clone()

    return run_op("diag", fn, [x])


def diagflat(x, offset=0, name=None):
    return run_op("diagflat", lambda a: torch.diagflat(a, offset), [x])


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    outs = run_op("meshgrid",
                  lambda *vs: tuple(torch.meshgrid(*vs, indexing="ij")),
                  list(args))
    return list(outs)


def tril(x, diagonal=0, name=None):
    return run_op("tril", lambda a: torch.tril(a, diagonal), [x])


def triu(x, diagonal=0, name=None):
    return run_op("triu", lambda a: torch.triu(a, diagonal), [x])


def assign(x, output=None):
    out = run_op("assign", torch.clone, [x])
    if output is not None:
        output._inplace_update(out)
        return output
    return out


def clone(x, name=None):
    return assign(x)


def create_parameter(shape, dtype=None, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A `Parameter` on the default device with `attr` (a `ParamAttr`, a
    name, an initializer, or None) applied as `Layer.create_parameter`
    applies it; without an initializer, zeros for a bias and
    Xavier-uniform over fans (shape[0], shape[-1]) for a weight (the
    reference's rule, :197-201), drawn from the port's generator."""
    from ..nn import initializer as I
    from ..nn.layer.layers import ParamAttr, make_parameter

    shp = shape_tuple(shape)
    if default_initializer is None and not is_bias:
        default_initializer = I.XavierUniform(
            fan_in=shp[0] if shp else 1, fan_out=shp[-1] if shp else 1)
    attr = ParamAttr._to_attr(attr)
    if attr is not False and name is not None:
        attr = ParamAttr(name, attr.initializer, attr.learning_rate,
                         attr.regularizer, attr.trainable, attr.need_clip)
    return make_parameter(shp, attr, dt(dtype), is_bias, default_initializer,
                          device=device())
