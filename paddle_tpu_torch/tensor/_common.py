"""What the tensor/ modules share: the held value of an input, dtypes,
shapes and axes in Paddle's forms, the default device."""

from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.core import Tensor, _as_value


def v(x, like=None):
    """The torch tensor of a Paddle API input (a `Tensor`, a torch tensor,
    host data)."""
    return _as_value(x, like)


def dt(dtype, default=None):
    """A torch dtype for a Paddle dtype spec; None -> `default`, or the
    default float dtype."""
    if dtype is None:
        return default if default is not None else dtype_mod.default_float_dtype()
    return dtype_mod.convert_dtype(dtype)


def device():
    from ..device import resolve_device

    return resolve_device(None)


def shape_tuple(shape):
    if isinstance(shape, (Tensor, torch.Tensor)):
        shape = v(shape).tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(v(s).item()) if isinstance(s, (Tensor, torch.Tensor))
                 else int(s) for s in shape)


def axis_arg(axis):
    """None, an int or a tuple of ints, from Paddle's int / list / Tensor."""
    if axis is None:
        return None
    if isinstance(axis, (Tensor, torch.Tensor)):
        axis = v(axis).tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(a, axis):
    """torch's `dim` argument for a reduction over `axis` (None: all)."""
    ax = axis_arg(axis)
    if ax is None:
        return tuple(range(a.dim()))
    return ax if isinstance(ax, tuple) else (ax,)

