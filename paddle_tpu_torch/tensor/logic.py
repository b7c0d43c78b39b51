"""Comparison and logical ops (↔ paddle_tpu/tensor/logic.py)."""

from __future__ import annotations

import torch

from ..framework.core import Tensor, register_tensor_method, run_op
from ._common import v

__all__ = [
    "equal",
    "not_equal",
    "greater_than",
    "greater_equal",
    "less_than",
    "less_equal",
    "equal_all",
    "allclose",
    "isclose",
    "logical_and",
    "logical_or",
    "logical_not",
    "logical_xor",
    "bitwise_and",
    "bitwise_or",
    "bitwise_not",
    "bitwise_xor",
    "bitwise_left_shift",
    "bitwise_right_shift",
    "is_empty",
    "is_tensor",
]


def _make(name, tfn, n=2):
    if n == 2:
        def op(x, y, name=None):
            return run_op(op.__name__, tfn, [x, y])
    else:
        def op(x, name=None):
            return run_op(op.__name__, tfn, [x])
    op.__name__ = op.__qualname__ = name
    return op


def _close_args(a, b):
    d = torch.promote_types(a.dtype, b.dtype)
    return a.to(d), b.to(d)


equal = _make("equal", torch.eq)
not_equal = _make("not_equal", torch.ne)
greater_than = _make("greater_than", torch.gt)
greater_equal = _make("greater_equal", torch.ge)
less_than = _make("less_than", torch.lt)
less_equal = _make("less_equal", torch.le)
logical_and = _make("logical_and", torch.logical_and)
logical_or = _make("logical_or", torch.logical_or)
logical_xor = _make("logical_xor", torch.logical_xor)
logical_not = _make("logical_not", torch.logical_not, n=1)
bitwise_and = _make("bitwise_and", torch.bitwise_and)
bitwise_or = _make("bitwise_or", torch.bitwise_or)
bitwise_xor = _make("bitwise_xor", torch.bitwise_xor)
bitwise_not = _make("bitwise_not", torch.bitwise_not, n=1)
bitwise_left_shift = _make("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _make("bitwise_right_shift", torch.bitwise_right_shift)


def equal_all(x, y, name=None):
    return run_op("equal_all", lambda a, b: torch.tensor(
        a.shape == b.shape and bool(torch.equal(*_close_args(a, b))),
        device=a.device), [x, y])


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return run_op("allclose", lambda a, b: torch.tensor(torch.allclose(
        *_close_args(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan),
        device=a.device), [x, y])


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return run_op("isclose", lambda a, b: torch.isclose(
        *_close_args(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan), [x, y])


def is_empty(x, name=None):
    a = v(x)
    return Tensor(torch.tensor(a.numel() == 0, device=a.device))


def is_tensor(x):
    """A Paddle `Tensor`, or a torch tensor (a `Parameter` among them)."""
    return isinstance(x, (Tensor, torch.Tensor))


for _name in __all__:
    if _name != "is_tensor":
        register_tensor_method(_name, globals()[_name])
