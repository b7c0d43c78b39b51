"""Statistics (↔ paddle_tpu/tensor/stat.py)."""

from __future__ import annotations

import torch

from ..framework.core import Tensor, register_tensor_method, run_op
from ._common import dims, v

__all__ = ["std", "var", "median", "nanmedian", "quantile", "nanquantile",
           "numel"]


def _f(a):
    return a if a.is_floating_point() else a.float()


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return run_op("std", lambda a: torch.std(
        _f(a), dims(a, axis), correction=1 if unbiased else 0,
        keepdim=keepdim), [x])


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return run_op("var", lambda a: torch.var(
        _f(a), dims(a, axis), correction=1 if unbiased else 0,
        keepdim=keepdim), [x])


def _ax(axis):
    return None if axis is None else int(axis)


def _quantile_fn(fn, a, q, axis, keepdim, interpolation):
    qq = torch.as_tensor(q, dtype=_f(a).dtype, device=a.device)
    if axis is None or not isinstance(axis, (list, tuple)):
        return fn(_f(a), qq, dim=_ax(axis), keepdim=keepdim,
                  interpolation=interpolation)
    d = sorted(x % a.dim() for x in axis)
    keep = [i for i in range(a.dim()) if i not in d]
    m = a.permute(keep + d).reshape([a.shape[i] for i in keep] + [-1])
    out = fn(_f(m), qq, dim=-1, keepdim=False, interpolation=interpolation)
    if keepdim:
        for i in d:
            out = out.unsqueeze(i + (1 if qq.dim() else 0))
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    def fn(a):
        if mode == "avg":
            return _quantile_fn(torch.quantile, a, 0.5, axis, keepdim, "linear")
        if axis is None:
            return torch.sort(a.reshape(-1))[0][(a.numel() - 1) // 2]
        ax = int(axis)
        out = torch.sort(a, dim=ax)[0].select(ax, (a.shape[ax] - 1) // 2)
        return out.unsqueeze(ax) if keepdim else out

    return run_op("median", fn, [x])


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    return run_op("nanmedian", lambda a: _quantile_fn(
        torch.nanquantile, a, 0.5, axis, keepdim, "linear"), [x])


def quantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    return run_op("quantile", lambda a: _quantile_fn(
        torch.quantile, a, q, axis, keepdim, interpolation), [x])


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return run_op("nanquantile", lambda a: _quantile_fn(
        torch.nanquantile, a, q, axis, keepdim, interpolation), [x])


def numel(x, name=None):
    a = v(x)
    return Tensor(torch.tensor(a.numel(), dtype=torch.int64, device=a.device))


for _name in __all__:
    register_tensor_method(_name, globals()[_name])
