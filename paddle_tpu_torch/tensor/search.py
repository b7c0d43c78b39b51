"""Search and sort (↔ paddle_tpu/tensor/search.py). Sorts are stable, as
the reference's; index outputs are int64 (the reference's int32, where it
narrows, framework/dtype.py)."""

from __future__ import annotations

import torch

from ..framework.core import Tensor, register_tensor_method, run_op
from ._common import dt, v

__all__ = [
    "argmax",
    "argmin",
    "argsort",
    "sort",
    "topk",
    "where",
    "nonzero",
    "searchsorted",
    "index_sample",
    "kthvalue",
    "mode",
    "masked_fill_",
    "bucketize",
]


def _arg(name, tfn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        d = dt(dtype or "int64")

        def fn(a):
            if axis is None:
                return tfn(a.reshape(-1)).to(d)
            return tfn(a, int(axis), keepdim=keepdim).to(d)

        return run_op(name, fn, [x])

    op.__name__ = op.__qualname__ = name
    return op


argmax = _arg("argmax", torch.argmax)
argmin = _arg("argmin", torch.argmin)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return run_op("argsort", lambda a: torch.sort(
        a, dim=axis, descending=descending, stable=True)[1], [x])


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return run_op("sort", lambda a: torch.sort(
        a, dim=axis, descending=descending, stable=True)[0], [x])


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    kk = int(v(k).item()) if isinstance(k, (Tensor, torch.Tensor)) else int(k)
    return run_op("topk", lambda a: tuple(torch.topk(
        a, kk, dim=axis, largest=largest, sorted=True)), [x])


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    return run_op("where", lambda c, a, b: torch.where(c.bool(), a, b),
                  [condition, x, y])


def nonzero(x, as_tuple=False):
    a = v(x)
    if as_tuple:
        return tuple(Tensor(i.unsqueeze(1)) for i in torch.nonzero(
            a, as_tuple=True))
    return Tensor(torch.nonzero(a))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return run_op("searchsorted", lambda s, u: torch.searchsorted(
        s, u.to(s.dtype) if u.dtype != s.dtype else u, out_int32=out_int32,
        right=right), [sorted_sequence, values])


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_sample(x, index):
    return run_op("index_sample", lambda a, i: torch.gather(a, 1, i.long()),
                  [x, index])


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    kk = int(k)

    def fn(a):
        ax = axis % a.dim()
        vals, idx = torch.sort(a, dim=ax, stable=True)
        vv = vals.select(ax, kk - 1)
        ii = idx.select(ax, kk - 1)
        if keepdim:
            vv, ii = vv.unsqueeze(ax), ii.unsqueeze(ax)
        return vv, ii

    return run_op("kthvalue", fn, [x])


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis` (the smallest of a tie) and the
    LAST index where it stands, as the reference's."""
    def fn(a):
        ax = axis % a.dim()
        m = a.movedim(ax, -1)
        flat = m.reshape(-1, m.shape[-1])
        srt, _ = torch.sort(flat, dim=-1)
        eq = srt.unsqueeze(-1) == srt.unsqueeze(-2)
        counts = eq.sum(-1)
        best = counts.max(-1, keepdim=True).values
        first = (counts == best).int().argmax(-1, keepdim=True)
        vals = torch.gather(srt, 1, first).squeeze(-1)
        pos = torch.arange(flat.shape[-1], device=a.device).expand_as(flat)
        hit = flat == vals.unsqueeze(-1)
        idx = torch.where(hit, pos, torch.full_like(pos, -1)).amax(-1)
        vals = vals.reshape(m.shape[:-1])
        idx = idx.reshape(m.shape[:-1])
        if keepdim:
            vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
        return vals, idx

    return run_op("mode", fn, [x])


def masked_fill_(x, mask, value, name=None):
    from .manipulation import masked_fill

    out = masked_fill(x, mask, value)
    x._inplace_update(out)
    return x


for _name in __all__:
    register_tensor_method(_name, globals()[_name])
