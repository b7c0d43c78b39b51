"""Shape and layout manipulation (↔ paddle_tpu/tensor/manipulation.py).

Paddle's meanings where torch's differ: `split(x, 2)` is two sections,
`transpose(x, perm)` a permutation, `flatten(x, start_axis, stop_axis)`,
`squeeze(x, axis)` skips axes that are not 1, `expand` takes -1 for a kept
dim, `pad` with fewer widths than dims pads the trailing (NC*) or the
leading spatial dims. Ops whose output shape depends on the data
(`masked_select`, `unique`, `unique_consecutive`) read the data once, as
the reference reads it on the host.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework.core import Tensor, register_tensor_method, run_op
from ._common import dt, shape_tuple, v

__all__ = [
    "reshape",
    "flatten",
    "transpose",
    "t",
    "moveaxis",
    "swapaxes",
    "squeeze",
    "unsqueeze",
    "concat",
    "stack",
    "hstack",
    "vstack",
    "dstack",
    "split",
    "chunk",
    "unbind",
    "tile",
    "expand",
    "expand_as",
    "broadcast_to",
    "broadcast_tensors",
    "flip",
    "rot90",
    "roll",
    "gather",
    "gather_nd",
    "scatter",
    "scatter_nd_add",
    "index_select",
    "index_add",
    "index_put",
    "take_along_axis",
    "put_along_axis",
    "masked_select",
    "masked_fill",
    "slice",
    "strided_slice",
    "pad",
    "repeat_interleave",
    "unique",
    "unique_consecutive",
    "flatten_",
    "as_strided",
    "view",
    "view_as",
    "unfold",
    "tensordot",
    "atleast_1d",
    "atleast_2d",
    "atleast_3d",
    "tolist",
    "crop",
]


def _int(x):
    return int(v(x).item()) if isinstance(x, (Tensor, torch.Tensor)) else int(x)


def _ints(seq):
    if isinstance(seq, (Tensor, torch.Tensor)):
        return [int(s) for s in v(seq).tolist()]
    return [_int(s) for s in seq]


def reshape(x, shape, name=None):
    shp = shape_tuple(shape)
    return run_op("reshape", lambda a: a.reshape(shp), [x])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(a):
        if a.dim() == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis % a.dim(), stop_axis % a.dim())

    return run_op("flatten", fn, [x])


flatten_ = flatten


def transpose(x, perm=None, name=None):
    def fn(a):
        p = tuple(range(a.dim() - 1, -1, -1)) if perm is None else \
            tuple(int(i) for i in perm)
        return a.permute(p)

    return run_op("transpose", fn, [x])


def t(x, name=None):
    a = v(x)
    if a.dim() < 2:
        return x if isinstance(x, Tensor) else Tensor(a)
    return run_op("t", lambda a: a.transpose(-1, -2), [x])


def moveaxis(x, source, destination, name=None):
    return run_op("moveaxis", lambda a: torch.movedim(a, source, destination),
                  [x])


def swapaxes(x, axis1, axis2, name=None):
    return run_op("swapaxes", lambda a: a.transpose(axis1, axis2), [x])


def squeeze(x, axis=None, name=None):
    if isinstance(axis, (Tensor, torch.Tensor)):
        axis = v(axis).tolist()

    def fn(a):
        if axis is None:
            return a.squeeze()
        ax = axis if isinstance(axis, (list, tuple)) else (axis,)
        ax = tuple(int(i) % builtins.max(a.dim(), 1) for i in ax)
        ax = tuple(i for i in ax if a.dim() and a.shape[i] == 1)
        return a.squeeze(ax) if ax else a.view(a.shape)

    return run_op("squeeze", fn, [x])


def unsqueeze(x, axis, name=None):
    if isinstance(axis, (Tensor, torch.Tensor)):
        axis = v(axis).tolist()
    ax = tuple(int(a) for a in axis) if isinstance(axis, (list, tuple)) \
        else (int(axis),)

    def fn(a):
        out = a
        for i in ax:
            out = out.unsqueeze(i)
        return out

    return run_op("unsqueeze", fn, [x])


def _promoted(vs):
    d = vs[0].dtype
    for a in vs[1:]:
        d = torch.promote_types(d, a.dtype)
    return [a.to(d) for a in vs]


def concat(x, axis=0, name=None):
    ax = _int(axis)
    return run_op("concat", lambda *vs: torch.cat(_promoted(vs), ax), list(x))


def stack(x, axis=0, name=None):
    ax = int(axis)
    return run_op("stack", lambda *vs: torch.stack(_promoted(vs), ax), list(x))


def hstack(x, name=None):
    return run_op("hstack", lambda *vs: torch.hstack(_promoted(vs)), list(x))


def vstack(x, name=None):
    return run_op("vstack", lambda *vs: torch.vstack(_promoted(vs)), list(x))


def dstack(x, name=None):
    return run_op("dstack", lambda *vs: torch.dstack(_promoted(vs)), list(x))


def split(x, num_or_sections, axis=0, name=None):
    """Paddle's split: an int is the NUMBER of equal sections (it must
    divide the dim), a list the section sizes (one may be -1)."""
    a = v(x)
    ax = _int(axis) % builtins.max(a.dim(), 1)
    dim = a.shape[ax]
    if isinstance(num_or_sections, (int, np.integer)):
        n = int(num_or_sections)
        if dim % n != 0:
            raise ValueError(
                f"split: dimension {ax} of size {dim} is not divisible by "
                f"num={n}; pass explicit section sizes instead")
        sections = [dim // n] * n
    else:
        sections = _ints(num_or_sections)
        if builtins.any(s < 0 for s in sections):
            known = builtins.sum(s for s in sections if s >= 0)
            sections = [s if s >= 0 else dim - known for s in sections]
    return list(run_op("split", lambda a: tuple(torch.split(a, sections, ax)),
                       [x]))


def chunk(x, chunks, axis=0, name=None):
    a = v(x)
    n = int(chunks)
    ax = int(axis) % builtins.max(a.dim(), 1)
    dim = a.shape[ax]
    if dim % n == 0:
        return split(x, n, ax)
    size = -(-dim // n)
    sections = []
    left = dim
    while left > 0:
        sections.append(builtins.min(size, left))
        left -= size
    return split(x, sections, ax)


def unbind(x, axis=0, name=None):
    return list(run_op("unbind", lambda a: tuple(torch.unbind(a, axis)), [x]))


def tile(x, repeat_times, name=None):
    reps = tuple(_ints(repeat_times))
    return run_op("tile", lambda a: torch.tile(a, reps), [x])


def expand(x, shape, name=None):
    shp = shape_tuple(shape)

    def fn(a):
        lead = len(shp) - a.dim()
        tgt = tuple(a.shape[i - lead] if s == -1 else s
                    for i, s in enumerate(shp))
        return a.expand(tgt)

    return run_op("expand", fn, [x])


def expand_as(x, y, name=None):
    return expand(x, list(v(y).shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(run_op("broadcast_tensors",
                       lambda *vs: tuple(torch.broadcast_tensors(*vs)),
                       list(inputs)))


def flip(x, axis, name=None):
    ax = [axis] if isinstance(axis, int) else list(axis)
    return run_op("flip", lambda a: torch.flip(a, ax), [x])


def rot90(x, k=1, axes=(0, 1), name=None):
    return run_op("rot90", lambda a: torch.rot90(a, k, list(axes)), [x])


def roll(x, shifts, axis=None, name=None):
    if isinstance(shifts, (Tensor, torch.Tensor)):
        shifts = v(shifts).tolist()

    def fn(a):
        if axis is None:
            return torch.roll(a, shifts)
        return torch.roll(a, shifts, axis)

    return run_op("roll", fn, [x])


def gather(x, index, axis=0, name=None):
    ax = _int(axis)
    return run_op("gather", lambda a, i: torch.index_select(
        a, ax, i.reshape(-1).long()), [x, index])


def _nd_index(i):
    i = i.long()
    return tuple(i[..., k] for k in range(i.shape[-1]))


def gather_nd(x, index, name=None):
    return run_op("gather_nd", lambda a, i: a[_nd_index(i)], [x, index])


def scatter(x, index, updates, overwrite=True, name=None):
    def fn(a, i, u):
        i = i.reshape(-1).long()
        u = u.to(a.dtype)
        if overwrite:
            return a.index_put((i,), u)
        z = a.index_put((i,), torch.zeros_like(u))
        return z.index_put((i,), u, accumulate=True)

    return run_op("scatter", fn, [x, index, updates])


def scatter_nd_add(x, index, updates, name=None):
    return run_op("scatter_nd_add", lambda a, i, u: a.index_put(
        _nd_index(i), u.to(a.dtype), accumulate=True), [x, index, updates])


def index_select(x, index, axis=0, name=None):
    ax = int(axis)
    return run_op("index_select", lambda a, i: torch.index_select(
        a, ax, i.reshape(-1).long()), [x, index])


def index_add(x, index, axis, value, name=None):
    ax = int(axis)
    return run_op("index_add", lambda a, i, u: torch.index_add(
        a, ax % a.dim(), i.reshape(-1).long(), u.to(a.dtype)),
        [x, index, value])


def index_put(x, indices, value, accumulate=False, name=None):
    def fn(a, u, *idx):
        idx = tuple(i if i.dtype is torch.bool else i.long() for i in idx)
        return a.index_put(idx, u.to(a.dtype), accumulate=accumulate)

    return run_op("index_put", fn, [x, value, *indices])


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    ax = int(axis)
    return run_op("take_along_axis", lambda a, i: torch.take_along_dim(
        a, i.long(), ax), [arr, indices])


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):  # noqa: A002
    ax = int(axis)

    def fn(a, i, u):
        i = i.long()
        u = u.to(a.dtype).expand(i.shape)
        if reduce == "assign":
            return a.scatter(ax, i, u)
        if reduce == "add":
            return a.scatter_add(ax, i, u)
        if reduce in ("mul", "multiply"):
            return a * torch.ones_like(a).scatter(ax, i, u)
        raise ValueError(f"unsupported reduce mode {reduce}")

    return run_op("put_along_axis", fn, [arr, indices, values])


def masked_select(x, mask, name=None):
    return run_op("masked_select", lambda a, m: a[m.bool()], [x, mask])


def masked_fill(x, mask, value, name=None):
    if isinstance(value, (Tensor, torch.Tensor)):
        return run_op("masked_fill", lambda a, m, u: torch.where(
            m.bool(), u.to(a.dtype), a), [x, mask, value])
    return run_op("masked_fill", lambda a, m: a.masked_fill(m.bool(), value),
                  [x, mask])


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    axes = [int(a) for a in axes]
    starts, ends = _ints(starts), _ints(ends)

    def fn(a):
        idx = [builtins.slice(None)] * a.dim()
        for ax, st, en in zip(axes, starts, ends):
            d = a.shape[ax]
            st2 = builtins.max(st + d, 0) if st < 0 else builtins.min(st, d)
            en2 = builtins.max(en + d, 0) if en < 0 else builtins.min(en, d)
            idx[ax] = builtins.slice(st2, builtins.max(en2, st2))
        return a[tuple(idx)]

    return run_op("slice", fn, [x])


def strided_slice(x, axes, starts, ends, strides, name=None):
    axes = [int(a) for a in axes]
    starts, ends, strides_ = _ints(starts), _ints(ends), _ints(strides)

    def fn(a):
        out = a
        for ax, st, en, sd in zip(axes, starts, ends, strides_):
            d = a.shape[ax]
            rng = range(d)[builtins.slice(st, en, sd)]
            idx = torch.tensor(list(rng), dtype=torch.long, device=a.device)
            out = out.index_select(ax, idx)
        return out

    return run_op("strided_slice", fn, [x])


def pad_values(a, pad, mode="constant", value=0.0, data_format="NCHW"):  # noqa: A002
    """`pad` on torch tensor a (widths for every dim, or pairs for the
    spatial dims of `data_format`, the first pair the first spatial dim)."""
    widths_flat = _ints(pad)
    nd = a.dim()
    if len(widths_flat) == 2 * nd:
        widths = [(widths_flat[2 * i], widths_flat[2 * i + 1])
                  for i in range(nd)]
    else:
        n_sp = len(widths_flat) // 2
        widths = [(0, 0)] * nd
        dims_ = range(nd - n_sp, nd) if data_format.startswith("NC") \
            else range(1, 1 + n_sp)
        for k, d in enumerate(dims_):
            widths[d] = (widths_flat[2 * k], widths_flat[2 * k + 1])
    if mode == "constant":
        tp = [w for pair in reversed(widths) for w in pair]
        return torch.nn.functional.pad(a, tp, mode="constant", value=value)
    # torch pads the trailing dims of a batched input in the other
    # modes: move the padded dims last, one at a time
    out = a
    tmode = {"reflect": "reflect", "replicate": "replicate",
             "circular": "circular"}[mode]
    for d, (lo, hi) in enumerate(widths):
        if lo == 0 and hi == 0:
            continue
        m = out.movedim(d, -1)
        shp = m.shape
        m = m.reshape(1, -1, shp[-1])
        m = torch.nn.functional.pad(m, (lo, hi), mode=tmode)
        out = m.reshape(*shp[:-1], m.shape[-1]).movedim(-1, d)
    return out


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):  # noqa: A002
    return run_op("pad", lambda a: pad_values(a, pad, mode, value,
                                              data_format), [x])


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, (Tensor, torch.Tensor)):
        return run_op("repeat_interleave", lambda a, r: torch.repeat_interleave(
            a, r.long(), axis), [x, repeats])
    return run_op("repeat_interleave", lambda a: torch.repeat_interleave(
        a, int(repeats), axis), [x])


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    d = dt(dtype)
    a = v(x)
    arr = a.detach().cpu().numpy() if a.dtype is not torch.bfloat16 else \
        a.detach().float().cpu().numpy()
    vals, idx, inv, cnt = np.unique(arr, return_index=True,
                                    return_inverse=True, return_counts=True,
                                    axis=axis)

    def back(n):
        return torch.as_tensor(n.reshape(n.shape)).to(a.device)

    outs = [Tensor(back(vals).to(a.dtype))]
    if return_index:
        outs.append(Tensor(back(idx).to(d)))
    if return_inverse:
        outs.append(Tensor(back(inv.reshape(-1) if axis is None else inv).to(d)))
    if return_counts:
        outs.append(Tensor(back(cnt).to(d)))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None,
                       dtype="int64", name=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis is not "
                                  "supported yet (as in the reference)")
    d = dt(dtype)
    a = v(x).reshape(-1)
    vals, inv, cnt = torch.unique_consecutive(a, return_inverse=True,
                                              return_counts=True)
    outs = [Tensor(vals)]
    if return_inverse:
        outs.append(Tensor(inv.to(d)))
    if return_counts:
        outs.append(Tensor(cnt.to(d)))
    return outs[0] if len(outs) == 1 else tuple(outs)


def as_strided(x, shape, stride, offset=0, name=None):
    shp = shape_tuple(shape)
    st = tuple(int(s) for s in stride)
    return run_op("as_strided", lambda a: torch.as_strided(
        a.contiguous(), shp, st, int(offset)).clone(), [x])


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    d = dt(shape_or_dtype)
    return run_op("view", lambda a: a.to(d), [x])


def view_as(x, other, name=None):
    return reshape(x, list(v(other).shape))


def unfold(x, axis, size, step, name=None):
    return run_op("unfold", lambda a: a.unfold(int(axis), int(size), int(step)),
                  [x])


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (Tensor, torch.Tensor)):
        axes = v(axes).tolist()

    def fn(a, b):
        d = torch.promote_types(a.dtype, b.dtype)
        return torch.tensordot(a.to(d), b.to(d), dims=axes)

    return run_op("tensordot", fn, [x, y])


def _as_tensor(x):
    return x if isinstance(x, Tensor) else Tensor(v(x))


def atleast_1d(*inputs, name=None):
    outs = [reshape(a, [1]) if v(a).dim() == 0 else _as_tensor(a)
            for a in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = []
    for a in inputs:
        a = _as_tensor(a)
        while a.ndim < 2:
            a = unsqueeze(a, 0)
        outs.append(a)
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = []
    for a in inputs:
        a = _as_tensor(a)
        while a.ndim < 3:
            a = unsqueeze(a, -1) if a.ndim >= 2 else unsqueeze(a, 0)
        outs.append(a)
    return outs[0] if len(outs) == 1 else outs


def tolist(x):
    return _as_tensor(x).numpy().tolist()


def crop(x, shape=None, offsets=None, name=None):
    a = v(x)
    shp = shape_tuple(shape) if shape is not None else tuple(a.shape)
    offs = [0] * a.dim() if offsets is None else _ints(offsets)
    ends = [o + (s if s != -1 else a.shape[i] - o)
            for i, (o, s) in enumerate(zip(offs, shp))]
    return slice(x, list(range(a.dim())), offs, ends)


for _name in __all__:
    if _name not in ("slice",):
        register_tensor_method(_name, globals()[_name])
