"""The tensor-op tail (↔ paddle_tpu/tensor/extras.py) and the generated
in-place `<op>_` variants, which rebind their tensor to the op's result
(`Tensor._inplace_update`)."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..framework.core import Tensor, register_tensor_method, run_op
from ..framework.dtype import default_float_dtype
from ._common import dt, v

__all__ = [
    "add_n", "as_complex", "as_real", "block_diag", "broadcast_shape",
    "cast", "cdist", "cholesky_inverse", "combinations",
    "cumulative_trapezoid", "trapezoid", "diag_embed", "diagonal",
    "diagonal_scatter", "dsplit", "hsplit", "vsplit", "tensor_split",
    "frexp", "gammaln", "gammainc", "gammaincc", "histogram_bin_edges",
    "i0e", "i1e", "index_fill", "isin", "isneginf", "isposinf", "isreal",
    "is_complex", "is_floating_point", "is_integer", "logcumsumexp",
    "lu_unpack", "masked_scatter", "matrix_transpose", "multi_dot",
    "multigammaln", "negative", "positive", "polar", "polygamma", "rank",
    "renorm", "reverse", "scatter_nd", "select_scatter", "slice_scatter",
    "sgn", "shape", "shard_index", "signbit", "sinc", "take",
    "top_p_sampling", "unflatten", "unstack", "vander",
]


def _fl(a):
    return a if a.is_floating_point() or a.is_complex() else a.to(
        default_float_dtype())


def _u(fn, name, *xs):
    return run_op(name, fn, list(xs))


# --------------------------------------------------------------------------- #
# math / special
# --------------------------------------------------------------------------- #

def add_n(inputs, name=None):
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    return run_op("add_n", lambda *vs: sum(vs[1:], vs[0]), ins)


def negative(x, name=None):
    return _u(torch.neg, "negative", x)


def positive(x, name=None):
    return _u(lambda a: a.clone(), "positive", x)


def gammaln(x, name=None):
    return _u(lambda a: torch.lgamma(_fl(a)), "gammaln", x)


def gammainc(x, y, name=None):
    return _u(lambda a, b: torch.special.gammainc(_fl(a), _fl(b)), "gammainc",
              x, y)


def gammaincc(x, y, name=None):
    return _u(lambda a, b: torch.special.gammaincc(_fl(a), _fl(b)),
              "gammaincc", x, y)


def multigammaln(x, p, name=None):
    return _u(lambda a: torch.special.multigammaln(_fl(a), int(p)),
              "multigammaln", x)


def polygamma(x, n, name=None):
    return _u(lambda a: torch.special.polygamma(int(n), _fl(a)), "polygamma", x)


def i0e(x, name=None):
    return _u(lambda a: torch.special.i0e(_fl(a)), "i0e", x)


def i1e(x, name=None):
    return _u(lambda a: torch.special.i1e(_fl(a)), "i1e", x)


def sinc(x, name=None):
    return _u(lambda a: torch.sinc(_fl(a)), "sinc", x)


def signbit(x, name=None):
    return _u(torch.signbit, "signbit", x)


def sgn(x, name=None):
    """Complex-aware sign (reference math.py sgn)."""
    return _u(torch.sgn, "sgn", x)


def frexp(x, name=None):
    def fn(a):
        m, e = torch.frexp(_fl(a))
        return m, e.to(torch.int32)

    return run_op("frexp", fn, [x])


def logcumsumexp(x, axis=None, name=None):
    def fn(a):
        a = _fl(a)
        if axis is None:
            return torch.logcumsumexp(a.reshape(-1), 0)
        return torch.logcumsumexp(a, int(axis))

    return _u(fn, "logcumsumexp", x)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return run_op("trapezoid", lambda yv, xv: torch.trapezoid(
            yv, xv, dim=axis), [y, x])
    return run_op("trapezoid", lambda yv: torch.trapezoid(
        yv, dx=1.0 if dx is None else dx, dim=axis), [y])


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return run_op("cumulative_trapezoid", lambda yv, xv:
                      torch.cumulative_trapezoid(yv, xv, dim=axis), [y, x])
    return run_op("cumulative_trapezoid", lambda yv: torch.cumulative_trapezoid(
        yv, dx=1.0 if dx is None else dx, dim=axis), [y])


def renorm(x, p, axis, max_norm, name=None):
    """Clamp the sub-tensors' p-norms along `axis` to `max_norm` (the
    reference's scale max_norm / (norm + 1e-7))."""
    def fn(a):
        m = a.movedim(axis, 0)
        flat = m.reshape(m.shape[0], -1)
        norms = torch.sum(torch.abs(flat) ** p, 1) ** (1.0 / p)
        sc = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
        return (m * sc.reshape(-1, *([1] * (m.dim() - 1)))).movedim(0, axis)

    return _u(fn, "renorm", x)


# --------------------------------------------------------------------------- #
# predicates / casting
# --------------------------------------------------------------------------- #

def cast(x, dtype):
    d = dt(dtype)
    return run_op("cast", lambda a: a.to(d), [x])


def is_complex(x):
    return v(x).is_complex()


def is_floating_point(x):
    return v(x).is_floating_point()


def is_integer(x):
    a = v(x)
    return not (a.is_floating_point() or a.is_complex() or a.dtype is torch.bool)


def isneginf(x, name=None):
    return _u(torch.isneginf, "isneginf", x)


def isposinf(x, name=None):
    return _u(torch.isposinf, "isposinf", x)


def isreal(x, name=None):
    return _u(torch.isreal, "isreal", x)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return _u(lambda a, b: torch.isin(a, b, assume_unique=assume_unique,
                                      invert=invert), "isin", x, test_x)


# --------------------------------------------------------------------------- #
# complex
# --------------------------------------------------------------------------- #

def as_complex(x, name=None):
    return _u(lambda a: torch.view_as_complex(a.contiguous()), "as_complex", x)


def as_real(x, name=None):
    return _u(lambda a: torch.view_as_real(a).clone(), "as_real", x)


def polar(abs, angle, name=None):  # noqa: A002
    return _u(torch.polar, "polar", abs, angle)


# --------------------------------------------------------------------------- #
# shapes / manipulation
# --------------------------------------------------------------------------- #

def shape(x):
    """paddle.shape: the shape as an int tensor."""
    a = v(x)
    return Tensor(torch.tensor(list(a.shape), dtype=torch.int64, device=a.device))


def rank(x):
    a = v(x)
    return Tensor(torch.tensor(a.dim(), dtype=torch.int64, device=a.device))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def matrix_transpose(x, name=None):
    return _u(lambda a: a.transpose(-1, -2), "matrix_transpose", x)


def reverse(x, axis, name=None):
    ax = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return _u(lambda a: torch.flip(a, ax), "reverse", x)


def unstack(x, axis=0, num=None, name=None):
    return list(run_op("unstack", lambda a: tuple(torch.unbind(a, axis)), [x]))


def unflatten(x, axis, shape, name=None):  # noqa: A002
    return _u(lambda a: a.unflatten(axis, tuple(shape)), "unflatten", x)


def tensor_split(x, num_or_indices, axis=0, name=None):
    arg = num_or_indices if isinstance(num_or_indices, int) else \
        [int(i) for i in num_or_indices]
    return list(run_op("tensor_split", lambda a: tuple(torch.tensor_split(
        a, arg, axis)), [x]))


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1 if v(x).dim() > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def take(x, index, mode="raise", name=None):
    """Flat-index gather; mode "raise" checks the bounds first, "wrap" wraps
    and "clip" clips (reference math.py take)."""
    a, i = v(x), v(index)
    n = a.numel()
    if mode == "raise" and i.numel() and (int(i.min()) < -n or int(i.max()) >= n):
        raise IndexError("take(): index out of range for tensor of "
                         f"{n} elements")

    def fn(a, i):
        i = i.long()
        i = i.clamp(0, n - 1) if mode == "clip" else torch.remainder(i, n)
        return a.reshape(-1)[i]

    return _u(fn, "take", x, index)


def index_fill(x, index, axis, value, name=None):
    return _u(lambda a, i: a.index_fill(axis, i.reshape(-1).long(), value),
              "index_fill", x, index)


def masked_scatter(x, mask, value, name=None):
    def fn(a, m, u):
        m = m.bool().expand(a.shape)
        return a.masked_scatter(m, u.to(a.dtype))

    return _u(fn, "masked_scatter", x, mask, value)


def scatter_nd(index, updates, shape, name=None):
    def fn(i, u):
        out = torch.zeros(tuple(shape), dtype=u.dtype, device=u.device)
        i = i.long()
        return out.index_put(tuple(i[..., k] for k in range(i.shape[-1])), u,
                             accumulate=True)

    return _u(fn, "scatter_nd", index, updates)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return _u(lambda a: torch.diag_embed(a, offset, dim1, dim2), "diag_embed", x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return _u(lambda a: torch.diagonal(a, offset, axis1, axis2).clone(),
              "diagonal", x)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return _u(lambda a, u: torch.diagonal_scatter(a, u.to(a.dtype), offset,
                                                  axis1, axis2),
              "diagonal_scatter", x, y)


def select_scatter(x, values, axis, index, name=None):
    return _u(lambda a, u: torch.select_scatter(a, u.to(a.dtype), axis, index),
              "select_scatter", x, values)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def fn(a, u):
        out = a.clone()
        sl = [slice(None)] * a.dim()
        for ax, st, en, sd in zip(axes, starts, ends, strides):
            sl[ax] = slice(st, en, sd)
        out[tuple(sl)] = u.to(a.dtype)
        return out

    return _u(fn, "slice_scatter", x, value)


def shard_index(x, index_num, nshards, shard_id, ignore_value=-1, name=None):
    size = (index_num + nshards - 1) // nshards

    def fn(a):
        return torch.where(a // size == shard_id, a % size,
                           torch.full_like(a, ignore_value))

    return _u(fn, "shard_index", x)


# --------------------------------------------------------------------------- #
# linalg tail
# --------------------------------------------------------------------------- #

def multi_dot(x, name=None):
    return run_op("multi_dot", lambda *vs: torch.linalg.multi_dot(list(vs)),
                  list(x))


def cholesky_inverse(x, upper=False, name=None):
    return _u(lambda L: torch.cholesky_inverse(L, upper=upper),
              "cholesky_inverse", x)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def fn(a, b):
        d = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.clamp(torch.sum(d * d, -1), min=0.0))
        return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)

    return _u(fn, "cdist", x, y)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(LU, pivots) -> (P, L, U)."""
    return run_op("lu_unpack", lambda lu, piv: tuple(torch.lu_unpack(
        lu, piv.to(torch.int32))), [x, y])


def vander(x, n=None, increasing=False, name=None):
    return _u(lambda a: torch.linalg.vander(a, N=n).flip(-1)
              if not increasing else torch.linalg.vander(a, N=n),
              "vander", x)


def combinations(x, r=2, with_replacement=False, name=None):
    m = v(x).shape[0]
    gen = (itertools.combinations_with_replacement if with_replacement
           else itertools.combinations)
    idx = np.asarray(list(gen(range(m), r)), np.int64).reshape(-1, r)

    def fn(a):
        return a[torch.as_tensor(idx, device=a.device)]

    return _u(fn, "combinations", x)


def block_diag(inputs, name=None):
    return run_op("block_diag", lambda *vs: torch.block_diag(*vs), list(inputs))


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    a = v(input)
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = float(a.min()), float(a.max())
    return Tensor(torch.linspace(lo, hi, int(bins) + 1, device=a.device,
                                 dtype=default_float_dtype()))


# --------------------------------------------------------------------------- #
# sampling
# --------------------------------------------------------------------------- #

def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling over logits [B, V]; returns (values, ids)."""
    from ..framework import random as rnd

    def fn(logits, p):
        probs = torch.softmax(logits.float(), -1)
        sorted_p, sort_idx = torch.sort(probs, dim=-1, descending=True,
                                        stable=True)
        cum = torch.cumsum(sorted_p, -1)
        keep = cum - sorted_p <= p.reshape(-1, 1)
        filtered = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
        filtered = filtered / filtered.sum(-1, keepdim=True)
        if seed is None:
            g = rnd.generator(logits.device)
        else:
            g = torch.Generator(device=logits.device)
            g.manual_seed(int(seed))
        choice = torch.multinomial(filtered, 1, generator=g)
        ids = torch.gather(sort_idx, -1, choice)
        return torch.gather(probs, -1, ids), ids

    return run_op("top_p_sampling", fn, [x, ps])


# --------------------------------------------------------------------------- #
# generated in-place variants (reference: the `<op>_` API family)
# --------------------------------------------------------------------------- #

_INPLACE_BASES = [
    "abs", "acos", "acosh", "add", "asin", "asinh", "atan", "atanh", "ceil",
    "clip", "cos", "cosh", "cumprod", "cumsum", "divide", "equal", "erfinv",
    "exp", "floor", "floor_divide", "frac", "gcd", "greater_equal",
    "greater_than", "lcm", "lerp", "less_equal", "less_than", "lgamma",
    "log", "log10", "log1p", "log2", "logical_and", "logical_not",
    "logical_or", "logical_xor", "logit", "mod", "multiply", "nan_to_num",
    "neg", "not_equal", "pow", "reciprocal", "remainder", "reshape",
    "round", "rsqrt", "scale", "scatter", "sigmoid", "sin", "sinh", "sqrt",
    "square", "squeeze", "subtract", "t", "tan", "tanh", "tril", "triu",
    "trunc", "unsqueeze", "where",
]


def _make_inplace(base_name, base_fn):
    def inplace(x, *args, **kwargs):
        t = x if isinstance(x, Tensor) else Tensor(v(x))
        t._check_inplace()
        out = base_fn(t, *args, **kwargs)
        return t._inplace_update(out)

    inplace.__name__ = inplace.__qualname__ = base_name + "_"
    inplace.__doc__ = (f"In-place variant of `{base_name}`: the tensor is "
                       "rebound to the result (Tensor._inplace_update).")
    return inplace


def _register_inplace(namespace: dict):
    """Make `<op>_` for every base in `namespace`; returns the new names
    (called from tensor/__init__)."""
    created = []
    for base in _INPLACE_BASES:
        fn = namespace.get(base)
        if fn is None or (base + "_") in namespace:
            continue
        inplace = _make_inplace(base, fn)
        namespace[base + "_"] = inplace
        if not hasattr(Tensor, base + "_"):
            register_tensor_method(base + "_", inplace)
        created.append(base + "_")
    return created


# Tensor methods, skipping names that would shadow a Tensor attribute
# (shape, rank, ...)
_SKIP_METHODS = {n for n in __all__ if hasattr(Tensor, n)}
for _name in list(__all__):
    if _name not in _SKIP_METHODS:
        register_tensor_method(_name, globals()[_name])
