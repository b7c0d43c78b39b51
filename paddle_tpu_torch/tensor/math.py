"""Math: elementwise unary and binary ops, reductions, cumulative ops and
the operators of `Tensor` (↔ paddle_tpu/tensor/math.py), as torch ops."""

from __future__ import annotations

import builtins

import torch

from ..framework.core import Tensor, register_tensor_method, run_op
from ._common import dims, dt, v

__all__ = []  # filled below


def _export(name, fn):
    __all__.append(name)
    globals()[name] = fn
    return fn


def _floated(fn):
    """fn on a float tensor: an integer or bool input goes to the default
    float dtype first (as jnp's transcendental functions promote)."""
    def op(a, *rest):
        if not (a.is_floating_point() or a.is_complex()):
            a = a.to(dt(None))
        return fn(a, *rest)

    return op


def _same_dtype(fn):
    """fn on two tensors brought to their common dtype first."""
    def op(a, b):
        d = torch.result_type(a, b)
        return fn(a.to(d), b.to(d))

    return op


# --------------------------------------------------------------------------- #
# unary elementwise
# --------------------------------------------------------------------------- #

def _make_unary(name, tfn):
    def op(x, name=None):
        return run_op(op.__name__, tfn, [x])

    op.__name__ = op.__qualname__ = name
    return op


def _imag(a):
    return torch.imag(a) if a.is_complex() else a * 0


_UNARY = {
    "exp": _floated(torch.exp),
    "expm1": _floated(torch.expm1),
    "log": _floated(torch.log),
    "log2": _floated(torch.log2),
    "log10": _floated(torch.log10),
    "log1p": _floated(torch.log1p),
    "sqrt": _floated(torch.sqrt),
    "rsqrt": _floated(torch.rsqrt),
    "abs": torch.abs,
    "sign": torch.sign,
    "sin": _floated(torch.sin),
    "cos": _floated(torch.cos),
    "tan": _floated(torch.tan),
    "asin": _floated(torch.asin),
    "acos": _floated(torch.acos),
    "atan": _floated(torch.atan),
    "sinh": _floated(torch.sinh),
    "cosh": _floated(torch.cosh),
    "tanh": _floated(torch.tanh),
    "asinh": _floated(torch.asinh),
    "acosh": _floated(torch.acosh),
    "atanh": _floated(torch.atanh),
    "ceil": torch.ceil,
    "floor": torch.floor,
    "round": torch.round,
    "trunc": torch.trunc,
    "frac": lambda a: a - torch.trunc(a),
    "reciprocal": _floated(torch.reciprocal),
    "square": torch.square,
    "neg": torch.neg,
    "erf": _floated(torch.special.erf),
    "erfinv": _floated(torch.special.erfinv),
    "sigmoid": _floated(torch.sigmoid),
    "logit": _floated(torch.logit),
    "lgamma": _floated(torch.lgamma),
    "digamma": _floated(torch.digamma),
    "angle": _floated(torch.angle),
    "conj": torch.conj_physical,
    "real": lambda a: torch.real(a).clone() if a.is_complex() else a.clone(),
    "imag": _imag,
    "deg2rad": _floated(torch.deg2rad),
    "rad2deg": _floated(torch.rad2deg),
    "i0": _floated(torch.special.i0),
    "i1": _floated(torch.special.i1),
}

for _name, _fn in _UNARY.items():
    _export(_name, _make_unary(_name, _fn))

# Paddle's aliases
_export("arcsin", globals()["asin"])
_export("arccos", globals()["acos"])
_export("arctan", globals()["atan"])


# --------------------------------------------------------------------------- #
# binary elementwise
# --------------------------------------------------------------------------- #

def _make_binary(name, tfn):
    def op(x, y, name=None):
        return run_op(op.__name__, tfn, [x, y])

    op.__name__ = op.__qualname__ = name
    return op


def _pow(a, b):
    if not (a.is_floating_point() or a.is_complex()) and b.is_floating_point():
        a = a.to(torch.result_type(a, b))
    return torch.pow(a, b)


_BINARY = {
    "add": torch.add,
    "subtract": torch.subtract,
    "multiply": torch.multiply,
    "divide": torch.true_divide,
    "floor_divide": torch.floor_divide,
    "mod": torch.remainder,
    "remainder": torch.remainder,
    "floor_mod": torch.remainder,
    "pow": _pow,
    "maximum": _same_dtype(torch.maximum),
    "minimum": _same_dtype(torch.minimum),
    "fmax": _same_dtype(torch.fmax),
    "fmin": _same_dtype(torch.fmin),
    "atan2": _same_dtype(_floated(torch.atan2)),
    "hypot": _same_dtype(_floated(torch.hypot)),
    "logaddexp": _same_dtype(_floated(torch.logaddexp)),
    "heaviside": _same_dtype(torch.heaviside),
    "copysign": _same_dtype(_floated(torch.copysign)),
    "nextafter": _same_dtype(torch.nextafter),
    "ldexp": lambda a, b: torch.ldexp(a, b.to(torch.int32)),
    "gcd": torch.gcd,
    "lcm": torch.lcm,
    "inner": _same_dtype(torch.inner),
    "outer": _same_dtype(torch.outer),
    "kron": _same_dtype(torch.kron),
}

for _name, _fn in _BINARY.items():
    _export(_name, _make_binary(_name, _fn))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s, b = float(scale), float(bias)

    def fn(a):
        return a * s + b if bias_after_scale else (a + b) * s

    return run_op("scale", fn, [x])


_export("scale", scale)


def multiplex(inputs, index, name=None):
    def fn(ind, *vals):
        stacked = torch.stack(vals, 0)
        ind = ind.reshape(-1).long()
        return stacked[ind, torch.arange(stacked.shape[1], device=ind.device)]

    return run_op("multiplex", fn, [index, *inputs])


_export("multiplex", multiplex)


# --------------------------------------------------------------------------- #
# reductions
# --------------------------------------------------------------------------- #

def _prod(a, d, keepdim):
    for ax in sorted((x % builtins.max(a.dim(), 1) for x in d), reverse=True):
        a = torch.prod(a, ax, keepdim=keepdim)
    return a


def _reduce_fn(kind, a, d, keepdim):
    if a.dim() == 0:
        return a.clone() if kind not in ("mean", "nanmean") else a.float()
    if kind == "sum":
        return torch.sum(a, d, keepdim=keepdim)
    if kind == "nansum":
        return torch.nansum(a, d, keepdim=keepdim)
    if kind == "prod":
        return _prod(a, d, keepdim)
    if kind in ("max", "amax"):
        return torch.amax(a, d, keepdim=keepdim)
    if kind in ("min", "amin"):
        return torch.amin(a, d, keepdim=keepdim)
    if not (a.is_floating_point() or a.is_complex()):
        a = a.to(dt(None))
    if kind == "mean":
        return torch.mean(a, d, keepdim=keepdim)
    if kind == "nanmean":
        return torch.nanmean(a, d, keepdim=keepdim)
    return torch.logsumexp(a, d, keepdim=keepdim)


def _make_reduce(name):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        out_dt = None if dtype is None else dt(dtype)

        def fn(a):
            if out_dt is not None and op.__name__ in ("sum", "prod", "nansum"):
                a = a.to(out_dt)
            out = _reduce_fn(op.__name__, a, dims(a, axis), keepdim)
            return out if out_dt is None else out.to(out_dt)

        return run_op(op.__name__, fn, [x])

    op.__name__ = op.__qualname__ = name
    return op


for _name in ("sum", "prod", "max", "min", "amax", "amin", "mean", "nanmean",
              "nansum", "logsumexp"):
    _export(_name, _make_reduce(_name))


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return run_op("all", lambda a: torch.all(a.bool(), dims(a, axis),
                                             keepdim=keepdim)
                  if a.dim() else a.bool().clone(), [x])


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return run_op("any", lambda a: torch.any(a.bool(), dims(a, axis),
                                             keepdim=keepdim)
                  if a.dim() else a.bool().clone(), [x])


_export("all", all)
_export("any", any)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def fn(a):
        d = dims(a, axis)
        out = torch.count_nonzero(a, d) if a.dim() else (a != 0).long()
        if keepdim:
            for ax in sorted(x % a.dim() for x in d):
                out = out.unsqueeze(ax)
        return out

    return run_op("count_nonzero", fn, [x])


_export("count_nonzero", count_nonzero)


# --------------------------------------------------------------------------- #
# cumulative
# --------------------------------------------------------------------------- #

def cumsum(x, axis=None, dtype=None, name=None):
    d = None if dtype is None else dt(dtype)

    def fn(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=d)
        return torch.cumsum(a, int(axis), dtype=d)

    return run_op("cumsum", fn, [x])


def cumprod(x, dim=None, dtype=None, name=None):
    d = None if dtype is None else dt(dtype)

    def fn(a):
        if dim is None:
            return torch.cumprod(a.reshape(-1), 0, dtype=d)
        return torch.cumprod(a, int(dim), dtype=d)

    return run_op("cumprod", fn, [x])


def _cum_extreme(x, axis, pick_new, op_name, idx_dtype):
    """Running max/min with the index of the first extreme (ties keep the
    earliest index, as the reference's scan)."""
    d = dt(idx_dtype or "int64")

    def fn(a):
        if axis is None:
            a = a.reshape(-1)
            ax = 0
        else:
            ax = int(axis) % a.dim()
        am = a.movedim(ax, 0)
        vals = [am[0]]
        idx = [torch.zeros_like(am[0], dtype=torch.int64)]
        for i in range(1, am.shape[0]):
            take = pick_new(vals[-1], am[i])
            vals.append(torch.where(take, am[i], vals[-1]))
            idx.append(torch.where(take, torch.full_like(idx[-1], i), idx[-1]))
        return (torch.stack(vals).movedim(0, ax),
                torch.stack(idx).movedim(0, ax).to(d))

    return run_op(op_name, fn, [x])


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, lambda v1, v2: v2 > v1, "cummax", dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, lambda v1, v2: v2 < v1, "cummin", dtype)


_export("cumsum", cumsum)
_export("cumprod", cumprod)
_export("cummax", cummax)
_export("cummin", cummin)


def clip(x, min=None, max=None, name=None):  # noqa: A002
    lo = v(min).item() if isinstance(min, (Tensor, torch.Tensor)) else min
    hi = v(max).item() if isinstance(max, (Tensor, torch.Tensor)) else max
    return run_op("clip", lambda a: torch.clamp(a, lo, hi), [x])


_export("clip", clip)


def isnan(x, name=None):
    return run_op("isnan", torch.isnan, [x])


def isinf(x, name=None):
    return run_op("isinf", torch.isinf, [x])


def isfinite(x, name=None):
    return run_op("isfinite", torch.isfinite, [x])


_export("isnan", isnan)
_export("isinf", isinf)
_export("isfinite", isfinite)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return run_op("nan_to_num", lambda a: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf), [x])


_export("nan_to_num", nan_to_num)


def increment(x, value=1.0, name=None):
    out = run_op("increment", lambda a: a + value, [x])
    if isinstance(x, Tensor):
        x._inplace_update(out)
        return x
    return out


_export("increment", increment)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return run_op("stanh", _floated(lambda a: scale_b * torch.tanh(scale_a * a)),
                  [x])


_export("stanh", stanh)


def lerp(x, y, weight, name=None):
    if isinstance(weight, (int, float)):
        w = float(weight)
        return run_op("lerp", lambda a, b: a + w * (b - a), [x, y])
    return run_op("lerp", lambda a, b, w: a + w * (b - a), [x, y, weight])


_export("lerp", lerp)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return run_op("addmm", lambda i, a, b: beta * i + alpha * (a @ b),
                  [input, x, y])


_export("addmm", addmm)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return run_op("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), [x])


_export("trace", trace)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    ins = [x] + [p for p in (prepend, append) if p is not None]
    has_pre, has_app = prepend is not None, append is not None

    def fn(a, *rest):
        rest = list(rest)
        pre = rest.pop(0) if has_pre else None
        app = rest.pop(0) if has_app else None
        return torch.diff(a, n, axis, prepend=pre, append=app)

    return run_op("diff", fn, ins)


_export("diff", diff)


# --------------------------------------------------------------------------- #
# operators of Tensor
# --------------------------------------------------------------------------- #

def _bitwise_not(a):
    return torch.logical_not(a) if a.dtype is torch.bool else torch.bitwise_not(a)


def _install_operators():
    T = Tensor
    g = globals()
    T.__add__ = lambda s, o: g["add"](s, o)
    T.__radd__ = lambda s, o: g["add"](o, s)
    T.__sub__ = lambda s, o: g["subtract"](s, o)
    T.__rsub__ = lambda s, o: g["subtract"](o, s)
    T.__mul__ = lambda s, o: g["multiply"](s, o)
    T.__rmul__ = lambda s, o: g["multiply"](o, s)
    T.__truediv__ = lambda s, o: g["divide"](s, o)
    T.__rtruediv__ = lambda s, o: g["divide"](o, s)
    T.__floordiv__ = lambda s, o: g["floor_divide"](s, o)
    T.__rfloordiv__ = lambda s, o: g["floor_divide"](o, s)
    T.__mod__ = lambda s, o: g["mod"](s, o)
    T.__rmod__ = lambda s, o: g["mod"](o, s)
    T.__pow__ = lambda s, o: g["pow"](s, o)
    T.__rpow__ = lambda s, o: g["pow"](o, s)
    T.__matmul__ = lambda s, o: run_op("matmul", torch.matmul, [s, o])
    T.__rmatmul__ = lambda s, o: run_op("matmul", torch.matmul, [o, s])
    T.__neg__ = lambda s: g["neg"](s)
    T.__abs__ = lambda s: g["abs"](s)

    def _cmp(tfn, name):
        def op(s, o):
            return run_op(name, tfn, [s, o])

        return op

    T.__eq__ = _cmp(torch.eq, "equal")
    T.__ne__ = _cmp(torch.ne, "not_equal")
    T.__lt__ = _cmp(torch.lt, "less_than")
    T.__le__ = _cmp(torch.le, "less_equal")
    T.__gt__ = _cmp(torch.gt, "greater_than")
    T.__ge__ = _cmp(torch.ge, "greater_equal")
    # & | ^ ~ are bitwise (logical on bool), as the reference's operators
    T.__invert__ = lambda s: run_op("bitwise_not", _bitwise_not, [s])
    T.__and__ = _cmp(torch.bitwise_and, "bitwise_and")
    T.__rand__ = lambda s, o: run_op("bitwise_and", torch.bitwise_and, [o, s])
    T.__or__ = _cmp(torch.bitwise_or, "bitwise_or")
    T.__ror__ = lambda s, o: run_op("bitwise_or", torch.bitwise_or, [o, s])
    T.__xor__ = _cmp(torch.bitwise_xor, "bitwise_xor")
    T.__rxor__ = lambda s, o: run_op("bitwise_xor", torch.bitwise_xor, [o, s])


_install_operators()

# every exported function is a Tensor method, Paddle-style
for _name in list(__all__):
    if _name != "multiplex":
        register_tensor_method(_name, globals()[_name])
