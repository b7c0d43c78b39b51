"""Autograd user API (↔ paddle_tpu/autograd/__init__.py): `backward`,
`grad`, `PyLayer` / `PyLayerContext` and the functional `vjp`, `jvp`,
`jacobian` and `hessian`, on torch.autograd.

- `grad` is `torch.autograd.grad` on the held tensors: it leaves `.grad`
  alone, `create_graph=True` gives gradients that carry their own graph
  (second order), and an input the outputs do not reach raises unless
  `allow_unused=True`, which returns None for it (reference :144).
- A `PyLayer` (:205-315) runs as a `torch.autograd.Function` made for its
  class: `forward(ctx, *args)` and `backward(ctx, *grads)` see Paddle
  `Tensor`s, and the gradients it returns go to the tensor arguments in
  order.
- `vjp`, `jvp`, `jacobian` and `hessian` (:327-383) call the function on
  `Tensor`s over torch.autograd.functional.
"""

from __future__ import annotations

import torch

from ..framework.core import (Tensor, _unwrap, enable_grad, is_grad_enabled,
                              no_grad, set_grad_enabled)

__all__ = ["PyLayer", "PyLayerContext", "backward", "enable_grad", "grad",
           "hessian", "is_grad_enabled", "jacobian", "jvp", "no_grad",
           "set_grad_enabled", "vjp"]


def _list(x):
    if x is None:
        return None
    return [x] if isinstance(x, (Tensor, torch.Tensor)) else list(x)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward (reference :40): backward from each tensor
    with its gradient (None: ones for a one-element tensor)."""
    tensors = _list(tensors)
    grads = _list(grad_tensors) or [None] * len(tensors)
    for i, (t, g) in enumerate(zip(tensors, grads)):
        t = t if isinstance(t, Tensor) else Tensor(t)
        t.backward(g, retain_graph=retain_graph or i < len(tensors) - 1)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad (reference :144): the gradients of `outputs` with
    respect to `inputs`, without touching `.grad`."""
    single_in = isinstance(inputs, (Tensor, torch.Tensor))
    outs = [_unwrap(o) for o in _list(outputs)]
    ins = [_unwrap(i) for i in _list(inputs)]
    gouts = _list(grad_outputs)
    if gouts is not None:
        gouts = [None if g is None else _unwrap(g) for g in gouts]
    else:
        gouts = [None] * len(outs)
    gouts = [torch.ones_like(o) if g is None and o.dim() != 0 else g
             for o, g in zip(outs, gouts)]
    if retain_graph is None:
        retain_graph = True
    try:
        res = torch.autograd.grad(outs, ins, gouts, retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=allow_unused)
    except RuntimeError as e:
        if "not have been used in the graph" in str(e):
            raise RuntimeError(
                "One of the differentiated tensors appears unused; pass "
                "allow_unused=True to return None for it") from None
        raise
    out = [None if g is None else Tensor(g) for g in res]
    return out[0] if single_in else out


# --------------------------------------------------------------------------- #
# PyLayer
# --------------------------------------------------------------------------- #

class PyLayerContext:
    """ctx of PyLayer.forward/backward (reference :205)."""

    def __init__(self):
        self._saved = ()
        self.not_inplace_tensors = ()
        self.needs_input_grad = ()

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._saved

    @property
    def saved_tensors(self):
        return self._saved


def _wrap_args(args):
    return [Tensor(a) if isinstance(a, torch.Tensor) else a for a in args]


def _function_of(cls):
    """The torch.autograd.Function of PyLayer class `cls` (made once)."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(ctx, plain_kw, tensor_kw, n_args, *flat):
        pctx = PyLayerContext()
        pctx.needs_input_grad = ctx.needs_input_grad[3:]
        ctx.pctx = pctx
        args = _wrap_args(flat[:n_args])
        kw = dict(plain_kw, **dict(zip(tensor_kw, _wrap_args(flat[n_args:]))))
        out = cls.forward(pctx, *args, **kw)
        if isinstance(out, (tuple, list)):
            return tuple(_unwrap(o) for o in out)
        return _unwrap(out)

    def backward(ctx, *grads):
        gin = cls.backward(ctx.pctx, *[Tensor(g) for g in grads])
        gin = list(gin) if isinstance(gin, (tuple, list)) else [gin]
        n = len(ctx.needs_input_grad) - 3
        gin = [None if g is None else _unwrap(g) for g in gin][:n]
        gin += [None] * (n - len(gin))
        return (None, None, None, *gin)

    fn = type(f"{cls.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    cls._torch_function = fn
    return fn


class PyLayer:
    """A user-defined differentiable op (reference :264): subclass it with
    static `forward(ctx, ...)` and `backward(ctx, *grads)` and call
    `apply`. The backward returns one gradient per tensor argument (in
    order; None for one that needs none)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        tensor_kw = [k for k, v in kwargs.items()
                     if isinstance(v, (Tensor, torch.Tensor))]
        plain_kw = {k: v for k, v in kwargs.items() if k not in tensor_kw}
        flat = [_unwrap(a) for a in args] + [_unwrap(kwargs[k])
                                            for k in tensor_kw]
        out = _function_of(cls).apply(plain_kw, tuple(tensor_kw), len(args),
                                      *flat)
        if isinstance(out, tuple):
            return tuple(Tensor(o) if isinstance(o, torch.Tensor) else o
                         for o in out)
        return Tensor(out) if isinstance(out, torch.Tensor) else out


# --------------------------------------------------------------------------- #
# functional AD (reference :327-383)
# --------------------------------------------------------------------------- #

def _raw(func):
    def raw(*vals):
        out = func(*[Tensor(v) for v in vals])
        if isinstance(out, (tuple, list)):
            return tuple(_unwrap(o) for o in out)
        return _unwrap(out)

    return raw


def _wrap(x):
    if isinstance(x, tuple):
        return tuple(_wrap(v) for v in x)
    return Tensor(x)


def _primals(xs):
    single = isinstance(xs, (Tensor, torch.Tensor))
    vals = tuple(_unwrap(x).detach() for x in ([xs] if single else xs))
    return single, vals


def _seed(v):
    if v is None:
        return None
    if isinstance(v, (Tensor, torch.Tensor)):
        return _unwrap(v)
    return tuple(_unwrap(t) for t in v)


def vjp(func, xs, v=None):
    """(func(xs), vᵀ J): v defaults to ones like the output."""
    single, vals = _primals(xs)
    with torch.enable_grad():
        out, g = torch.autograd.functional.vjp(_raw(func), vals,
                                               _seed(v))
    g = _wrap(g)
    return _wrap(out), (g[0] if single else list(g))


def jvp(func, xs, v=None):
    """(func(xs), J v): v defaults to ones like the inputs."""
    single, vals = _primals(xs)
    tangents = _seed(v)
    if tangents is None:
        tangents = tuple(torch.ones_like(x) for x in vals)
    elif not isinstance(tangents, tuple):
        tangents = (tangents,)
    with torch.enable_grad():
        out, t = torch.autograd.functional.jvp(_raw(func), vals, tangents)
    return _wrap(out), _wrap(t)


def jacobian(func, xs, batch_axis=None):
    single, vals = _primals(xs)
    with torch.enable_grad():
        jac = torch.autograd.functional.jacobian(_raw(func), vals)
    if single:
        return _wrap(jac[0] if isinstance(jac, tuple) else jac)
    return _wrap(jac)


def hessian(func, xs, batch_axis=None):
    single, vals = _primals(xs)
    with torch.enable_grad():
        hes = torch.autograd.functional.hessian(_raw(func), vals)
    if single:
        h = hes[0][0] if isinstance(hes, tuple) else hes
        return _wrap(h)
    return tuple(tuple(Tensor(c) for c in row) for row in hes)
