"""Paddle's Tensor over one torch.Tensor, Parameter, `to_tensor`, the grad
modes and the one dispatch point of the Paddle API
(↔ paddle_tpu/framework/core.py).

**Tensor is a wrapper, not a subclass.** A `Tensor` holds one
`torch.Tensor` (`_value`), as the reference's holds one `jax.Array`
(:353). Paddle's methods collide with torch's under the same names but
with other meanings (`shape` is a list, `size` the element count, `split(2)`
two sections, `transpose(perm)` a permutation, `max` one tensor, `numpy()`
works on a tensor that needs a gradient), and torch's own Python code calls
`x.size()` and reads `x.shape` and `x.dtype`: a subclass that overrode them
would break `torch.nn.functional`, one that kept them would give Paddle
code other answers without a word. So `torch.Tensor` gains nothing, and a
torch function given a `Tensor` raises TypeError (`__torch_function__`)
rather than guessing; a binary operator between a torch tensor and a
`Tensor` falls to the `Tensor`'s reflected operator.

**Gradients are torch.autograd on the held tensor.** `stop_gradient` is
`not requires_grad`; `.grad` wraps the held tensor's gradient; `backward`
is torch's, and raises on a non-scalar without a gradient (:229-233);
`clear_grad()` leaves `grad` None. `stop_gradient = True` on a tensor that
has a producer rebinds the handle to the held tensor's `detach()`, which is
what Paddle means (torch refuses `requires_grad_(False)` there).
`__setitem__` and the in-place `<op>_` variants rebind the handle to a new
tensor out of place (the reference's `_inplace_update`, :597-631): a value
that autograd saved keeps its version, so torch's version counter never
trips. Hooks and `retain_grads` follow the handle to its new tensor. An
in-place op on a leaf that needs a gradient raises, with grad enabled
(:608-613).

**Parameter is a `torch.nn.Parameter` subclass** (:668). It adds only
what torch's Tensor lacks: `stop_gradient`, `trainable`, `name`,
`need_clip`, `optimize_attr`, and a `numpy()` that detaches first. The
port's layers create it where they created `nn.Parameter`, so
`p.stop_gradient = True` freezes a port model as it freezes a Paddle one.

**One dispatch point.** Every function of the Paddle API goes through
`run_op(name, fn, inputs)` under the reference's op name: the inputs'
held tensors are cast for AMP (`amp.cast_inputs`, the reference's op input
interceptor), `fn` runs on them, the outputs are wrapped, and the op check
hook (`set_op_check_hook`, :934; `amp.debugging` installs it) sees the
name and the outputs. The kernel wrappers in `ops/` and the functionals of
`nn.functional` report their outputs to the same hook with `report_op`
under the names the reference gives the same work. The port has no
dispatch cache to port (PyTorch runs each op eagerly).

**Two more hooks, for the telemetry** (reference :921-1010). The op event
hook (`set_op_event_hook`; the profiler installs it) sees
`(op_name, start_ns, end_ns)` around every `run_op` and every `reported`
functional; `report_op` gives it an instant at the moment a kernel wrapper
reports, since the launch is asynchronous and its device time is in the
profiler's trace. The sync observer chain (`set_sync_observer`,
`add_sync_observer`, `remove_sync_observer`; the `StepTimeline` adds
itself) sees `(kind, tensor)` whenever Python reads a `Tensor`'s value on
the host: `item`, `numpy`, `tolist`, `bool`, `int` and `float`. With
nothing installed each hook costs one `None` check per call.
"""

from __future__ import annotations

import copy
import functools
import numbers
import time

import numpy as np
import torch

from . import dtype as dtype_mod

__all__ = ["Parameter", "Tensor", "add_sync_observer", "enable_grad",
           "is_grad_enabled", "no_grad", "register_tensor_method",
           "remove_sync_observer", "report_op", "run_op",
           "set_grad_enabled", "set_op_check_hook", "set_op_event_hook",
           "set_sync_observer", "to_tensor"]


# --------------------------------------------------------------------------- #
# grad modes (reference :59-89): torch's own switch
# --------------------------------------------------------------------------- #

def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class set_grad_enabled(torch.set_grad_enabled):
    """paddle.set_grad_enabled: a call, a context manager or a decorator."""


class no_grad(torch.no_grad):
    """paddle.no_grad: a context manager or a decorator."""


class enable_grad(torch.enable_grad):
    """paddle.enable_grad: a context manager or a decorator."""


# --------------------------------------------------------------------------- #
# the op check hook (reference :923-936)
# --------------------------------------------------------------------------- #

_op_check_hook = None


def set_op_check_hook(fn):
    """Install `fn(op_name, outputs)` (None removes it); it sees every op of
    the Paddle API and every kernel wrapper's outputs, and may raise."""
    global _op_check_hook
    _op_check_hook = fn


def op_check_hook():
    return _op_check_hook


# --------------------------------------------------------------------------- #
# the op event hook and the sync observer chain (reference :921-1010)
# --------------------------------------------------------------------------- #

# fn(op_name, start_ns, end_ns) around every op (the profiler's host events)
_op_event_hook = None


def set_op_event_hook(fn):
    """Install `fn(op_name, start_ns, end_ns)` (None removes it)."""
    global _op_event_hook
    _op_event_hook = fn


# fn(kind, tensor) when Python reads a Tensor's value on the host. A base
# slot (set_*) plus an additive chain (add_* / remove_*: the StepTimeline);
# `_sync_observer` is the composed slot the Tensor methods call. A chained
# observer returning non-None proposes a replacement value for `item()`
# (the last non-None wins, the base first).
_sync_observer = None
_base_sync_observer = None
_sync_observer_chain: list = []


def _compose_sync_observer():
    global _sync_observer
    base, chain = _base_sync_observer, tuple(_sync_observer_chain)
    if not chain:
        _sync_observer = base
        return
    if base is None and len(chain) == 1:
        _sync_observer = chain[0]
        return

    def _dispatch(kind, tensor, _base=base, _chain=chain):
        rep = _base(kind, tensor) if _base is not None else None
        for fn in _chain:
            out = fn(kind, tensor)
            if out is not None:
                rep = out
        return rep

    _sync_observer = _dispatch


def set_sync_observer(fn):
    """Install or replace the base observer; returns the previous base.
    Never save `core._sync_observer` itself: it is the composed slot, and
    setting it back as a base would fire the chain twice."""
    global _base_sync_observer
    prev = _base_sync_observer
    _base_sync_observer = fn
    _compose_sync_observer()
    return prev


def add_sync_observer(fn):
    """Append `fn` to the sync-observer chain; returns `fn` for remove_*."""
    _sync_observer_chain.append(fn)
    _compose_sync_observer()
    return fn


def remove_sync_observer(fn):
    try:
        _sync_observer_chain.remove(fn)
    except ValueError:
        pass
    _compose_sync_observer()


def report_op(name, out):
    """Hand `out` (a tensor, a `Tensor` or a tuple of them) to the op
    check hook under the op name `name`, and an instant to the op event
    hook; returns `out`."""
    ev = _op_event_hook
    if ev is not None:
        t = time.perf_counter_ns()
        ev(name, t, t)
    hook = _op_check_hook
    if hook is not None:
        hook(name, out)
    return out


def reported(name):
    """Decorate a functional so that its outputs go to the op check hook
    under the op name `name`, and its call to the op event hook."""
    def deco(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            ev = _op_event_hook
            if ev is None:
                out = fn(*args, **kwargs)
            else:
                t0 = time.perf_counter_ns()
                try:
                    out = fn(*args, **kwargs)
                finally:
                    ev(name, t0, time.perf_counter_ns())
            hook = _op_check_hook
            if hook is not None:
                hook(name, out)
            return out

        return op

    return deco


# --------------------------------------------------------------------------- #
# Tensor
# --------------------------------------------------------------------------- #

_tensor_methods: dict = {}


def register_tensor_method(name, fn):
    """Attach a function of the Paddle API as a `Tensor` method (how
    python/paddle/tensor/__init__.py patches methods onto the reference's
    Tensor, :309). Only the port's own `Tensor` class gains it."""
    _tensor_methods[name] = fn
    setattr(Tensor, name, fn)


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


def _normalize_index(idx):
    if isinstance(idx, tuple):
        return tuple(_normalize_index(i) for i in idx)
    if isinstance(idx, list) and any(isinstance(i, Tensor) for i in idx):
        return [_unwrap(i) for i in idx]
    return _unwrap(idx)


class _HookHandle:
    def __init__(self, tensor, entry):
        self._tensor, self._entry = tensor, entry

    def remove(self):
        entry = self._entry
        if entry in self._tensor._hooks:
            self._tensor._hooks.remove(entry)
        for h in entry[1]:
            h.remove()
        entry[1].clear()


class Tensor:
    """User-facing tensor: one held `torch.Tensor` (`_value`) under Paddle's
    semantics (module docstring)."""

    __slots__ = ("_value", "name", "_hooks", "_retain", "__weakref__")

    def __init__(self, value, stop_gradient=None, name=None):
        if isinstance(value, Tensor):
            value = value._value
        if not isinstance(value, torch.Tensor):
            raise TypeError(f"Tensor holds a torch.Tensor, got {type(value)}; "
                            "use to_tensor for host data")
        self._value = value
        self.name = name
        self._hooks = []
        self._retain = False
        if stop_gradient is not None:
            self.stop_gradient = stop_gradient

    # torch functions refuse a Paddle Tensor rather than guess (module
    # docstring); a binary operator then falls to the reflected one
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise TypeError(
            f"{getattr(func, '__name__', func)} was given a paddle_tpu_torch "
            "Tensor; call the Paddle API, or pass the held torch tensor "
            "(Tensor._value)")

    # -- metadata ---------------------------------------------------------- #

    @property
    def value(self):
        return self._value

    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def dtype(self):
        return dtype_mod.DType(self._value.dtype)

    @property
    def size(self):
        return self._value.numel()

    @property
    def T(self):
        return _tensor_methods["t"](self)

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    @property
    def place(self):
        from ..device import CPUPlace, CUDAPlace

        dev = self._value.device
        return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)

    def dim(self):
        return self._value.dim()

    def numel(self):
        return self._value.numel()

    def __len__(self):
        if self._value.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}{grad_info},\n       "
                f"{self._value.detach().cpu()})")

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if _sync_observer is not None:
            _sync_observer("bool", self)
        return bool(self._value.detach())

    def __int__(self):
        if _sync_observer is not None:
            _sync_observer("int", self)
        return int(self._value.detach())

    def __float__(self):
        if _sync_observer is not None:
            _sync_observer("float", self)
        return float(self._value.detach())

    def __format__(self, spec):
        if self._value.dim() == 0:
            return format(self.item(), spec)
        return repr(self)

    # -- conversion -------------------------------------------------------- #

    def numpy(self):
        """The values on the host as a numpy array (a copy). A bfloat16
        tensor comes back as float32: numpy has no bfloat16 without
        ml_dtypes, and every bfloat16 value is exact in float32."""
        if _sync_observer is not None:
            _sync_observer("array", self)
        return _to_numpy(self._value)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def item(self, *args):
        if _sync_observer is not None:
            rep = _sync_observer("item" if not args else "array", self)
            if rep is not None:
                return rep
        if args:
            return _to_numpy(self._value).item(*args)
        return self._value.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def detach(self):
        return Tensor(self._value.detach(), name=self.name)

    def clone(self):
        return run_op("clone", torch.clone, [self])

    def astype(self, dtype):
        dt = dtype_mod.convert_dtype(dtype)
        return run_op("cast", lambda a: a.to(dt), [self])

    cast = astype

    def cpu(self):
        return run_op("memcpy_d2h", lambda a: a.cpu(), [self])

    def to(self, *args, **kwargs):
        """Tensor.to(device | dtype | tensor, blocking=...): a device (a
        name or a place) moves the tensor, a dtype or a tensor casts; an
        argument that is none of these raises (reference :493-523)."""
        from ..device import CPUPlace, CUDAPlace, _torch_device

        out = self
        for a in list(args) + list(kwargs.values()):
            if a is None or isinstance(a, bool):
                continue
            if isinstance(a, Tensor):
                out = out.astype(a._value.dtype)
                continue
            if isinstance(a, (CPUPlace, CUDAPlace, torch.device)) or (
                    isinstance(a, str) and a.split(":")[0].lower() in
                    ("cpu", "gpu", "cuda")):
                dev = _torch_device(a)
                out = run_op("memcpy", lambda v, d=dev: v.to(d), [out])
                continue
            try:
                dt = dtype_mod.convert_dtype(a)
            except TypeError:
                raise ValueError(f"Tensor.to(): cannot interpret {a!r} as a "
                                 "device, dtype, or Tensor") from None
            out = out.astype(dt)
        return out

    # -- autograd ---------------------------------------------------------- #

    @property
    def stop_gradient(self):
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag):
        v = self._value
        if flag:
            if v.requires_grad:
                if v.grad_fn is None:
                    v.requires_grad_(False)
                else:
                    self._value = v.detach()
        elif not v.requires_grad and (v.is_floating_point() or v.is_complex()):
            if v.grad_fn is None:
                v.requires_grad_(True)

    @property
    def requires_grad(self):
        return self._value.requires_grad

    @requires_grad.setter
    def requires_grad(self, flag):
        self.stop_gradient = not flag

    @property
    def grad(self):
        v = self._value
        if not (v.grad_fn is None or v.retains_grad):
            return None
        g = v.grad
        return None if g is None else Tensor(g)

    @grad.setter
    def grad(self, g):
        self._value.grad = None if g is None else _unwrap(g)

    def backward(self, grad_tensor=None, retain_graph=False):
        """Back-propagate from this tensor (reference :214): a non-scalar
        needs `grad_tensor`; a tensor that needs no gradient does nothing."""
        v = self._value
        if grad_tensor is None and v.numel() != 1:
            raise RuntimeError("backward() on a non-scalar tensor requires an "
                               "explicit grad_tensor")
        if not v.requires_grad:
            return
        g = None if grad_tensor is None else _as_value(grad_tensor, v)
        if g is None and v.dim() != 0:
            g = torch.ones_like(v)
        v.backward(g, retain_graph=retain_graph)

    def retain_grads(self):
        """Keep the gradient of this non-leaf tensor in `.grad` at the
        next backward (reference :546)."""
        self._retain = True
        if self._value.requires_grad and self._value.grad_fn is not None:
            self._value.retain_grad()

    def clear_grad(self):
        self._value.grad = None

    clear_gradient = clear_grad

    def register_hook(self, fn):
        """`fn(grad)` runs on this tensor's gradient at backward and may
        return a replacement (reference :556); returns a handle with
        `remove()`."""
        entry = (fn, [])
        self._hooks.append(entry)
        self._attach_hook(entry)
        return _HookHandle(self, entry)

    def _attach_hook(self, entry):
        fn, handles = entry
        if not self._value.requires_grad:
            return

        def hook(g):
            out = fn(Tensor(g))
            return None if out is None else _unwrap(out)

        handles.append(self._value.register_hook(hook))

    def _rebind(self, new):
        """Point this handle at the tensor `new` (setitem, the in-place
        variants); its hooks and retain_grads follow it."""
        self._value = new
        for entry in self._hooks:
            self._attach_hook(entry)
        if self._retain:
            self.retain_grads()
        return self

    def _inplace_update(self, out):
        """Rebind to the result `out` of an op on this tensor (reference
        :597): raises on a leaf that needs a gradient, with grad enabled."""
        self._check_inplace()
        return self._rebind(_unwrap(out))

    def _check_inplace(self):
        v = self._value
        if torch.is_grad_enabled() and v.requires_grad and v.grad_fn is None:
            raise RuntimeError(
                "in-place operation on a leaf Tensor that requires grad is "
                "not allowed; use .detach() or no_grad(), or assign with "
                "set_value()")

    def set_value(self, value):
        """Write `value` (same shape, cast to this dtype) into the tensor in
        place, outside the graph (reference :583)."""
        src = _as_value(value, self._value)
        if tuple(src.shape) != tuple(self._value.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(src.shape)} "
                             f"vs {tuple(self._value.shape)}")
        with torch.no_grad():
            self._value.copy_(src.to(self._value.dtype))
        return self

    def copy_(self, other, *_):
        return self.set_value(other)

    # -- indexing ---------------------------------------------------------- #

    def __getitem__(self, idx):
        idx = _index_on(self._value, _normalize_index(idx))
        return run_op("getitem", lambda a: a[idx], [self])

    def __setitem__(self, idx, value):
        """x[idx] = value, out of place (module docstring)."""
        self._check_inplace()
        idx = _index_on(self._value, _normalize_index(idx))
        v = self._value
        src = _as_value(value, v)
        if v.requires_grad and not torch.is_grad_enabled():
            # a leaf that needs a gradient, written under no_grad: the new
            # tensor stays a leaf that needs one
            new = v.detach().clone()
            new[idx] = src.to(v.dtype)
            new.requires_grad_(True)
        else:
            new = v.clone()
            new[idx] = src.to(v.dtype)
        report_op("setitem", new)
        self._rebind(new)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _index_on(v, idx):
    """Index tensors moved to the indexed tensor's device."""
    def fix(i):
        if isinstance(i, torch.Tensor) and i.device != v.device:
            return i.to(v.device)
        return i

    if isinstance(idx, tuple):
        return tuple(fix(i) for i in idx)
    if isinstance(idx, list):
        return [fix(i) for i in idx]
    return fix(idx)


def _to_numpy(v):
    t = v.detach()
    if t.dtype is torch.bfloat16:
        t = t.float()
    if t.device.type != "cpu":
        return t.cpu().numpy()
    return t.numpy().copy()


# --------------------------------------------------------------------------- #
# Parameter
# --------------------------------------------------------------------------- #

class Parameter(torch.nn.Parameter):
    """A trainable tensor (reference :668): a `torch.nn.Parameter` with
    Paddle's names beside torch's. `Parameter(data, requires_grad=True)` as
    torch's, or `trainable=` and `name=` as Paddle's."""

    def __new__(cls, data=None, requires_grad=True, *, trainable=None,
                name=None):
        if trainable is not None:
            requires_grad = bool(trainable)
        if isinstance(data, Tensor):
            data = data._value.detach()
        p = super().__new__(cls, data, requires_grad)
        if name is not None:
            p.name = name
        return p

    def __deepcopy__(self, memo):
        out = super().__deepcopy__(memo)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    @property
    def name(self):
        return self.__dict__.get("_paddle_name")

    @name.setter
    def name(self, value):
        self.__dict__["_paddle_name"] = value

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag):
        self.requires_grad_(not flag)

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, flag):
        self.requires_grad_(bool(flag))

    @property
    def need_clip(self):
        return self.__dict__.get("_need_clip", True)

    @need_clip.setter
    def need_clip(self, flag):
        self.__dict__["_need_clip"] = bool(flag)

    @property
    def optimize_attr(self):
        return self.__dict__.setdefault("_optimize_attr", {"learning_rate": 1.0})

    def numpy(self):
        if _sync_observer is not None:
            _sync_observer("array", self)
        return _to_numpy(self)

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad


# --------------------------------------------------------------------------- #
# to_tensor and the dispatch point
# --------------------------------------------------------------------------- #

def _from_numpy(arr):
    """A CPU torch tensor of a numpy array (ml_dtypes' bfloat16 through its
    bits), a copy."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).clone()


def _host_dtype(data, arr):
    """Paddle's dtype rule for host data (reference :888-898): a Python
    float or a list of them takes the default float dtype, a numpy array
    keeps its own, a Python int is int64, a Python complex complex64."""
    if isinstance(data, np.ndarray) or isinstance(data, np.generic):
        return None
    if arr.dtype == np.float64:
        return dtype_mod.default_float_dtype()
    if arr.dtype == np.complex128:
        return torch.complex64
    return None


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor (reference :878): host data (numpy, lists, scalars)
    or a tensor copied onto `place` (default: `get_device()`), cast to
    `dtype`. A torch tensor or a `Tensor` on the card stays on the card."""
    from ..device import resolve_device

    dt = dtype_mod.convert_dtype(dtype)
    if isinstance(data, (Tensor, torch.Tensor)):
        v = _unwrap(data).detach()
        dev = v.device if place is None else resolve_device(place)
        v = v.to(device=dev, dtype=dt or v.dtype, copy=True)
    else:
        dev = resolve_device(place)
        arr = np.asarray(data)
        if arr.dtype == object:
            raise TypeError(f"to_tensor cannot read {type(data).__name__}")
        dt = dt or _host_dtype(data, arr)
        v = _from_numpy(arr)
        v = v.to(device=dev, dtype=dt or v.dtype)
    t = Tensor(v)
    if not stop_gradient:
        t.stop_gradient = False
    return t


def _as_value(x, like=None):
    """The torch tensor of an op input: a `Tensor`'s held tensor, a torch
    tensor as it is, host data as a tensor on `like`'s device (a Python
    float as a 0-d tensor of the default float dtype, so that torch's
    promotion of 0-d tensors keeps the other operand's dtype)."""
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, bool):
        return torch.tensor(x, device=dev)
    if isinstance(x, numbers.Integral) and not isinstance(x, np.generic):
        return torch.tensor(int(x), device=dev)
    if isinstance(x, numbers.Real) and not isinstance(x, np.generic):
        return torch.tensor(float(x), dtype=dtype_mod.default_float_dtype(),
                            device=dev)
    if isinstance(x, numbers.Complex) and not isinstance(x, np.generic):
        return torch.tensor(complex(x), dtype=torch.complex64, device=dev)
    if dev is None:
        return to_tensor(x)._value
    return to_tensor(x, place=dev)._value


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return Tensor(out)
    if isinstance(out, tuple):
        return tuple(_wrap(o) for o in out)
    if isinstance(out, list):
        return [_wrap(o) for o in out]
    return out


def run_op(name, fn, inputs):
    """`fn(*held tensors)` under the op name `name` (module docstring):
    host data among `inputs` goes to the device of the first tensor input,
    the inputs are cast for AMP, and the outputs come back as `Tensor`s."""
    like = next((_unwrap(x) for x in inputs
                 if isinstance(x, (Tensor, torch.Tensor))), None)
    vals = [_as_value(x, like) for x in inputs]
    if _amp._state["enable"]:
        vals = _amp.cast_inputs(name, *vals)
    ev = _op_event_hook
    if ev is None:
        out = _wrap(fn(*vals))
    else:
        t0 = time.perf_counter_ns()
        try:
            out = _wrap(fn(*vals))
        finally:
            ev(name, t0, time.perf_counter_ns())
    hook = _op_check_hook
    if hook is not None:
        hook(name, out)
    return out


# AMP's state module, imported last: amp.debugging imports this module
from .. import amp as _amp  # noqa: E402
