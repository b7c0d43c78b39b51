"""Automatic mixed precision (↔ paddle_tpu/amp/__init__.py).

`auto_cast(level="O1"|"O2", dtype=...)` is a context manager that sets the
port's AMP state; `decorate(model, level="O2", dtype="bfloat16")` casts
every float32 parameter to the AMP dtype in place, except those of
`LayerNorm` and batch-norm layers (`_BatchNormBase`: BatchNorm*,
SyncBatchNorm), as the reference (:93-101), and those marked `keep_fp32`
(the pipelined GPT's stacked LayerNorm parameters).

The JAX package applies AMP in one place, an interceptor on every `run_op`.
PyTorch has no such hook, so each functional of the port calls
`cast_inputs(op_name, *tensors)` at its op boundary under the JAX package's
op name, and that applies the interceptor's rule: with AMP on, an op on
the black list gets its float inputs in float32; otherwise under O2 every
float input goes to the AMP dtype, and under O1 only the inputs of
white-list ops do. Non-float tensors and None pass through.

The state is saved at forward time by `fleet.recompute`, so a layer that is
recomputed in the backward casts exactly as it did in the forward.

`GradScaler` is the reference's dynamic loss scale (:133-262): `scale`
multiplies the loss, `unscale_(opt)` divides the optimizer's gradients by
the scale and checks them for inf/NaN on the device (one fused
`torch._amp_foreach_non_finite_check_and_unscale_` per gradient dtype, the
inverse scale rounded to that dtype as the reference's
`inv.astype(g.dtype)`), and `step(opt)` reads that flag once on the host:
a non-finite gradient skips the update and backs the scale off, a finite
one steps. The per-optimizer INIT -> UNSCALED -> STEPPED machine and its
errors are the reference's; `update()` resets it (the scale itself moves
in `step`, as in the reference).
"""

from __future__ import annotations

import contextlib

import torch

from .amp_lists import BLACK_LIST, WHITE_LIST

__all__ = ["BLACK_LIST", "GradScaler", "WHITE_LIST", "amp_state", "auto_cast",
           "cast_inputs", "decorate", "is_bfloat16_supported",
           "is_float16_supported"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

_state = {"enable": False, "dtype": "bfloat16", "level": "O1",
          "custom_white_list": frozenset(), "custom_black_list": frozenset()}


def is_float16_supported(device=None):
    """Whether float16 AMP runs on `device` (the reference: always)."""
    return True


def is_bfloat16_supported(device=None):
    """Whether bfloat16 AMP runs on `device` (the reference: always)."""
    return True


def amp_state():
    """A snapshot of the AMP state (restore it with `auto_cast.restore`)."""
    return dict(_state)


def cast_inputs(op_name, *tensors):
    """`tensors` cast for `op_name` under the current AMP state, as a tuple
    (the JAX package's `_interceptor` rule)."""
    if not _state["enable"]:
        return tensors
    target = _DTYPES[_state["dtype"]]
    white = (WHITE_LIST | _state["custom_white_list"]) - _state["custom_black_list"]
    black = BLACK_LIST | _state["custom_black_list"]

    def cast_to(t, dt):
        if isinstance(t, torch.Tensor) and t.dtype in _FLOATS and t.dtype != dt:
            return t.to(dt)
        return t

    if op_name in black:
        return tuple(cast_to(t, torch.float32) for t in tensors)
    if _state["level"] == "O2" or op_name in white:
        return tuple(cast_to(t, target) for t in tensors)
    return tensors


class auto_cast(contextlib.ContextDecorator):
    """paddle.amp.auto_cast: within it, the port's ops cast their inputs
    by `cast_inputs`. Nests; leaving restores the outer state."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self._new = {"enable": bool(enable), "dtype": dtype,
                     "level": level,
                     "custom_white_list": frozenset(custom_white_list or ()),
                     "custom_black_list": frozenset(custom_black_list or ())}
        self._saved = []

    @classmethod
    def restore(cls, state):
        """A context that reinstates a snapshot from `amp_state()`."""
        ctx = cls.__new__(cls)
        ctx._new = dict(state)
        ctx._saved = []
        return ctx

    def __enter__(self):
        self._saved.append(dict(_state))
        _state.update(self._new)
        return self

    def __exit__(self, *exc):
        _state.update(self._saved.pop())
        return False



def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """paddle.amp.decorate: under O2, cast every float32 parameter of the
    models to `dtype` in place, keeping `LayerNorm` and batch-norm layers
    (and parameters marked `keep_fp32`) in float32.
    Optimizers passed along switch to multi-precision (an f32 master
    copy of each low-precision parameter)."""
    from ..nn.layer.norm import LayerNorm, _BatchNormBase

    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        target = _DTYPES[dtype]
        keep = (LayerNorm, _BatchNormBase) + tuple(excluded_layers or ())
        for m in model_list:
            for layer in m.modules():
                if isinstance(layer, keep):
                    continue
                for p in layer._parameters.values():
                    if (p is not None and p.dtype == torch.float32
                            and not getattr(p, "keep_fp32", False)):
                        p.data = p.data.to(target)
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for o in opt_list:
        o._multi_precision = True
    return ((models if single else model_list),
            (optimizers if opt_single else opt_list))


class GradScaler:
    """paddle.amp.GradScaler (the module docstring): the reference's
    arguments and defaults, `enable=False` a pass-through."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # id(optimizer) -> [stage (0 INIT, 1 UNSCALED, 2 STEPPED), found]:
        # found is False or a device tensor [1] (non-zero: a non-finite
        # gradient), read on the host in step()
        self._opt_states = {}

    def scale(self, var):
        if not self._enable or self._scale == 1.0:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide the optimizer's gradients by the scale in place and check
        them for inf/NaN, on the device, without a host sync."""
        if not self._enable:
            return
        st = self._opt_states.setdefault(id(optimizer), [0, False])
        if st[0] != 0:
            raise RuntimeError("unscale_() has already been called on this "
                               "optimizer since the last update().")
        st[0] = 1
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        if not grads:
            st[1] = self._found_inf = False
            return
        found = torch.zeros(1, dtype=torch.float32, device=grads[0].device)
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for dt, gs in by_dtype.items():
            # the reference multiplies by the inverse cast to the gradient's
            # dtype; a product of two such values is exact in f32, so
            # rounding it once to dt gives the same bits
            inv = torch.tensor(1.0 / self._scale, dtype=dt).float().to(
                found.device)
            torch._amp_foreach_non_finite_check_and_unscale_(gs, found, inv)
        st[1] = self._found_inf = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        st = self._opt_states.setdefault(id(optimizer), [0, False])
        if st[0] == 2:
            raise RuntimeError("step() has already been called on this "
                               "optimizer since the last update().")
        if st[0] == 0:
            self.unscale_(optimizer)
        st[0] = 2
        if bool(st[1]):  # the one host sync of the step decision
            self._found_inf = True
            self._update_on_inf()
            return
        self._found_inf = False
        optimizer.step()
        self._update_on_good()

    def _reduce_found_inf(self, optimizer, groups):
        """Sum the inf flag of `unscale_(optimizer)` over each torch process
        group of `groups` (None: the world), in place, before `step`. Where
        ranks hold pieces of one model (pipeline stages, mp shards, batch
        ranks), each finds infs only in its own gradients, and a rank that
        skipped alone would part its parameters and its scale from its
        peers'. The reference's one controller holds every gradient and
        needs no such sum."""
        if not self._enable:
            return
        st = self._opt_states.get(id(optimizer))
        if st is None or st[0] != 1:
            raise RuntimeError("_reduce_found_inf() needs unscale_() on this "
                               "optimizer first.")
        flag = st[1]
        if not isinstance(flag, torch.Tensor):
            flag = torch.zeros(1, device=optimizer._parameter_list[0].device)
        from ..distributed import collective as C

        for g in groups:
            C._all_reduce(flag, g)
        st[1] = self._found_inf = flag

    def update(self):
        """End the step: every optimizer back to INIT (the scale moved in
        step(), as in the reference)."""
        self._opt_states.clear()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def _update_on_good(self):
        if not self._dynamic:
            return
        self._good_steps += 1
        self._bad_steps = 0
        if self._good_steps >= self._incr_every:
            self._scale *= self._incr_ratio
            self._good_steps = 0

    def _update_on_inf(self):
        if not self._dynamic:
            return
        self._bad_steps += 1
        self._good_steps = 0
        if self._bad_steps >= self._decr_every:
            self._scale = max(self._scale * self._decr_ratio, 1.0)
            self._bad_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        """A plain dict of Python numbers, the reference's keys."""
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, state):
        self._scale = float(state.get("scale", self._scale))
        self._good_steps = int(state.get("incr_count", 0))
        self._bad_steps = int(state.get("decr_count", 0))
from . import debugging  # noqa: E402,F401  (paddle.amp.debugging)
