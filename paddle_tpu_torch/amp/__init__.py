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
"""

from __future__ import annotations

import contextlib

import torch

from .amp_lists import BLACK_LIST, WHITE_LIST

__all__ = ["BLACK_LIST", "WHITE_LIST", "amp_state", "auto_cast",
           "cast_inputs", "decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

_state = {"enable": False, "dtype": "bfloat16", "level": "O1",
          "custom_white_list": frozenset(), "custom_black_list": frozenset()}


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
