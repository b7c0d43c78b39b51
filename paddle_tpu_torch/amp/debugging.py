"""Numeric debugging (↔ paddle_tpu/amp/debugging.py): the tensor checker
(`TensorCheckerConfig`, `enable_tensor_checker` / `disable_tensor_checker`),
`check_numerics`, and the operator statistics (`collect_operator_stats`,
`operator_stats`).

Both ride the port's one dispatch point (`framework.core`): every op of
the Paddle API and every kernel wrapper reports its outputs there under
the reference's op name (the kernels' backwards as "<name>_grad"), so the
checker names the first op whose output holds a NaN or an Inf, and the
statistics count the ops a step ran by output dtype. A `TorchDispatchMode`
would see aten names rather than Paddle's, and never the kernels, which
are launched through ctypes. The checker reads each output's finiteness
on the host (one sync per op): it is a debugging tool, not a training
path. With neither installed the dispatch point costs one `None` check.
"""

from __future__ import annotations

import contextlib
import warnings
from collections import defaultdict
from enum import Enum

import torch

from ..framework import core as _core
from ..framework.core import Tensor
from ..framework.dtype import dtype_name

__all__ = [
    "DebugMode",
    "NumericError",
    "TensorCheckerConfig",
    "check_numerics",
    "collect_operator_stats",
    "disable_operator_stats_collection",
    "disable_tensor_checker",
    "enable_operator_stats_collection",
    "enable_tensor_checker",
    "operator_stats",
]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


class TensorCheckerConfig:
    """reference :56: enable_check, debug_mode, the checked and skipped op
    lists."""

    def __init__(self, enable, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])


class NumericError(RuntimeError):
    pass


def _iter_values(result):
    if isinstance(result, Tensor):
        yield result._value
    elif isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (list, tuple)):
        for r in result:
            yield from _iter_values(r)


def _make_hook(config):
    def hook(op_name, result):
        if config.checked_op_list and op_name not in config.checked_op_list:
            return
        if op_name in config.skipped_op_list:
            return
        for val in _iter_values(result):
            if not (val.is_floating_point() or val.is_complex()):
                continue
            val = val.detach()
            if bool(torch.isfinite(val).all()):
                continue
            n_nan = int(torch.isnan(val).sum())
            n_inf = int(torch.isinf(val).sum())
            msg = (f"[check_nan_inf] op `{op_name}` produced {n_nan} NaN / "
                   f"{n_inf} Inf values (shape {tuple(val.shape)}, dtype "
                   f"{dtype_name(val.dtype)})")
            if config.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
                raise NumericError(msg)
            warnings.warn(msg)

    return hook


# the checker and the statistics each own a sub-slot of the core's one hook
_hooks: dict = {}


def _sync_hooks():
    if not _hooks:
        _core.set_op_check_hook(None)
        return
    fns = tuple(_hooks.values())
    if len(fns) == 1:
        _core.set_op_check_hook(fns[0])
        return

    def dispatch(op_name, result):
        for fn in fns:
            fn(op_name, result)

    _core.set_op_check_hook(dispatch)


def enable_tensor_checker(checker_config):
    """Check every op's outputs for NaN and Inf from now on (reference
    :198; FLAGS_check_nan_inf does the same)."""
    if checker_config.enable:
        _hooks["checker"] = _make_hook(checker_config)
    else:
        _hooks.pop("checker", None)
    _sync_hooks()


def disable_tensor_checker():
    _hooks.pop("checker", None)
    _sync_hooks()


def check_numerics(tensor, op_type="", var_name="",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """One scan of a tensor (reference :321): (num_nan, num_inf, num_zero)
    as 0-d tensors; raises NumericError on a NaN or Inf in the abort
    mode."""
    val = tensor._value if isinstance(tensor, Tensor) else torch.as_tensor(tensor)
    val = val.detach()
    counts = torch.stack([torch.isnan(val).sum(), torch.isinf(val).sum(),
                          (val == 0).sum()])
    n_nan, n_inf, n_zero = (Tensor(c) for c in counts)
    if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT and int(
            counts[0] + counts[1]):
        raise NumericError(f"[check_numerics] {op_type}:{var_name} has "
                           f"{int(counts[0])} NaN / {int(counts[1])} Inf")
    return n_nan, n_inf, n_zero


# --------------------------------------------------------------------------- #
# operator statistics
# --------------------------------------------------------------------------- #

_op_stats = None


def _stats_hook(op_name, result):
    names = {dtype_name(val.dtype) for val in _iter_values(result)}
    for name in names or {"-"}:
        _op_stats[op_name][name] += 1


def enable_operator_stats_collection():
    """Count the ops run from now on by output dtype (reference: which ops
    ran in fp16/bf16 under AMP)."""
    global _op_stats
    _op_stats = defaultdict(lambda: defaultdict(int))
    _hooks["stats"] = _stats_hook
    _sync_hooks()


def disable_operator_stats_collection():
    """Stop counting, print the op list and return the counts."""
    _hooks.pop("stats", None)
    _sync_hooks()
    stats = _op_stats
    if stats:
        print("<------------------- op list ------------------->")
        for op, by_dt in sorted(stats.items()):
            counts = ", ".join(f"{d}: {c}" for d, c in sorted(by_dt.items()))
            print(f"  {op:<40} {counts}")
        print("<----------------- op list end ----------------->")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def operator_stats():
    """{op name: {output dtype: count}} of the last collection."""
    return {k: dict(val) for k, val in (_op_stats or {}).items()}
