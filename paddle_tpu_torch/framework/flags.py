"""Paddle's runtime flags (↔ paddle_tpu/framework/flags.py).

`set_flags` / `get_flags` over one registry, filled from `FLAGS_*`
environment variables at import. As in the reference, one flag acts:
`FLAGS_matmul_precision` ("default" | "high" | "highest") sets torch's f32
matmul precision ("highest" full f32, "high" TF32, which the reference's
"bfloat16_3x" is nearest to; "default" leaves it as it is). The others are
stored so that reference scripts keep working.
"""

from __future__ import annotations

import os
from typing import Any

import torch

__all__ = ["get_flags", "set_flags"]

_FLAGS: dict[str, Any] = {
    # numerics
    "FLAGS_check_nan_inf": False,
    "FLAGS_check_nan_inf_level": 0,
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_embedding_deterministic": 0,
    # memory (torch's caching allocator owns the card's memory)
    "FLAGS_allocator_strategy": "auto_growth",
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    # matmul precision: 'default' | 'high' | 'highest'
    "FLAGS_matmul_precision": "default",
    # distributed
    "FLAGS_distributed_collective_timeout_s": 600,
    "FLAGS_benchmark": False,
}


def _parse(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


for _k, _v in os.environ.items():
    if _k.startswith("FLAGS_"):
        _FLAGS[_k] = _parse(_v)


def set_flags(flags: dict):
    """paddle.set_flags: store each flag (module docstring)."""
    for k, v in flags.items():
        _FLAGS[k] = v
        if k == "FLAGS_matmul_precision" and v in ("high", "highest"):
            torch.set_float32_matmul_precision(v)


def get_flags(keys):
    """paddle.get_flags: {name: value} of one name or a list of them (None
    for a flag never set)."""
    if isinstance(keys, str):
        keys = [keys]
    return {k: _FLAGS.get(k) for k in keys}
