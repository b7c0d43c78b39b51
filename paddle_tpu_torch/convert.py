"""Move weights from the JAX package into the port.

Both packages use the same parameter names and layouts (Paddle's: a
Linear weight is [in, out]), so `load_paddle_tpu_state` copies each array
into the port parameter of the same name, cast to that parameter's dtype
and placed on its device. It raises on a missing or extra key and on a
shape mismatch, never silently skipping one.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_paddle_tpu_state"]


def _to_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no torch.from_numpy
        a = a.astype(np.float32)
    return torch.tensor(a)  # a copy: the port never aliases the caller's arrays


def load_paddle_tpu_state(model: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Copy `{name: np.ndarray}` (a `paddle_tpu` model's state_dict as
    numpy arrays) into `model` in place; returns `model`."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state_dict keys differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, dst in own.items():
            src = _to_tensor(state[name])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
    return model
