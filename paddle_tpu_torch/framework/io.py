"""paddle.save / paddle.load (↔ paddle_tpu/framework/io.py).

Objects are pickled with every tensor (a `Tensor`, a `Parameter`, any torch
tensor) as `{"__tensor__": True, "data": <numpy array>}`, the reference's
wire form (:18-38), so a file written by either package loads in the other:
nested dicts, lists and tuples of tensors and plain values, a `state_dict`
among them. A bfloat16 tensor is written as an ml_dtypes bfloat16 array
where ml_dtypes is installed (the form the reference writes and reads);
where it is not (the card's installation), as its bits in 2-byte voids
(`dtype.BF16_BITS`) under `"dtype": "bfloat16"`, which this `load` reads
back bit for bit and the reference's `load` refuses (jnp.asarray takes no
void array) rather than misreading. `load` also reads the int16 bits that
earlier versions wrote under the same key. It returns `Tensor`s on the
default device (`get_device()`).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .core import Tensor, _from_numpy
from .dtype import BF16_BITS, _numpy_bf16

__all__ = ["load", "save"]


def _bits(v):
    """{"__tensor__", "data"[, "dtype"]} of a torch tensor."""
    v = v.detach().cpu()
    if v.dtype is torch.bfloat16:
        bits = v.view(torch.int16).numpy().copy()
        nd = _numpy_bf16()
        if nd is not None:
            return {"__tensor__": True, "data": bits.view(nd)}
        return {"__tensor__": True, "data": bits.view(BF16_BITS),
                "dtype": "bfloat16"}
    return {"__tensor__": True, "data": v.numpy().copy()}


def _to_serializable(obj):
    if isinstance(obj, Tensor):
        return _bits(obj._value)
    if isinstance(obj, torch.Tensor):
        return _bits(obj)
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        seq = [_to_serializable(v) for v in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    return obj


def _from_serializable(obj):
    if isinstance(obj, dict):
        if obj.get("__tensor__") is True:
            arr = np.asarray(obj["data"])
            if obj.get("dtype") == "bfloat16":
                bits = np.ascontiguousarray(arr).view(np.int16)
                v = torch.from_numpy(bits.copy()).view(torch.bfloat16)
            else:
                v = _from_numpy(arr)
            from ..device import resolve_device

            return Tensor(v.to(resolve_device(None)))
        return {k: _from_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        seq = [_from_serializable(v) for v in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    return obj


def save(obj, path, protocol=4, **configs):
    """paddle.save (reference :40): pickle `obj` to `path`, making its
    directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_serializable(obj), f, protocol=protocol)


def load(path, **configs):
    """paddle.load (reference :48)."""
    with open(path, "rb") as f:
        return _from_serializable(pickle.load(f))
