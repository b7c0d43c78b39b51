"""Paddle's dtype names over torch dtypes (↔ paddle_tpu/framework/dtype.py).

`paddle_tpu_torch.float32` and the other names are torch dtypes, so they
pass straight to the port's entry points and to torch. What a `Tensor`
reports as its `dtype` is a `DType`, which compares equal to the torch
dtype, to the numpy dtype or scalar type (`t.dtype == np.float32`) and to
the name (`t.dtype == "float32"`), as the reference's numpy dtypes do.

Two differences from the JAX package, by design: integers and floats keep
64 bits (`to_tensor` of a Python int is int64, of a numpy float64 array
float64, as in Paddle), where the JAX package runs with x64 off and narrows
them to 32; and numpy has no bfloat16 without `ml_dtypes`, which the card's
installation lacks, so `DType("bfloat16").dtype` raises there.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DType", "bfloat16", "bool_", "complex128", "complex64",
           "convert_dtype", "default_float_dtype", "dtype_name", "float16",
           "float32", "float64", "get_default_dtype", "int16", "int32",
           "int64", "int8", "is_complex_dtype", "is_floating_point_dtype",
           "is_integer_dtype", "set_default_dtype", "uint8"]

# Paddle's canonical names (reference :16-29)
_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}

# Paddle's aliases (reference :31-41)
_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
}

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_default_dtype = torch.float32


# bfloat16 bits on disk where ml_dtypes is not installed (the card's
# installation): 2-byte voids, which the port's loaders read back as bits
# and the JAX package refuses to cast (numpy has no cast from a void to a
# number), where int16 bits would be read as the numbers they spell
BF16_BITS = np.dtype("V2")


def _numpy_bf16():
    """numpy's bfloat16 from ml_dtypes, or None where it is not installed."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def convert_dtype(dtype):
    """A torch dtype for any dtype spec: a name or alias, a torch dtype, a
    `DType`, a numpy dtype or scalar type (ml_dtypes' bfloat16 too); None
    passes through. Raises TypeError for anything else."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, DType):
        return dtype.torch
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name.startswith("paddle."):
            name = name[len("paddle."):]
        if name in _NAME_TO_DTYPE:
            return _NAME_TO_DTYPE[name]
    try:
        nd = np.dtype(dtype)
    except TypeError:
        raise TypeError(f"cannot interpret {dtype!r} as a dtype") from None
    if nd.name == "bfloat16":
        return torch.bfloat16
    if nd.name not in _NAME_TO_DTYPE:
        raise TypeError(f"dtype {nd} has no Paddle counterpart")
    return _NAME_TO_DTYPE[nd.name]


def dtype_name(dtype) -> str:
    """Paddle's name of a dtype ('float32', 'bfloat16', ...)."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


class DType:
    """A tensor's dtype as Paddle shows it: the torch dtype (`.torch`)
    under Paddle's name, equal to every spec `convert_dtype` reads as the
    same dtype. `.dtype` is the numpy dtype (what `np.dtype(d)` reads)."""

    __slots__ = ("torch",)

    def __init__(self, dtype):
        self.torch = convert_dtype(dtype)

    @property
    def name(self):
        return _DTYPE_TO_NAME[self.torch]

    @property
    def dtype(self):
        if self.torch is torch.bfloat16:
            nd = _numpy_bf16()
            if nd is None:
                raise TypeError("numpy has no bfloat16 without ml_dtypes")
            return nd
        return np.dtype(self.name)

    @property
    def itemsize(self):
        return self.torch.itemsize

    def __eq__(self, other):
        try:
            return convert_dtype(other) == self.torch
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.torch)

    def __repr__(self):
        return f"paddle.{self.name}"

    __str__ = __repr__


def set_default_dtype(d):
    """The dtype of Python floats and of the float creation ops."""
    global _default_dtype
    td = convert_dtype(d)
    if not td.is_floating_point:
        raise TypeError(f"set_default_dtype only supports float dtypes, got {d!r}")
    _default_dtype = td


def get_default_dtype():
    return _DTYPE_TO_NAME[_default_dtype]


def default_float_dtype():
    return _default_dtype


def is_floating_point_dtype(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer_dtype(dtype) -> bool:
    d = convert_dtype(dtype)
    return not d.is_floating_point and not d.is_complex


def is_complex_dtype(dtype) -> bool:
    return convert_dtype(dtype).is_complex
