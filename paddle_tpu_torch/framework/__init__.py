"""paddle_tpu_torch.framework (↔ paddle_tpu/framework): Tensor and
Parameter, to_tensor, the grad modes, dtypes, the RNG state, flags and
save/load."""

from . import core, dtype, random
from .core import (Parameter, Tensor, enable_grad, is_grad_enabled, no_grad,
                   register_tensor_method, run_op, set_grad_enabled,
                   to_tensor)
from .dtype import get_default_dtype, set_default_dtype
from .flags import get_flags, set_flags
from .io import load, save
from .random import get_rng_state, rng_guard, seed, set_rng_state

__all__ = ["Parameter", "Tensor", "enable_grad", "get_default_dtype",
           "get_flags", "get_rng_state", "is_grad_enabled", "load", "no_grad",
           "random", "rng_guard", "run_op", "save", "seed",
           "set_default_dtype", "set_flags", "set_grad_enabled",
           "set_rng_state", "to_tensor"]
