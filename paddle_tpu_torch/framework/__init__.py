"""paddle_tpu_torch.framework (↔ paddle_tpu/framework): the RNG state."""

from . import random
from .random import get_rng_state, rng_guard, seed, set_rng_state

__all__ = ["get_rng_state", "random", "rng_guard", "seed", "set_rng_state"]
