"""The functional tensor op surface (↔ paddle_tpu/tensor/__init__.py):
the ten modules' functions, every one also a `Tensor` method where the
reference makes it one, and the generated in-place `<op>_` variants."""

from . import creation, extras, linalg, logic, manipulation, math, random, search, stat, tail
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .tail import *  # noqa: F401,F403

__all__ = (
    list(creation.__all__)
    + list(math.__all__)
    + list(manipulation.__all__)
    + list(linalg.__all__)
    + list(logic.__all__)
    + list(search.__all__)
    + list(stat.__all__)
    + list(random.__all__)
    + list(extras.__all__)
    + list(tail.__all__)
)

# the generated `<op>_` in-place variants over the assembled namespace
from .extras import _register_inplace as _reg_inplace  # noqa: E402

__all__ += _reg_inplace(globals())
del _reg_inplace
