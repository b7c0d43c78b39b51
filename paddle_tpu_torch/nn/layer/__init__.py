from . import (activation, common, container, conv, layers, loss, norm,
               pooling, transformer)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .layers import Layer, ParamAttr
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .norm import _BatchNormBase  # noqa: F401
from .pooling import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = sorted({
    "Layer", "ParamAttr", *activation.__all__, *common.__all__,
    *container.__all__, *conv.__all__, *loss.__all__, *norm.__all__,
    *pooling.__all__, *transformer.__all__})
