"""paddle_tpu_torch.vision (↔ paddle_tpu/vision): the ResNet family so far;
the rest of the model zoo, datasets and transforms are ROADMAP queue A
item 8."""

from . import models
from .models import *  # noqa: F401,F403
from .models import __all__
