"""paddle_tpu_torch.optimizer (↔ paddle_tpu/optimizer): the optimizers,
`LBFGS` and the learning-rate schedulers (`optimizer.lr`)."""

from . import lr
from .lbfgs import LBFGS
from .optimizer import (ASGD, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        Lamb, Lars, Momentum, NAdam, Optimizer, RAdam, RMSProp,
                        Rprop)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "LBFGS",
           "Lamb", "Lars", "Momentum", "NAdam", "Optimizer", "RAdam",
           "RMSProp", "Rprop", "SGD", "lr"]
