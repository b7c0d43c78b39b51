"""Per-parameter regularizers (↔ paddle_tpu/regularizer.py): `L1Decay`
and `L2Decay`.

`ParamAttr(regularizer=...)` attaches one to a parameter. The optimizer's
eager `step()` and the steps of `jit.TrainStep` / `DistributedTrainStep`
add its term to the parameter's gradient before the gradient is clipped,
and for that parameter it replaces the optimizer's own weight decay
(`Optimizer._param_decay`). The term is elementwise, so on a rank that
updates a shard of a parameter it is taken on that shard.
"""

from __future__ import annotations

import torch

from .framework.core import run_op

__all__ = ["L1Decay", "L2Decay"]


class _Decay:
    _op = None

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def add_to(self, g, p):
        """Gradient g of torch tensor p with the term added: in f32, then
        in g's dtype."""
        return (g.float() + self._term(p.detach().float())).to(g.dtype)

    def __call__(self, param):
        """The term as a Paddle `Tensor` (the reference's call)."""
        return run_op(self._op, self._term, [param])

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(_Decay):
    """grad += coeff * sign(param)."""

    _op = "l1_decay_grad"

    def _term(self, p):
        return self._coeff * torch.sign(p)


class L2Decay(_Decay):
    """grad += coeff * param."""

    _op = "l2_decay_grad"

    def _term(self, p):
        return self._coeff * p
