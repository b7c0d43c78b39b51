"""paddle_tpu_torch.jit: `TrainStep` (↔ paddle_tpu/jit/__init__.py:266-505).

The JAX package compiles forward, backward and the optimizer update into
one XLA program. PyTorch runs eagerly, so a `TrainStep` call runs them in
turn: the forward under `amp.auto_cast(level, dtype)` when an AMP level is
given, the loss in f32, `loss.backward()`, then the optimizer's rule on
every parameter with the step counter t and the optimizer's weight decay
applied to every parameter (as `_build` does, :299-300 and :373-390), on
the f32 master copy under multi-precision. Each gradient is freed as soon
as its parameter is updated. The parameters are updated in place (the
JAX package's `sync_weights` write-back has nothing to do here).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import amp

__all__ = ["TrainStep"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _amp_ctx(level, dtype):
    if level in ("O1", "O2"):
        return amp.auto_cast(True, level=level, dtype=dtype)
    return contextlib.nullcontext()


class TrainStep:
    """One training step per call: `loss = step(inputs, labels)`.

    `loss_fn(*model_outputs, *labels)` gives the loss; the call returns it
    as a 0-d f32 tensor on the model's device. The optimizer keeps the
    state (`optimizer._states`) and the step count (`optimizer._step_count`),
    so an eager `optimizer.step()` and this step share them."""

    def __init__(self, model, loss_fn, optimizer, amp_level=None,
                 amp_dtype="bfloat16"):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.params = {k: p for k, p in model.named_parameters()
                       if p.requires_grad}
        optimizer._names = dict(self.params)

    @property
    def opt_states(self):
        """{parameter name: optimizer state} (empty before the first step)."""
        return {k: self.optimizer._states[id(p)] for k, p in self.params.items()
                if id(p) in self.optimizer._states}

    def _device(self):
        return next(iter(self.params.values())).device

    def _batch(self, xs):
        dev = self._device()
        return [x.to(dev) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev)
                for x in _as_list(xs)]

    def _loss(self, inputs, labels):
        with _amp_ctx(self.amp_level, self.amp_dtype):
            out = self.model(*inputs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            loss = self.loss_fn(*outs, *labels)
        return loss.float()

    def __call__(self, inputs, labels):
        inputs, labels = self._batch(inputs), self._batch(labels)
        opt = self.optimizer
        for p in self.params.values():
            p.grad = None
        loss = self._loss(inputs, labels)
        loss.backward()
        opt._step_count += 1
        ctx = {"step": opt._step_count, "weight_decay": opt._decay_coeff()}
        lr = opt.get_lr()
        for p in self.params.values():
            opt.apply_update(p, p.grad, lr, ctx)
            p.grad = None
        return loss.detach()

    @torch.no_grad()
    def evaluate(self, inputs, labels):
        """The loss in eval mode, without a gradient or an update."""
        was_training = self.model.training
        self.model.eval()
        try:
            return self._loss(self._batch(inputs), self._batch(labels))
        finally:
            if was_training:
                self.model.train()
