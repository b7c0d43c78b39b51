"""paddle_tpu_torch.jit: `TrainStep` (↔ paddle_tpu/jit/__init__.py:266-505).

The JAX package compiles forward, backward and the optimizer update into
one XLA program. PyTorch runs eagerly, so a `TrainStep` call runs them in
turn: the forward under `amp.auto_cast(level, dtype)` when an AMP level is
given, the loss in f32, `loss.backward()`, the optimizer's global-norm
clip when it has one (in f32 over every gradient, :364-371), then the
optimizer's rule on every parameter with the step counter t and the
optimizer's weight decay applied to every parameter (as `_build` does,
:299-300 and :373-390), on the f32 master copy under multi-precision. Each
gradient is freed as soon as its parameter is updated. The parameters are
updated in place (the JAX package's `sync_weights` write-back has nothing
to do here).

As in the reference, the clip in the step is the global-norm one: an
optimizer clip with a `clip_norm` (`ClipGradByGlobalNorm`, and
`ClipGradByNorm` too, whose norm the reference's step also takes over
every gradient) scales every gradient by clip_norm / max(norm, clip_norm);
`ClipGradByValue` is not applied by the step, as in the reference.

The update runs through the reference's sharding hooks, identities here,
which `DistributedTrainStep` overrides: `_shard_grad` (the gradient this
rank updates with), `_shard_param_for_update` (the tensor it updates: the
parameter or its shard), `_restore_param` (after the update: all-gather the
parameter from its shards), and `_grad_sq_sum` (the clip's squared sum).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import amp
from ..nn.clip import global_norm_scale, scale_grad

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
        # a fleet wrapper (HybridParallelOptimizer) holds the optimizer
        self.optimizer = getattr(optimizer, "_inner_opt", optimizer)
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.params = {k: p for k, p in model.named_parameters()
                       if p.requires_grad}
        self.optimizer._names = dict(self.params)

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
        for p in self.params.values():
            p.grad = None
        loss = self._loss(inputs, labels)
        loss.backward()
        self._update()
        return loss.detach()

    @torch.no_grad()
    def _update(self):
        opt = self.optimizer
        opt._step_count += 1
        ctx = {"step": opt._step_count, "weight_decay": opt._decay_coeff()}
        lr = opt.get_lr()
        grads = {k: self._shard_grad(k, p.grad) for k, p in self.params.items()}
        clip_norm = getattr(opt._grad_clip, "clip_norm", None)
        if clip_norm is not None:
            scale = global_norm_scale(self._grad_sq_sum(grads), clip_norm)
            grads = {k: None if g is None else scale_grad(g, scale)
                     for k, g in grads.items()}
        for k, p in self.params.items():
            self._apply(k, p, grads.pop(k), lr, ctx)
            p.grad = None
            self._restore_param(k, p)

    def _apply(self, name, p, g, lr, ctx):
        self.optimizer.apply_update(p, g, lr, ctx,
                                    target=self._shard_param_for_update(name, p))

    # the reference's sharding hooks (jit/__init__.py:379-390); identities
    # here, overridden by DistributedTrainStep
    def _shard_grad(self, name, g):
        return g

    def _shard_param_for_update(self, name, p):
        return p

    def _restore_param(self, name, p):
        pass

    def _grad_sq_sum(self, grads):
        """The squared sum of every gradient, in f32."""
        return sum(g.float().square().sum() for g in grads.values()
                   if g is not None)

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
