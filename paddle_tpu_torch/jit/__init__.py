"""paddle_tpu_torch.jit: `TrainStep` (↔ paddle_tpu/jit/__init__.py:266-505).

The JAX package compiles forward, backward and the optimizer update into
one XLA program. PyTorch runs eagerly, so a `TrainStep` call runs them in
turn: the forward under `amp.auto_cast(level, dtype)` when an AMP level is
given, the loss in f32, `loss.backward()`, the optimizer's global-norm
clip when it has one (in f32 over every gradient, :364-371), then the
optimizer's rule on every parameter with the step counter t, the
learning rate `optimizer.get_lr()` read anew on each call (a scheduler's
current rate) times the parameter's `optimize_attr["learning_rate"]`
(`Optimizer._param_lr`, as the reference's eager step, :130; its compiled
step ignores the factor, ROADMAP queue C) and the parameter's weight
decay (`_param_decay`: the
optimizer's coefficient, as `_build` applies it, :299-300 and :373-390,
but for the parameters an `AdamW.apply_decay_param_fun` refuses, which
the reference's compiled step decays too and its eager `step()` does
not), on the f32 master copy under multi-precision. Each
gradient is freed as soon as its parameter is updated. The parameters are
updated in place (the JAX package's `sync_weights` write-back has nothing
to do here).

A parameter's regularizer (`ParamAttr(regularizer=...)`) adds its term
to the gradient before the clip, on the piece of the parameter the rank
updates (`_shard_param_for_update`: the term is elementwise), and takes
the place of the optimizer's weight decay for it, as in the reference
(:301-313, :356-362). As in the reference, the clip in the step is the
global-norm one: an optimizer clip with a `clip_norm`
(`ClipGradByGlobalNorm`, and `ClipGradByNorm` too, whose norm the
reference's step also takes over every gradient) scales the gradients by
clip_norm / max(norm, clip_norm); a parameter with `need_clip = False`
is left out of the norm and of the scaling, as the eager clip leaves it
(the reference's compiled step clips it: ROADMAP queue C).
`ClipGradByValue` is not applied by the step, as in the reference.

Buffers (a batch norm's running statistics) are the model's own tensors,
which its forward updates in place in training: once a step, as the
reference threads them through its program and returns their new values
(:58-112, :464-465); `evaluate` runs the model in eval mode and leaves
them alone.

A model with `pp_schedule == "1f1b"` (`models.GPTForCausalLMPipe`) takes
the reference's `forward_loss` route (:315-320, :336-340): the step calls
`model.forward_loss(input_ids, labels, criterion, *more_labels)` (the
token ids are its one input, as the reference's; another raises), which
runs each microbatch's forward and backward itself, and the step then
updates. The
criterion is `loss_fn` on a microbatch, weighted as the loss must come out:
at more than one stage the mean over the microbatches of `loss_fn` on each
(global) microbatch, as the reference; at one stage `loss_fn` over the
whole batch, as the reference's pp = 1 path (:323-324): a mean that notes
its count (`nn.functional.loss.note_reduction`) is weighted by its count,
and the loss and the gradients are divided by the total count after the
schedule. Without a gradient (`evaluate`) the model's `forward` serves.

The update runs through the reference's sharding hooks, identities here,
which `DistributedTrainStep` overrides: `_shard_grad` (the gradient this
rank updates with), `_shard_param_for_update` (the tensor it updates: the
parameter or its shard), `_restore_param` (after the update: all-gather the
parameter from its shards), and `_grad_sq_sum` (the clip's squared sum).

`train_state()` is the step's whole training state as one flat dict for
`distributed.checkpoint` (`CheckpointManager.save(step.train_state(), n)`,
`restore_latest(step.train_state())`): the model's parameters and buffers
under their `state_dict` names, the optimizer's state under the names of
the reference's `Optimizer.state_dict()` (`paddle_tpu/optimizer/
optimizer.py:159-190`) flattened with dots, `optimizer.param_{i}.{key}`
for the i-th parameter of the optimizer's list, and
`optimizer._step_count`. The entries are the live tensors, so a load
writes them in place; the states are made first if no step has run yet.
The step holds no loss scaler and no learning-rate scheduler state of its
own, so neither is among them. A step's call runs under a span
`train_step/compiled` of kind "compute" (the reference's, :457-463).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import amp
from ..framework.core import Tensor
from ..nn.clip import global_norm_scale, scale_grad
from ..nn.functional.loss import record_reductions
from ..observability.spans import span

__all__ = ["TrainState", "TrainStep"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _amp_ctx(level, dtype):
    if level in ("O1", "O2"):
        return amp.auto_cast(True, level=level, dtype=dtype)
    return contextlib.nullcontext()


class TrainState(dict):
    """A step's training state as one flat dict of its live tensors (the
    module docstring); `after_load()` (which `distributed.checkpoint`'s
    load calls) writes the loaded step count back to the optimizer."""

    def __init__(self, optimizer):
        super().__init__()
        self._optimizer = optimizer
        self._step_count = torch.tensor(optimizer._step_count,
                                        dtype=torch.int64)
        self["optimizer._step_count"] = self._step_count

    def after_load(self):
        self._optimizer._step_count = int(self._step_count)


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
        self._grad_factor = None   # the 1F1B whole-batch scale of one step
        self._counts = []

    @property
    def opt_states(self):
        """{parameter name: optimizer state} (empty before the first step)."""
        return {k: self.optimizer._states[id(p)] for k, p in self.params.items()
                if id(p) in self.optimizer._states}

    def _device(self):
        return next(iter(self.params.values())).device

    def _batch(self, xs):
        """The step's inputs as tensors on the model's device: a Paddle
        `Tensor` by its held tensor (never through the host), a torch
        tensor as it is, host data through numpy."""
        dev = self._device()
        xs = [x._value if isinstance(x, Tensor) else x for x in _as_list(xs)]
        return [x.to(dev) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev) for x in xs]

    def _batches(self, inputs, labels):
        return self._batch(inputs), self._batch(labels)

    def _loss_fn(self, outs, labels, whole_of=0):
        """The loss to back-propagate: the loss times its weight. A loss
        that noted several reductions, each with its term, keeps the rest
        of itself (an auxiliary loss, a regulariser) at weight 1 and
        re-weighs each term by its own weight: loss + sum(term * (w - 1)),
        the terms taken as added to the loss once each. Several notes of
        which one lacks its term, or several in a one-stage 1F1B pipeline,
        keep the loss at weight 1."""
        with record_reductions() as notes:
            loss = self.loss_fn(*outs, *labels).float()
        if (len(notes) > 1 and not whole_of
                and all(note[3] is not None for note in notes)):
            return loss + sum(
                note[3].float() * (self._loss_weight([note], note[3]) - 1.0)
                for note in notes)
        return loss * self._loss_weight(notes, loss, whole_of)

    def _loss_weight(self, notes, loss, whole_of=0):
        """This rank's weight of its loss (or of one noted term): 1 here,
        where one rank holds the whole batch. `whole_of` = M: a microbatch
        of M whose loss adds up to the whole batch's (module docstring); a
        mean's count is kept in `_counts`."""
        if len(notes) != 1 or not whole_of:
            return 1.0
        kind, count, denom, _ = notes[0]
        if kind == "sum":
            return float(whole_of)
        self._counts.append(count)
        return whole_of * denom

    def _sum_counts(self, count):
        return torch.as_tensor(count, dtype=torch.float32,
                               device=self._device()).detach().clone()

    def _pipelined(self):
        return (getattr(self.model, "pp_schedule", None) == "1f1b"
                and torch.is_grad_enabled())

    def _pipeline_loss(self, inputs, labels):
        """The forward_loss route (module docstring)."""
        model = self.model
        if len(inputs) != 1:
            # the reference's forward_loss takes the token ids alone, and
            # fails on another input
            raise ValueError(f"the 1f1b route takes input_ids alone, got "
                             f"{len(inputs)} inputs")
        whole_of = model.num_microbatches if model.num_stages() == 1 else 0
        self._counts = []

        def criterion(logits, *labs):
            return self._loss_fn([logits], labs, whole_of)

        loss = model.forward_loss(inputs[0], labels[0], criterion,
                                  *labels[1:])
        if self._counts:
            total = self._sum_counts(sum(self._counts))
            self._grad_factor = 1.0 / total.clamp(min=1.0)
            loss = loss * self._grad_factor
        return loss

    def _loss(self, inputs, labels):
        with _amp_ctx(self.amp_level, self.amp_dtype):
            if self._pipelined():
                return self._pipeline_loss(inputs, labels)
            out = self.model(*inputs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            return self._loss_fn(outs, labels)

    def __call__(self, inputs, labels):
        # kind="compute": the step's compute interval for the overlap
        # accounting (observability.spans.overlap_stats); host time, as the
        # kernels run asynchronously
        with span("train_step/compiled", kind="compute"):
            inputs, labels = self._batches(inputs, labels)
            for p in self.params.values():
                p.grad = None
            self._grad_factor = None
            loss = self._loss(inputs, labels)
            if not self._pipelined():
                loss.backward()
            self._update()
            return loss.detach()

    # -- the training state (module docstring) ----------------------------- #

    def _init_states(self):
        """Make every parameter's optimizer state that no step has made."""
        for k, p in self.params.items():
            if id(p) not in self.optimizer._states:
                self.optimizer._get_state(p, self._shard_param_for_update(k, p))

    def _placement(self, name, t, state):
        """The checkpoint entry of tensor t: a parameter `name` (state
        False), one of its optimizer states (state True) or a buffer (name
        None). Whole here; `DistributedTrainStep` gives this rank's
        shards."""
        return t

    def train_state(self):
        """{name: live tensor} of the parameters, buffers and optimizer
        state (module docstring)."""
        opt = self.optimizer
        self._init_states()
        names = {id(p): k for k, p in self.params.items()}
        out = TrainState(opt)
        for k, v in self.model.state_dict(keep_vars=True).items():
            out[k] = self._placement(names.get(id(v)), v.detach(), False)
        for i, p in enumerate(opt._params()):
            st = opt._states.get(id(p))
            for key, v in (st or {}).items():
                out[f"optimizer.param_{i}.{key}"] = self._placement(
                    names.get(id(p)), v, True)
        return out

    @torch.no_grad()
    def _update(self):
        opt = self.optimizer
        opt._step_count += 1
        ctx = {"step": opt._step_count}
        lr = opt.get_lr()
        grads = {k: self._shard_grad(k, p.grad) for k, p in self.params.items()}
        if self._grad_factor is not None:
            grads = {k: None if g is None else scale_grad(g, self._grad_factor)
                     for k, g in grads.items()}
        for k, p in self.params.items():
            reg = p.__dict__.get("regularizer")
            if reg is not None and grads[k] is not None:
                grads[k] = reg.add_to(grads[k],
                                      self._shard_param_for_update(k, p))
        clip_norm = getattr(opt._grad_clip, "clip_norm", None)
        if clip_norm is not None:
            clipped = {k for k, p in self.params.items()
                       if getattr(p, "need_clip", True)}
            scale = global_norm_scale(self._grad_sq_sum(
                {k: g if k in clipped else None for k, g in grads.items()}),
                clip_norm)
            grads = {k: scale_grad(g, scale) if g is not None and k in clipped
                     else g for k, g in grads.items()}
        for k, p in self.params.items():
            pctx = dict(ctx, weight_decay=opt._param_decay(k, p))
            self._apply(k, p, grads.pop(k), opt._param_lr(lr, p), pctx)
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
            return self._loss(*self._batches(inputs, labels))
        finally:
            if was_training:
                self.model.train()
