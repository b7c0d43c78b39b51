"""Loss functionals (↔ paddle_tpu/nn/functional/loss.py).

Only the hot path of `cross_entropy` is ported: hard integer labels over the
last axis, softmax on, no class weights, no label smoothing, with
`ignore_index` rows contributing 0 and the mean taken over the valid rows
(JAX `loss.py:175-190`). Its gradient is `SparseCrossEntropy` (↔
`_sparse_ce` :96-133), which saves only the logits and the f32 row
log-sum-exp and recomputes the softmax in the backward, so the f32
log-probs of a [B, S, vocab] logits tensor are never kept. The other modes
raise NotImplementedError naming their ROADMAP item.

A reducing loss notes how it reduced (`note_reduction`): a mean over how
many terms, or a sum. `DistributedTrainStep` reads the notes taken while
its `loss_fn` runs (`record_reductions`) to turn each rank's loss into its
share of the loss over the global batch; `cross_entropy` and
`models.GPTPretrainingCriterion` note theirs.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ... import amp

__all__ = ["SparseCrossEntropy", "cross_entropy", "note_reduction",
           "record_reductions"]

# the list that the innermost record_reductions opened, else None
_NOTES = contextvars.ContextVar("loss_reductions", default=None)


@contextlib.contextmanager
def record_reductions():
    """Collect the `note_reduction` calls made inside the block into the
    list it yields."""
    notes = []
    token = _NOTES.set(notes)
    try:
        yield notes
    finally:
        _NOTES.reset(token)


def note_reduction(kind, count=None, denom=None):
    """Note, for a recording step, that a loss was reduced: kind "mean"
    (divided by `denom`, which stands for `count` terms: a global mean
    divides the global sum by the larger of 1 and the sum of the counts)
    or "sum"."""
    notes = _NOTES.get()
    if notes is not None:
        notes.append((kind, count, denom))


class SparseCrossEntropy(torch.autograd.Function):
    """loss[...] = logsumexp(logits[..., :]) - logits[..., id] in f32; the
    backward is (softmax - onehot) * g, recomputed from (logits, lse)."""

    @staticmethod
    def forward(ctx, logits, ids):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        tgt = lf.gather(-1, ids[..., None])[..., 0]
        ctx.save_for_backward(logits, ids, lse)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        logits, ids, lse = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[..., None])  # softmax, recomputed
        d.scatter_add_(-1, ids[..., None],
                       torch.full_like(lse[..., None], -1.0))
        d.mul_(g[..., None])
        return d.to(logits.dtype), None


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of logits `input` [..., C] against integer
    labels [...] (or [..., 1]). reduction: "mean" (over rows whose label is
    not `ignore_index`), "sum" or "none". Casts for AMP as the op
    "cross_entropy" (black list: float32)."""
    if (weight is not None or soft_label or not use_softmax or label_smoothing
            or axis not in (-1, input.dim() - 1)):
        raise NotImplementedError(
            "cross_entropy with class weights, soft labels, label smoothing, "
            "use_softmax=False or a class axis other than the last is ported "
            "with the rest of the nn surface (ROADMAP A3)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    (logits,) = amp.cast_inputs("cross_entropy", input)
    ids = label.long()
    if ids.dim() == logits.dim() and ids.shape[-1] == 1:
        ids = ids[..., 0]
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    loss = torch.where(valid, SparseCrossEntropy.apply(logits, safe),
                       torch.zeros((), device=logits.device))
    if reduction == "mean":
        count = valid.float().sum()
        note_reduction("mean", count, count.clamp(min=1.0))
        return loss.sum() / count.clamp(min=1.0)
    if reduction == "sum":
        note_reduction("sum")
        return loss.sum()
    return loss
