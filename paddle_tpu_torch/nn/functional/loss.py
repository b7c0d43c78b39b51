"""Loss functionals (↔ paddle_tpu/nn/functional/loss.py).

Of `cross_entropy` the hot path is ported: hard integer labels over the
last axis, softmax on, no class weights, no label smoothing, with
`ignore_index` rows contributing 0 and the mean taken over the valid rows
(JAX `loss.py:175-190`). Its gradient is `SparseCrossEntropy` (↔
`_sparse_ce` :96-133), which saves only the logits and the f32 row
log-sum-exp and recomputes the softmax in the backward, so the f32
log-probs of a [B, S, vocab] logits tensor are never kept. The other modes
raise NotImplementedError naming their ROADMAP item.

The elementwise losses (:229-395: `mse_loss`, `l1_loss`, `nll_loss`,
`binary_cross_entropy(_with_logits)`, `smooth_l1_loss`, `kl_div`,
`margin_ranking_loss`, `cosine_embedding_loss`, `triplet_margin_loss`,
`hinge_embedding_loss`, `square_error_cost`, `log_loss`) are the
reference's jnp expressions as torch ops, reduced by its `_reduce`
("mean", "sum" or "none"). Each casts its inputs for AMP under the
reference's op name: "bce", "bce_with_logits" and "kl_div" are on the
black list (f32); the others, `mse_loss` among them, compute in bf16
under O2 as the reference's do. `ctc_loss` raises NotImplementedError
(ROADMAP queue A item 8).

A reducing loss notes how it reduced (`note_reduction`): a mean over how
many terms, or a sum; a loss that adds several reductions up notes each
with the term it gave. `DistributedTrainStep` reads the notes taken while
its `loss_fn` runs (`record_reductions`) to turn each rank's loss into its
share of the loss over the global batch; `cross_entropy`,
`models.GPTPretrainingCriterion` and `models.BertPretrainingCriterion`
(two terms) note theirs.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ... import amp

__all__ = ["SparseCrossEntropy", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "cosine_embedding_loss",
           "cross_entropy", "ctc_loss", "hinge_embedding_loss", "kl_div",
           "l1_loss", "log_loss", "margin_ranking_loss", "mse_loss",
           "nll_loss", "note_reduction", "record_reductions",
           "smooth_l1_loss", "square_error_cost", "triplet_margin_loss"]

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


def note_reduction(kind, count=None, denom=None, term=None):
    """Note, for a recording step, that a loss was reduced: kind "mean"
    (divided by `denom`, which stands for `count` terms: a global mean
    divides the global sum by the larger of 1 and the sum of the counts)
    or "sum". A loss that sums several reductions notes each with its
    `term`, the tensor it gave; the terms add up to the loss."""
    notes = _NOTES.get()
    if notes is not None:
        notes.append((kind, count, denom, term))


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
            "with ROADMAP queue A item 4")
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


def _reduce(v, reduction):
    """The reference's `_reduce` (:88): the mean, the sum, or v as it is
    ("none"); a mean or sum is noted for a recording step."""
    if reduction == "mean":
        note_reduction("mean", float(v.numel()), float(max(v.numel(), 1)))
        return v.mean()
    if reduction == "sum":
        note_reduction("sum")
        return v.sum()
    return v


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    a, b = amp.cast_inputs("mse_loss", input, label)
    return _reduce((a - b).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    a, b = amp.cast_inputs("l1_loss", input, label)
    return _reduce((a - b).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """-input[n, label[n], ...] over the rows whose label is not
    `ignore_index` (the class axis is 1); with `weight`, each row weighted
    by its class's, the mean dividing by the weights' sum."""
    logp, label, weight = amp.cast_inputs("nll_loss", input, label, weight)
    ids = label.long()
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    loss = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        sw = weight[safe] * valid.to(logp.dtype)
        loss = loss * sw
        if reduction == "mean":
            note_reduction("mean", sw.sum(), sw.sum().clamp(min=1e-12))
            return torch.where(valid, loss, zero).sum() / sw.sum().clamp(min=1e-12)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        count = valid.to(logp.dtype).sum()
        note_reduction("mean", count, count.clamp(min=1.0))
        return loss.sum() / count.clamp(min=1.0)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",  # noqa: A002
                         name=None):
    p, y, w = amp.cast_inputs("bce", input, label, weight)
    p = p.clamp(1e-12, 1 - 1e-12)
    loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable form: log sigmoid(z) = -softplus(-z) and
    log(1 - sigmoid(z)) = -z - softplus(-z), softplus(x) = log(1 + e^x)."""
    z, y, w, pw = amp.cast_inputs("bce_with_logits", logit, label, weight,
                                  pos_weight)
    softplus = torch.logaddexp(-z, torch.zeros_like(z))
    log_sig_pos = -softplus
    log_sig_neg = -z - softplus
    pos = y * log_sig_pos if pw is None else pw * y * log_sig_pos
    loss = -(pos + (1 - y) * log_sig_neg)
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    a, b = amp.cast_inputs("smooth_l1", input, label)
    d = (a - b).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False,  # noqa: A002
           name=None):
    logp, tgt = amp.cast_inputs("kl_div", input, label)
    if log_target:
        loss = torch.exp(tgt) * (tgt - logp)
    else:
        loss = tgt * (torch.log(tgt.clamp(min=1e-12)) - logp)
        loss = torch.where(tgt > 0, loss, torch.zeros_like(loss))
    if reduction == "batchmean":  # over equal batches: the equal-count mean
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    a, b, y = amp.cast_inputs("margin_ranking", input, other, label)
    return _reduce((-y * (a - b) + margin).clamp(min=0.0), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b, y = amp.cast_inputs("cosine_embedding", input1, input2, label)
    cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                             * torch.linalg.vector_norm(b, dim=-1) + 1e-12)
    loss = torch.where(y > 0, 1 - cos, (cos - margin).clamp(min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,  # noqa: A002
                        epsilon=1e-6, swap=False, reduction="mean", name=None):
    a, pos, neg = amp.cast_inputs("triplet_margin", input, positive, negative)

    def dist(x, y):
        return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1)

    dp, dn = dist(a, pos), dist(a, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos, neg))
    return _reduce((dp - dn + margin).clamp(min=0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",  # noqa: A002
                         name=None):
    a, y = amp.cast_inputs("hinge_embedding", input, label)
    return _reduce(torch.where(y > 0, a, (margin - a).clamp(min=0.0)),
                   reduction)


def square_error_cost(input, label):  # noqa: A002
    a, b = amp.cast_inputs("square_error_cost", input, label)
    return (a - b).square()


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    p, y = amp.cast_inputs("log_loss", input, label)
    return -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    raise NotImplementedError(
        "ctc_loss (the reference's lax.scan forward algorithm) is ported with "
        "ROADMAP queue A item 8")
