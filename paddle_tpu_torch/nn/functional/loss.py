"""Loss functionals (↔ paddle_tpu/nn/functional/loss.py).

`cross_entropy` (JAX `loss.py:136-215`) has two routes. The hot path, hard
integer labels over the last axis with the softmax on, no class weights
and no label smoothing, with `ignore_index` rows contributing 0 and the
mean taken over the valid rows (:175-190), runs `SparseCrossEntropy` (↔
`_sparse_ce` :96-133), which saves only the logits and the f32 row
log-sum-exp and recomputes the softmax in the backward, so the f32
log-probs of a [B, S, vocab] logits tensor are never kept. Every other mode
is the reference's composite in f32 torch ops: class `weight` (the mean
divides by the valid rows' weights, which is also the count it notes for
a sharded step), `soft_label` (a distribution over the classes; its weight
is sum(label * weight); a plain mean), `label_smoothing`,
`use_softmax=False` (the input is taken as probabilities: log of it
clipped at 1e-30) and any class `axis`. `softmax_with_cross_entropy`
(:216) is its reduction "none" with the class axis kept, and the softmax
with `return_softmax`.

`sigmoid_focal_loss` (:449, an optional `normalizer` dividing every term),
`hsigmoid_loss` (:468: the default heap tree, or a custom `path_table` /
`path_code`, -1 padded), `margin_cross_entropy` (:527: the ArcFace-family
margins; over an mp `group` the logits are this rank's class shard and the
row max, the exp sum and the target logit reduce over the group, the sum
and the target through `collective.mp_allreduce` so the gradient flows)
and `class_center_sample` (:35: host-side, a data-dependent set; over a
group the ranks' labels are gathered so every rank keeps the positives of
its shard, and the negatives are drawn from the port's generator,
`framework.random`) are the reference's.

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
import math

import torch

from ... import amp
from ...framework.core import reported

__all__ = ["SparseCrossEntropy", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "class_center_sample",
           "cosine_embedding_loss", "cross_entropy", "ctc_loss",
           "hinge_embedding_loss", "hsigmoid_loss", "kl_div", "l1_loss",
           "log_loss", "margin_cross_entropy", "margin_ranking_loss",
           "mse_loss", "nll_loss", "note_reduction", "record_reductions",
           "sigmoid_focal_loss", "smooth_l1_loss",
           "softmax_with_cross_entropy", "square_error_cost",
           "triplet_margin_loss"]

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


@reported("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of logits `input` [..., C, ...] (classes on
    `axis`) against integer labels (the input's shape without the class
    axis, or with it of size 1) or, with `soft_label`, a distribution like
    the input. reduction: "mean" (over rows whose label is not
    `ignore_index`; with `weight`, divided by their weights' sum), "sum"
    or "none". Casts for AMP as the op "cross_entropy" (black list:
    float32)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    hot = (weight is None and not soft_label and use_softmax
           and not label_smoothing and axis in (-1, input.dim() - 1))
    if not hot:
        return _cross_entropy_composite(input, label, weight, ignore_index,
                                        reduction, soft_label, axis,
                                        use_softmax, label_smoothing)
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


def _cross_entropy_composite(input, label, weight, ignore_index, reduction,  # noqa: A002
                             soft_label, axis, use_softmax, label_smoothing):
    """The reference's composite route of `cross_entropy` (:155-215), in
    f32."""
    logits, label, weight = amp.cast_inputs("cross_entropy", input, label,
                                            weight)
    axis = axis % logits.dim()
    lf = logits.float()
    logp = (torch.log_softmax(lf, dim=axis) if use_softmax
            else torch.log(lf.clamp(min=1e-30)))
    k = logits.shape[axis]
    if soft_label:
        tgt = label.float()
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / k
        loss = -(tgt * logp).sum(axis)
        if weight is not None:
            w = weight.float().reshape([-1 if d == axis else 1
                                        for d in range(logp.dim())])
            loss = loss * (tgt * w).sum(axis)
        return _reduce(loss, reduction)
    ids = label.long()
    if ids.dim() == logits.dim() and ids.shape[axis] == 1:
        ids = ids.squeeze(axis)
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        loss = -((1 - label_smoothing) * picked
                 + label_smoothing * logp.mean(axis))
    else:
        loss = -picked
    if weight is not None:
        sample_w = weight.float()[safe] * valid.float()
        loss = loss * sample_w
        if reduction == "mean":
            total = sample_w.sum()
            note_reduction("mean", total, total.clamp(min=1e-12))
            return loss.sum() / total.clamp(min=1e-12)
    loss = torch.where(valid, loss, torch.zeros((), device=loss.device))
    if reduction == "mean":
        count = valid.float().sum()
        note_reduction("mean", count, count.clamp(min=1.0))
        return loss.sum() / count.clamp(min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """`cross_entropy` with reduction "none", the class axis kept (size 1);
    with `return_softmax` also the softmax of the logits over `axis` (the
    reference :216)."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
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


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """alpha_t (1 - p_t)^gamma BCE(logit, label) (the reference :449), each
    term divided by `normalizer` where given."""
    z, y, n = amp.cast_inputs("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = (torch.nn.functional.softplus(-z) * y
          + torch.nn.functional.softplus(z) * (1 - y))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if n is not None:
        loss = loss / n
    return _reduce(loss, reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss [N, 1] (the reference :468): the sum over
    a path of internal nodes of softplus(logit) - code * logit, logit =
    x . w[node] (+ b[node]). The default tree is the complete binary tree
    in heap order: class l is leaf l + C, its path the ancestors
    (l + C) >> d down from the root, node n reading row n - 1, the code the
    next bit of l + C. A custom tree gives the rows `path_table` [N, L] and
    the codes `path_code` [N, L], -1 padded."""
    x, w, b = amp.cast_inputs("hsigmoid_loss", input, weight, bias)
    if path_table is not None:
        pt = path_table.long()
        valid = (pt >= 0).to(x.dtype)
        rows = pt.clamp(0, w.shape[0] - 1)
        code = path_code.to(x.dtype)
    else:
        C = int(num_classes)
        depth = max(int(math.ceil(math.log2(max(C, 2)))), 1)
        heap = label.reshape(-1).long() + C
        ks = torch.arange(depth, 0, -1, device=heap.device)
        anc = heap[:, None] >> ks[None, :]  # ancestors, root first
        valid = (anc >= 1).to(x.dtype)
        code = ((heap[:, None] >> (ks[None, :] - 1)) & 1).to(x.dtype)
        rows = (anc - 1).clamp(0, w.shape[0] - 1)
    logit = torch.einsum("nd,nld->nl", x, w[rows])
    if b is not None:
        logit = logit + b[rows].reshape(logit.shape)
    per = (torch.nn.functional.softplus(logit) - code * logit) * valid
    return per.sum(-1, keepdim=True)


def _group_place(group):
    """(ranks, this rank's index) of an mp `group` (a `collective.Group`),
    or (1, 0) without one."""
    if group is None or group is False or isinstance(group, bool):
        return 1, 0
    from ...distributed import env

    return group.nranks, group.ranks.index(env.get_rank())


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """The ArcFace-family margin softmax cross entropy (the reference
    :527): the true class's cosine cos(theta) becomes
    cos(m1 theta + m2) - m3, every logit is scaled by `scale`, and the loss
    is [N, 1] of lse - the target logit (reduced by `reduction`: "mean",
    "sum" or None). Over an mp `group` `logits` is this rank's class shard
    [N, C / n] (classes [rank C / n, ...)): the softmax's row max, exp sum
    and the target logit reduce over the group, the reference's three
    collectives; the softmax returned is this rank's shard."""
    from ...distributed import collective as C

    nranks, rank = _group_place(group)
    c_local = logits.shape[1]
    offset = rank * c_local
    lab = label.reshape(-1).long()
    local = (lab >= offset) & (lab < offset + c_local)
    idx = (lab - offset).clamp(0, c_local - 1)
    rows = torch.arange(logits.shape[0], device=logits.device)
    target = logits[rows, idx]
    theta = torch.acos(target.clamp(-1.0, 1.0))
    modified = torch.cos(margin1 * theta + margin2) - margin3
    onehot = torch.zeros_like(logits, dtype=torch.bool)
    onehot[rows, idx] = local
    scaled = torch.where(onehot, modified[:, None], logits) * scale
    if nranks > 1:
        pg = group.process_group
        mx = scaled.detach().amax(1, keepdim=True)
        C._all_reduce(mx, pg, op=torch.distributed.ReduceOp.MAX)
        e = torch.exp(scaled - mx)
        ssum = C.mp_allreduce(e.sum(1, keepdim=True), pg)
        softmax = e / ssum
        tlogit = C.mp_allreduce(
            torch.where(local, scaled[rows, idx],
                        torch.zeros((), dtype=scaled.dtype,
                                    device=scaled.device)), pg)
        loss = (torch.log(ssum).reshape(-1) + mx.reshape(-1)
                - tlogit).reshape(-1, 1)
    else:
        loss = (torch.logsumexp(scaled, 1)
                - scaled[rows, lab]).reshape(-1, 1)
        softmax = torch.softmax(scaled, 1)
    if reduction == "mean":
        note_reduction("mean", float(loss.numel()), float(max(loss.numel(), 1)))
        loss = loss.mean()
    elif reduction == "sum":
        note_reduction("sum")
        loss = loss.sum()
    elif reduction is not None:
        raise ValueError(f"unknown reduction {reduction!r}")
    if return_softmax:
        return loss, softmax
    return loss


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC class-center sampling (the reference :35): (the labels
    remapped into the sampled centers' index space, the sampled centers of
    this rank's shard of `num_classes`). Every positive center of the shard
    is kept; negatives drawn uniformly from the rest (the port's generator,
    `framework.random.generator`) fill the set up to `num_samples`.
    Host-side: the set's size depends on the data. Over an mp `group` the
    ranks' labels are gathered first, so each rank keeps the positives of
    its own shard of every rank's labels, and a label outside this rank's
    shard is kept as it is."""
    import numpy as np

    from ...framework import random as _random

    lab = label.detach().reshape(-1).long().cpu().numpy()
    nranks, rank = _group_place(group)
    all_lab = lab
    if nranks > 1:
        from ...distributed import collective as C

        gathered = []
        C.all_gather_object(gathered, lab.tolist(), group)
        all_lab = np.asarray(sorted({v for part in gathered for v in part}),
                             np.int64)
    per = num_classes
    offset = rank * per if nranks > 1 else 0
    in_shard = (all_lab >= offset) & (all_lab < offset + per)
    pos = np.unique(all_lab[in_shard] - offset)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        pool = torch.as_tensor(np.setdiff1d(np.arange(per), pos,
                                            assume_unique=True))
        draw = torch.randperm(len(pool), generator=_random.generator("cpu"))
        extra = pool[draw[:num_samples - len(pos)]].numpy()
        sampled = np.concatenate([pos, np.sort(extra)])
    remap = np.full(per, -1, np.int64)
    remap[sampled] = np.arange(len(sampled))
    own = (lab >= offset) & (lab < offset + per)
    new_label = np.where(own, remap[np.clip(lab - offset, 0, per - 1)], lab)
    dev = label.device
    return (torch.as_tensor(new_label, dtype=torch.int64, device=dev),
            torch.as_tensor(sampled.astype(np.int64), device=dev))
