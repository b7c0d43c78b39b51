"""The rank cases of `tests/test_torch_bert.py` and `tests/test_torch_resnet.py`
(suites "bert_dp" and "resnet_dp" of `tests/torch_dist_worker.py`): a
model of the port trained at dp = WORLD through `DistributedTrainStep`,
each rank on its rows of the global batch. Imports torch and the port
only; the JAX package's weights and the data come in `inp`."""

import contextlib
import traceback

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import train_step
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW, Momentum


def _run(out, name, fn):
    try:
        out[name] = fn()
    except Exception:  # the case's test reports the traceback
        out[name] = "ERROR " + traceback.format_exc()


def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in dist.full_state_dict(model).items()}


def bert_cases(rank, world, inp):
    from paddle_tpu_torch.models import BertForSequenceClassification, bert_tiny

    out = {}

    def seq_cls():
        cfg = bert_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
        model = BertForSequenceClassification(cfg, num_classes=2, device="cpu")
        load_paddle_tpu_state(model, inp["state"])
        step = dist.DistributedTrainStep(
            model, lambda lg, lb: F.cross_entropy(lg, lb),
            AdamW(learning_rate=inp["lr"], parameters=model.parameters()),
            mesh=dist.build_mesh(dp=world))
        xs = [inp["ids"], inp["tt"], inp["am"]]
        losses = [step(xs, inp["y"]).item() for _ in range(inp["steps"])]
        return dict(losses=losses, state=_state(model))

    def pretrain(noted=True, loss=None, labels="pt_labels"):
        """bert_tiny's pretraining heads at dp = WORLD, three SGD steps, the
        ranks' kept masked-LM slots unequal, on `loss` (the criterion by
        default) against `inp[labels]`. Without `noted` the criterion
        notes nothing (the control: each rank's loss weighed equally)."""
        from paddle_tpu_torch.models import (BertForPretraining,
                                             BertPretrainingCriterion)
        from paddle_tpu_torch.models import bert as bert_mod
        from paddle_tpu_torch.optimizer import SGD

        cfg = bert_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
        model = BertForPretraining(cfg, device="cpu")
        load_paddle_tpu_state(model, inp["pt_state"])
        crit = BertPretrainingCriterion()
        step = dist.DistributedTrainStep(
            model, loss or (lambda a, b, c, d: crit(a, b, c, d)),
            SGD(learning_rate=inp["pt_lr"], parameters=model.parameters()),
            mesh=dist.build_mesh(dp=world))
        saved = bert_mod.note_reduction
        if not noted:
            bert_mod.note_reduction = lambda *a, **k: None
        try:
            losses = [step(inp["pt_inputs"], inp[labels]).item()
                      for _ in range(inp["steps"])]
        finally:
            bert_mod.note_reduction = saved
        return dict(losses=losses, state=_state(model))

    def pretrain_aux():
        """The criterion plus an auxiliary mean that notes nothing."""
        from paddle_tpu_torch.models import BertPretrainingCriterion

        crit = BertPretrainingCriterion()
        return pretrain(loss=lambda a, b, c, d:
                        crit(a, b, c, d) + 0.1 * (b * b).mean())

    def two_cross_entropy():
        """A loss of two cross entropies (two notes without terms), every
        masked-LM slot kept: each rank's loss weighed equally."""
        return pretrain(loss=lambda a, b, c, d:
                        F.cross_entropy(a, c) + F.cross_entropy(b, d),
                        labels="pt_labels_full")

    _run(out, "seq_cls", seq_cls)
    _run(out, "pretrain", pretrain)
    _run(out, "pretrain_unnoted", lambda: pretrain(noted=False))
    _run(out, "pretrain_aux", pretrain_aux)
    _run(out, "two_cross_entropy", two_cross_entropy)
    return out


def resnet_cases(rank, world, inp):
    from paddle_tpu_torch.vision.models import resnet18

    out = {}

    def steps(global_stats=True):
        model = resnet18(num_classes=inp["classes"], device="cpu")
        load_paddle_tpu_state(model, inp["state"])
        step = dist.DistributedTrainStep(
            model, lambda lg, lb: F.cross_entropy(lg, lb),
            Momentum(learning_rate=inp["lr"], momentum=0.9,
                     parameters=model.parameters()),
            mesh=dist.build_mesh(dp=world))
        saved = train_step.batch_stats_over
        if not global_stats:   # the naive port: each rank's own statistics
            train_step.batch_stats_over = lambda group: contextlib.nullcontext()
        try:
            losses = [step(inp["img"], inp["lab"]).item()
                      for _ in range(inp["steps"])]
        finally:
            train_step.batch_stats_over = saved
        return dict(losses=losses, state=_state(model))

    def sync_batch_norm():
        """A SyncBatchNorm converted from a BatchNorm2D, called outside any
        step on this rank's rows: its statistics are the world group's."""
        from paddle_tpu_torch import nn as pnn
        import torch

        bn = pnn.SyncBatchNorm.convert_sync_batchnorm(
            pnn.BatchNorm2D(3, device="cpu"))
        x = torch.from_numpy(inp["img"]).chunk(world)[rank]
        y = bn(x)
        return dict(type=type(bn).__name__, out=y.detach().numpy(),
                    mean=bn._mean.numpy(), variance=bn._variance.numpy())

    _run(out, "global_batch_stats", steps)
    _run(out, "per_rank_batch_stats", lambda: steps(global_stats=False))
    _run(out, "sync_batch_norm", sync_batch_norm)
    return out
