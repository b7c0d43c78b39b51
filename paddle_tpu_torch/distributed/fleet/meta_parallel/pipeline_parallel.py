"""The pipeline-parallel model wrapper `PipelineParallel`
(↔ paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py;
reference pipeline_parallel.py: PipelineParallel :242, train_batch :940).

`train_batch((x, y), optimizer)` cuts the batch into microbatches of
`micro_batch_size` rows (strategy `pp_configs`), runs them through the
`PipelineLayer`'s stages on the schedules of `parallel.pipeline` over the
pp group, 1F1B (`schedule_mode` "1F1B") or FThenB (any other), with the
layer's `loss_fn` on the last stage, sums the shared layers' gradients
over the pp group, and steps the optimizer. It returns the mean of the
microbatch losses on every rank. The reference runs a uniform model on its
compiled 1F1B schedule and falls back to a sequential loop over the
microbatches for any other (:61-208); the port's schedules pass what a
stage sends with its shapes, so every model takes them, uniform or not,
and the result is the sequential loop's. `accumulate_steps` is read and,
as in the reference, not used. With a `scaler` (`amp.GradScaler`) each
microbatch's loss is scaled before its backward, as the reference's
sequential loop does (:251-258), and `scaler.step` / `scaler.update`
take the optimizer's step; the returned loss is unscaled. Each rank's
scaler checks only the gradients it holds (its stage's, and of a layer cut
over mp its own shard's), so the inf flag is summed first over every rank
of the hybrid group (pp, mp and batch ranks; the pp group alone without a
topology): every rank skips, or every rank steps.

Given the topology (`fleet.distributed_model` passes it), the wrapper
also does what `TensorParallel` does beside it: it cuts the layer's
tensor-parallel layers over the mp group, broadcasts the rest from the mp
group's first rank, and broadcasts every parameter and buffer over the
batch ranks (dp x sharding). Each batch rank's `train_batch` takes its
own rows of the batch, as `DataParallel`'s loop does; after the schedule
the gradients, and the loss, are averaged over the batch ranks, so the
step is the global batch's, as the reference's one controller gives it.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import collective as C
from ....parallel.pipeline import (microbatch, pipeline_1f1b, pipeline_spmd,
                                   pp_all_reduce, unmicrobatch)
from .pp_layers import PipelineLayer
from .tensor_parallel import cut_over_mp
from ....nn.layer.layers import Layer

__all__ = ["PipelineParallel"]


def _tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


class PipelineParallel(Layer):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel requires a PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        hc = strategy.hybrid_configs if strategy is not None else {}
        pp_cfg = hc.get("pp_configs", {})
        self.micro_batch_size = (hc.get("micro_batch_size")
                                 or pp_cfg.get("micro_batch_size", 1))
        self.accumulate_steps = pp_cfg.get("accumulate_steps", 1)
        self.schedule_mode = pp_cfg.get("schedule_mode", "1F1B")
        self._batch = None
        # where the scaler's inf flag is summed: the world is the topology's
        self._inf_groups = ([None] if hcg is not None else
                            [layers._pp_group] if layers._pp_group is not None
                            else [])
        if hcg is not None:
            cut_over_mp(layers, hcg)
            self._batch = g = hcg.get_dp_sharding_parallel_group()
            with torch.no_grad():
                for t in list(layers.parameters()) + list(layers.buffers()):
                    C.broadcast(t.data, g.ranks[0], group=g)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _microbatches(self, x):
        total, mbs = x.shape[0], self.micro_batch_size
        if total % mbs:
            raise ValueError(f"batch size {total} is not divisible by "
                             f"micro_batch_size {mbs}")
        return microbatch(x, max(total // mbs, 1))

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        pl = self._layers
        x, y = (_tensor(a) for a in data)
        xs, ys = self._microbatches(x), self._microbatches(y)
        group = pl._pp_group

        def loss_fn(out, m):
            loss = pl._loss_fn(out, ys[m])
            return loss if scaler is None else scaler.scale(loss)

        if self.schedule_mode.upper() == "1F1B":
            loss = pipeline_1f1b(lambda xm, m: pl(xm), loss_fn, xs,
                                 group=group)
        else:
            out = pipeline_spmd(lambda xm, m: pl(xm), xs, group=group)
            loss = torch.stack([loss_fn(out[m], m).float()
                                for m in range(xs.shape[0])]).mean()
            loss.backward()
            loss = loss.detach()
        self._reduce_shared()
        loss = self._average(loss, grads=True)
        if scaler is None:
            optimizer.step()
        else:
            if scaler.is_enable():
                loss = loss / scaler.get_init_loss_scaling()
            self._scaler_step(scaler, optimizer)
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def _scaler_step(self, scaler, optimizer):
        """scaler.step and scaler.update with the inf flag of every rank
        that holds a piece of the model."""
        scaler.unscale_(optimizer)
        scaler._reduce_found_inf(optimizer, self._inf_groups)
        scaler.step(optimizer)
        scaler.update()

    def _reduce_shared(self):
        """Each shared layer's gradient summed over the stages (a stage that
        does not run it adds zeros)."""
        pg = self._layers._pp_group
        if pg is None:
            return
        for layer in self._layers.shared_layers.values():
            for p in layer.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                pp_all_reduce(p.grad, pg)

    def _average(self, loss, grads=False):
        """The loss (and with `grads` every gradient) averaged over the
        batch ranks, which hold the same stage's parameters in one order."""
        g = self._batch
        if g is None:
            return loss
        if grads:
            for p in self._layers.parameters():
                if p.requires_grad:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    C.all_reduce(p.grad, C.ReduceOp.AVG, group=g)
        C.all_reduce(loss, C.ReduceOp.AVG, group=g)
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The layer's outputs on this rank's rows (on every stage), or
        with `compute_loss` its `loss_fn` on them, averaged over the batch
        ranks."""
        x, y = (_tensor(a) for a in data)
        pl = self._layers
        out = unmicrobatch(pipeline_spmd(lambda xm, m: pl(xm),
                                         self._microbatches(x),
                                         group=pl._pp_group))
        if compute_loss and pl._loss_fn is not None:
            return self._average(pl._loss_fn(out, y))
        return out

    def parameters(self, *a, **kw):
        return self._layers.parameters(*a, **kw)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)
