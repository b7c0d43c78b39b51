"""The rank cases of `tests/test_torch_loss_modes.py` (suite "amp_loss" of
`tests/torch_dist_worker.py`), over a 2-rank gloo group: the margin
softmax and the class-center sampling over an mp group, a weighted cross
entropy through a dp-sharded `DistributedTrainStep` whose ranks hold
unequal counts of valid rows, and `PipelineParallel.train_batch` with an
`amp.GradScaler` at pp 2 and at mp 2. Imports torch and the port only."""

import traceback

import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.layers.mpu import (
    ColumnParallelLinear, RowParallelLinear)
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import loss as loss_mod
from paddle_tpu_torch.optimizer import SGD


def _run(out, name, fn):
    try:
        out[name] = fn()
    except Exception:  # the case's test reports the traceback
        out[name] = "ERROR " + traceback.format_exc()


def _np(t):
    return t.detach().numpy().copy()


class _Lin(pnn.Linear):
    """A Linear that takes the layer-description signature (in, out)."""

    def __init__(self, i, o):
        super().__init__(i, o, device="cpu")


class _Col(ColumnParallelLinear):
    def __init__(self, i, o):
        super().__init__(i, o, gather_output=False, device="cpu")


class _Row(RowParallelLinear):
    def __init__(self, i, o):
        super().__init__(i, o, input_is_parallel=True, device="cpu")


def amp_loss_cases(rank, world, inp):
    out = {}
    group = dist.new_group(list(range(world)))

    def margin_mp():
        """This rank's class shard of the logits: the loss (mean and per
        row), the softmax shard, and the shard's gradient of the mean."""
        a = inp["margin"]
        c = a["logits"].shape[1] // world
        lg = torch.tensor(a["logits"][:, rank * c:(rank + 1) * c],
                          requires_grad=True)
        lab = torch.tensor(a["label"])
        loss, sm = F.margin_cross_entropy(lg, lab, group=group,
                                          return_softmax=True)
        loss.backward()
        rows = F.margin_cross_entropy(lg.detach(), lab, group=group,
                                      reduction=None)
        return dict(loss=loss.item(), rows=_np(rows), softmax=_np(sm),
                    grad=_np(lg.grad))

    def class_center_mp():
        a = inp["ccs"]
        lab = torch.tensor(a["labels"][rank])
        new, sampled = F.class_center_sample(lab, a["per_rank"],
                                             a["num_samples"], group=group)
        return dict(remapped=new.numpy(), sampled=sampled.numpy())

    def weighted_ce(noted=True):
        """A Linear classifier under a class-weighted mean cross entropy,
        three SGD steps at dp = WORLD over the whole batch: the ranks' rows
        hold unequal counts of valid labels and of weight. Without `noted`
        the loss notes nothing (the control: each rank's mean weighed
        equally)."""
        a = inp["wce"]
        net = pnn.Linear(a["w"].shape[0], a["w"].shape[1], device="cpu")
        with torch.no_grad():
            net.weight.copy_(torch.tensor(a["w"]))
            net.bias.copy_(torch.tensor(a["b"]))
        cw = torch.tensor(a["class_w"])
        step = dist.DistributedTrainStep(
            net, lambda lg, lb: F.cross_entropy(lg, lb, weight=cw),
            SGD(learning_rate=a["lr"], parameters=net.parameters()),
            mesh=dist.build_mesh(dp=world))
        saved = loss_mod.note_reduction
        if not noted:
            loss_mod.note_reduction = lambda *x, **k: None
        try:
            losses = [step(a["x"], a["y"]).item() for _ in range(a["steps"])]
        finally:
            loss_mod.note_reduction = saved
        return dict(losses=losses, w=_np(net.weight), b=_np(net.bias))

    def pipeline_scaler(scale, plant_inf_at=None):
        """train_batch at pp 2, 1F1B, 4 rows in microbatches of 2, SGD,
        three calls, with a GradScaler at `scale` (None: no scaler). At
        call `plant_inf_at` stage 0's first weight gets an inf gradient:
        every rank must skip that step."""
        w = inp["pipe"]
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"pp_degree": 2}
        fleet.init(is_collective=True, strategy=strategy)
        pl = PipelineLayer([LayerDesc(_Lin, 8, 8) for _ in range(4)],
                           num_stages=2,
                           loss_fn=lambda o, y: ((o - y) ** 2).mean())
        with torch.no_grad():
            for i, layer, _ in pl.run_funcs:
                layer.weight.copy_(torch.tensor(w["W"][i]))
                layer.bias.copy_(torch.tensor(w["b"][i]))
        strategy.hybrid_configs = {"pp_configs": {"micro_batch_size": 2,
                                                  "schedule_mode": "1F1B"}}
        model = fleet.distributed_model(pl)
        opt = SGD(learning_rate=0.05, parameters=pl.parameters())
        scaler = None if scale is None else amp.GradScaler(
            init_loss_scaling=scale)
        call = [0]
        first = pl.run_funcs[0][1].weight

        def poison(g):
            if call[0] == plant_inf_at and rank == 0:
                g = g.clone()
                g[0, 0] = float("inf")
            return g

        first.register_hook(poison)
        losses, params, scales = [], [], []
        for i in range(3):
            call[0] = i
            losses.append(model.train_batch((w["x"], w["y"]), opt,
                                            scaler=scaler).item())
            params.append([_np(p) for p in pl.parameters()])
            scales.append(None if scaler is None else scaler._scale)
        return dict(losses=losses, params=params, scales=scales)

    def pipeline_scaler_mp(plant):
        """train_batch at pp 1 x mp WORLD (a ColumnParallelLinear, then a
        RowParallelLinear, each cut over mp), SGD, a GradScaler at 1024,
        two calls. With `plant`, call 0 puts an inf in mp rank 0's shard
        of the column weight's gradient alone: every rank must skip that
        step and halve its scale. Returns this rank's parameters before
        and after each call."""
        w = inp["pipe"]
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"mp_degree": world}
        fleet.init(is_collective=True, strategy=strategy)
        pl = PipelineLayer([LayerDesc(_Col, 8, 8), LayerDesc(_Row, 8, 8)],
                           num_stages=1,
                           loss_fn=lambda o, y: ((o - y) ** 2).mean())
        with torch.no_grad():
            for i, layer, _ in pl.run_funcs:
                layer.weight.copy_(torch.tensor(w["W"][i]))
                layer.bias.copy_(torch.tensor(w["b"][i]))
        strategy.hybrid_configs = {"pp_configs": {"micro_batch_size": 2}}
        model = PipelineParallel(pl, fleet.get_hybrid_communicate_group(),
                                 strategy)
        opt = SGD(learning_rate=0.05, parameters=pl.parameters())
        scaler = amp.GradScaler(init_loss_scaling=1024.0)
        call = [0]

        def poison(g):
            if plant and call[0] == 0 and rank == 0:
                g = g.clone()
                g[0, 0] = float("inf")
            return g

        pl.run_funcs[0][1].weight.register_hook(poison)
        params, scales = [[_np(p) for p in pl.parameters()]], []
        for i in range(2):
            call[0] = i
            model.train_batch((w["x"], w["y"]), opt, scaler=scaler)
            params.append([_np(p) for p in pl.parameters()])
            scales.append(scaler._scale)
        return dict(params=params, scales=scales)

    _run(out, "margin_mp", margin_mp)
    _run(out, "class_center_mp", class_center_mp)
    _run(out, "weighted_ce", weighted_ce)
    _run(out, "weighted_ce_unnoted", lambda: weighted_ce(noted=False))
    _run(out, "pipeline_plain", lambda: pipeline_scaler(None))
    _run(out, "pipeline_scaler", lambda: pipeline_scaler(1024.0))
    _run(out, "pipeline_scaler_inf", lambda: pipeline_scaler(1024.0, 1))
    _run(out, "pipeline_scaler_mp", lambda: pipeline_scaler_mp(False))
    _run(out, "pipeline_scaler_mp_inf", lambda: pipeline_scaler_mp(True))
    return out
