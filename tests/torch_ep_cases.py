"""The cases of one rank of `tests/test_torch_expert_parallel.py` (suite
"expert_parallel" of `tests/torch_dist_worker.py`): the MoE layer routed
over the token ranks and cut over an ep axis through
`DistributedTrainStep`, its all-to-all record, `convert` into an ep-cut
model, and `distributed.utils.global_scatter` / `global_gather`. Imports
torch and the port only."""

import traceback

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import collective as coll
from paddle_tpu_torch.distributed import moe_comm
from paddle_tpu_torch.distributed.utils import global_gather, global_scatter
from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertFFN,
                                                              MoELayer)
from paddle_tpu_torch.observability.metrics import default_registry
from paddle_tpu_torch.optimizer import AdamW

M, E, H = 8, 4, 16
L_AUX_WEIGHT = 0.01


class MoENet(torch.nn.Module):
    """A Linear, an MoE layer and a Linear; returns (out, l_aux). With
    `listed` the experts are a list of Linears (the dense path)."""

    def __init__(self, gate, ep_axis, chunks=2, listed=False):
        super().__init__()
        self.inp = pnn.Linear(M, M, device="cpu")
        experts = ([pnn.Linear(M, M, device="cpu") for _ in range(E)]
                   if listed else ExpertFFN(E, M, H, ep_axis=ep_axis,
                                            device="cpu"))
        self.moe = MoELayer(M, experts, gate=dict(gate), ep_axis=ep_axis,
                            a2a_chunks=chunks, device="cpu")
        self.out = pnn.Linear(M, M, device="cpu")

    def forward(self, x):
        return self.out(self.moe(self.inp(x))), self.moe.l_aux


def moe_loss(o, l_aux, y):
    return ((o - y) ** 2).mean() + L_AUX_WEIGHT * l_aux


def _np(t):
    return t.detach().numpy().copy()


def ep_step(inp, gate, shape, axes, ep_axis="ep", stage=0, chunks=2,
            steps=3, listed=False):
    """Losses, the aux loss before the first update and after each step's
    forward, the all-to-all record and the full parameters of a step."""
    mesh = dist.build_mesh(**shape)
    net = MoENet(inp["gates"][gate], ep_axis, chunks, listed)
    step = dist.DistributedTrainStep(
        net, moe_loss, AdamW(learning_rate=inp["lr"],
                             parameters=net.parameters()),
        mesh=mesh, batch_axes=axes, sharding_stage=stage)
    load_paddle_tpu_state(net, inp["net"][gate + "_listed" * listed])
    x, y = inp["x"], inp["y"]
    step.evaluate(x, y)
    l_aux = [net.moe.l_aux.item()]
    since = default_registry().snapshot()
    moe_comm.reset()
    losses = []
    for _ in range(steps):
        losses.append(step(x, y).item())
        l_aux.append(net.moe.l_aux.item())
    return dict(losses=losses, l_aux=l_aux,
                calls=coll.traffic(since)["calls"],
                a2a=moe_comm.a2a_totals(),
                shapes={k: tuple(p.shape) for k, p in net.named_parameters()},
                params={k: _np(v) for k, v in step.state_dict().items()})


def expert_parallel_cases(rank, world, inp):
    out = {}

    def case(name, fn):
        try:
            out[name] = fn()
        except Exception:  # the case's test reports the traceback
            out[name] = "ERROR " + traceback.format_exc()

    ep = ("dp", "ep")
    if world == 2:
        for gate in ("naive", "gshard"):
            case(f"{gate}_ep2", lambda: ep_step(inp, gate, dict(ep=2), ep))
        case("gshard_ep2_chunks1", lambda: ep_step(inp, "gshard", dict(ep=2),
                                                   ep, chunks=1))
        case("gshard_dp2_ep_axis_dp", lambda: ep_step(
            inp, "gshard_dp", dict(dp=2), ("dp", "sharding"), ep_axis="dp"))
        case("gshard_listed_dp2", lambda: ep_step(
            inp, "gshard", dict(dp=2), ("dp", "sharding"), ep_axis=None,
            listed=True))
        case("gshard_ep2_whole_batch", lambda: ep_step(
            dict(inp, x=inp["x"][:15], y=inp["y"][:15]), "gshard",
            dict(ep=2), ep))
    else:
        case("gshard_ep4", lambda: ep_step(inp, "gshard", dict(ep=4), ep))
        case("gshard_dp2_ep2", lambda: ep_step(inp, "gshard",
                                               dict(dp=2, ep=2), ep))
        case("gshard_sharding2_ep2_stage2", lambda: ep_step(
            inp, "gshard", dict(sharding=2, ep=2), ("dp", "sharding", "ep"),
            stage=2))

    def convert():
        dist.build_mesh(ep=world)
        net = MoENet(inp["gates"]["gshard"], "ep")
        step = dist.DistributedTrainStep(
            net, moe_loss, AdamW(parameters=net.parameters()),
            batch_axes=ep)
        load_paddle_tpu_state(net, inp["net"]["gshard"])
        return dict(w1=tuple(net.moe.experts.w1.shape),
                    part=net.moe.experts.w1.ep_part,
                    params={k: _np(v) for k, v in step.state_dict().items()})

    case("convert", convert)

    def exchange():
        g = inp["exchange"]
        res = {}
        for name in ("uniform", "ragged"):
            lc, gc = g[name]["local"][rank], g[name]["global"][rank]
            x = torch.tensor(g[name]["x"][rank], requires_grad=True)
            since = default_registry().snapshot()
            s = global_scatter(x, torch.tensor(lc), torch.tensor(gc))
            back = global_gather(s * 2, torch.tensor(lc), torch.tensor(gc))
            back.sum().backward()
            res[name] = dict(scattered=_np(s), back=_np(back),
                             dx=_np(x.grad), **coll.traffic(since))
        return res

    case("exchange", exchange)
    return out
