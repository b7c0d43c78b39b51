"""The cases of one rank of `tests/test_torch_tensor_parallel.py` (suite
"tensor_parallel" of `tests/torch_dist_worker.py`): the tensor- and
sequence-parallel layers, the mp axis of `DistributedTrainStep`, and the
step's loss over the global batch. Imports torch and the port only."""

import traceback

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import collective as coll
from paddle_tpu_torch.distributed import env, fleet
from paddle_tpu_torch.distributed.fleet.layers.mpu import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, shard_model)
from paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils import (
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
    RowSequenceParallelLinear, ScatterOp,
    register_sequence_parallel_allreduce_hooks)
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt3_tiny)
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.observability.metrics import default_registry


def _np(t):
    return t.detach().numpy().copy()


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _load(module, state):
    return load_paddle_tpu_state(module, state)


class TPMLP(torch.nn.Module):
    """tests/test_distributed.py:190 `_mlp_with_tp` in the port."""

    def __init__(self):
        super().__init__()
        self.fc1 = ColumnParallelLinear(8, 32, gather_output=False, device="cpu")
        self.fc2 = RowParallelLinear(32, 8, input_is_parallel=True, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class Cls(torch.nn.Module):
    """A classifier of 8 classes for the summed cross entropy."""

    def __init__(self):
        super().__init__()
        self.l1 = pnn.Linear(16, 32, device="cpu")
        self.l2 = pnn.Linear(32, 8, device="cpu")

    def forward(self, x):
        return self.l2(torch.relu(self.l1(x)))


class SPPair(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.col = ColumnSequenceParallelLinear(6, 8, gather_output=False,
                                                device="cpu")
        self.row = RowSequenceParallelLinear(8, 6, input_is_parallel=True,
                                             device="cpu")

    def forward(self, x):
        return self.row(self.col(x))


def mse(o, y):
    return ((o - y) ** 2).mean()


def _full(step):
    return {k: _np(v) for k, v in step.state_dict().items()}


def tensor_parallel_cases(rank, world, inp):
    out = {}

    def case(name, fn):
        try:
            out[name] = fn()
        except Exception:  # the case's test reports the traceback
            out[name] = "ERROR " + traceback.format_exc()

    def mp_group(**shape):
        return env.mesh_group(dist.build_mesh(**shape), "mp")

    def part(n, k):
        return slice(rank * (n // k), (rank + 1) * (n // k))

    L = inp["layers"]

    def column(gather):
        g = mp_group(mp=world)
        col = shard_model(ColumnParallelLinear(8, 16, gather_output=gather,
                                               device="cpu"), g)
        _load(col, {"weight": L["col_w"], "bias": L["col_b"]})
        x = _t(L["x8"], True)
        y = col(x)
        dy = _t(L["dy16"]) if gather else _t(L["dy16"])[..., part(16, world)]
        (y * dy).sum().backward()
        return dict(out=_np(y), dx=_np(x.grad), dw=_np(col.weight.grad),
                    db=_np(col.bias.grad))

    def row(parallel):
        g = mp_group(mp=world)
        lin = shard_model(RowParallelLinear(16, 8, input_is_parallel=parallel,
                                            device="cpu"), g)
        _load(lin, {"weight": L["row_w"], "bias": L["row_b"]})
        x = _t(L["x16"][..., part(16, world)] if parallel else L["x16"], True)
        y = lin(x)
        (y * _t(L["dy8"])).sum().backward()
        return dict(out=_np(y), dx=_np(x.grad), dw=_np(lin.weight.grad),
                    db=_np(lin.bias.grad))

    def vocab():
        g = mp_group(mp=world)
        emb = shard_model(VocabParallelEmbedding(16, 8, device="cpu"), g)
        _load(emb, {"weight": L["emb_w"]})
        y = emb(_t(L["ids"]))
        (y * _t(L["dy_emb"])).sum().backward()
        return dict(out=_np(y), dw=_np(emb.weight.grad))

    def cross_entropy():
        ce = ParallelCrossEntropy(mp_group=mp_group(mp=world))
        lg = _t(L["logits"][..., part(16, world)], True)
        loss = ce(lg, _t(L["ce_labels"]))
        (loss * _t(L["dloss"])).sum().backward()
        return dict(loss=_np(loss), dlogits=_np(lg.grad))

    for gather in (False, True):
        case(f"column_gather_{gather}", lambda: column(gather))
    for parallel in (True, False):
        case(f"row_parallel_input_{parallel}", lambda: row(parallel))
    case("vocab_embedding", vocab)
    case("parallel_cross_entropy", cross_entropy)

    S = inp["sp_x"].shape[1]
    mine = part(S, world)

    def sp_ops():
        g = mp_group(mp=world)
        x, dy = inp["sp_x"], inp["sp_dy"]
        res = {}
        for name, op, xin, dyin in (
                ("scatter", lambda t: ScatterOp.apply(t, 1, g), x, dy[:, mine]),
                ("gather", lambda t: GatherOp.apply(t, 1, g), x[:, mine], dy),
                ("all_gather", lambda t: AllGatherOp.apply(t, g), x[:, mine],
                 dy * (rank + 1)),
                ("reduce_scatter", lambda t: ReduceScatterOp.apply(t, g),
                 x * (rank + 1), dy[:, mine])):
            t = _t(xin, True)
            y = op(t)
            (y * _t(dyin)).sum().backward()
            res[name] = dict(out=_np(y), dx=_np(t.grad))
        return res

    def sp_linears():
        pair = shard_model(SPPair(), mp_group(mp=world))
        _load(pair, inp["sp_pair"])
        hooks = register_sequence_parallel_allreduce_hooks(pair)
        x = _t(inp["sp_x"][:, mine], True)
        y = pair(x)
        (y * _t(inp["sp_dy"][:, mine])).sum().backward()
        for h in hooks:
            h.remove()
        return dict(out=_np(y), dx=_np(x.grad),
                    grads={k: _np(p.grad) for k, p in pair.named_parameters()})

    case("sp_ops", sp_ops)
    case("sp_linears", sp_linears)

    def gpt_step(shape, stage, cfg, state, steps=3, opt=None, clip=None,
                 model_cls=GPTForCausalLM, **step_kw):
        mesh = dist.build_mesh(**shape)
        model = model_cls(cfg, device="cpu")
        crit = GPTPretrainingCriterion(cfg)
        o = (opt or AdamW)(learning_rate=inp["gpt_lr"] if opt is None
                           else inp["sgd_lr"], parameters=model.parameters(),
                           grad_clip=None if clip is None
                           else ClipGradByGlobalNorm(clip))
        step = dist.DistributedTrainStep(model, lambda lg, lb: crit(lg, lb), o,
                                         mesh=mesh, sharding_stage=stage,
                                         **step_kw)
        _load(model, state)
        since = default_registry().snapshot()
        losses = [step(inp["gpt_ids"], inp["gpt_labels"]).item()
                  for _ in range(steps)]
        return dict(losses=losses, params=_full(step),
                    calls=coll.traffic(since)["calls"])

    if world == 4:
        for stage in (1, 2, 3):
            case(f"gpt_sp_sharding2_mp2_stage{stage}", lambda: gpt_step(
                dict(sharding=2, mp=2), stage,
                gpt3_tiny(sequence_parallel=True, use_recompute=stage == 3),
                inp["gpt"]))
        case("gpt_sp_sharding2_mp2_stage3_offload_clip_sgd", lambda: gpt_step(
            dict(sharding=2, mp=2), 3, gpt3_tiny(sequence_parallel=True),
            inp["gpt"], opt=SGD, clip=inp["gpt_clip"], offload=True))

        def tp_mlp():
            net = TPMLP()
            spec = [env.PartitionSpec("dp", None)]
            step = dist.DistributedTrainStep(
                net, mse, SGD(learning_rate=0.1, parameters=net.parameters()),
                mesh=dist.build_mesh(dp=2, mp=2), input_specs=spec,
                label_specs=spec)
            _load(net, inp["tp_mlp"])
            losses = [step(inp["tp_x"], inp["tp_y"]).item() for _ in range(5)]
            return dict(losses=losses, params=_full(step))

        case("tp_mlp_dp2_mp2", tp_mlp)

        def fleet_tp():
            strategy = fleet.DistributedStrategy()
            strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
            fleet.init(is_collective=True, strategy=strategy)
            hcg = fleet.get_hybrid_communicate_group()
            net = TPMLP()
            _load(net, inp["tp_mlp"])
            model = fleet.distributed_model(net)
            opt = fleet.distributed_optimizer(SGD(
                learning_rate=0.1, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(inp["tp_clip"])))
            rows = slice(hcg.get_data_parallel_rank() * 4,
                         hcg.get_data_parallel_rank() * 4 + 4)
            x, y = _t(inp["tp_x"][rows]), _t(inp["tp_y"][rows])
            for _ in range(3):
                mse(model(x), y).backward()
                opt.step()
                opt.clear_grad()
            return dict(mode=hcg.get_parallel_mode(),
                        wrapped=type(model).__name__,
                        params={k: _np(v) for k, v in
                                dist.full_state_dict(net).items()})

        case("fleet_tensor_parallel_dp2_mp2", fleet_tp)

        def convert_stage3():
            dist.build_mesh(sharding=2, mp=2)
            cfg = gpt3_tiny(sequence_parallel=True)
            model = GPTForCausalLM(cfg, device="cpu", seed=5)
            crit = GPTPretrainingCriterion(cfg)
            step = dist.DistributedTrainStep(
                model, lambda lg, lb: crit(lg, lb),
                AdamW(parameters=model.parameters()), sharding_stage=3)
            _load(model, inp["gpt"])
            return dict(shapes={k: tuple(p.shape)
                                for k, p in model.named_parameters()},
                        params=_full(step))

        case("convert_stage3_sharding2_mp2", convert_stage3)
    if world == 2:
        case("llama_sp_mp2", lambda: gpt_step(
            dict(mp=2), 0, llama_tiny(sequence_parallel=True,
                                      use_recompute=True),
            inp["llama"], model_cls=LlamaForCausalLM))
        case("gpt_mp2_clip_sgd", lambda: gpt_step(
            dict(mp=2), 0, gpt3_tiny(), inp["gpt"], opt=SGD,
            clip=inp["gpt_clip"]))

        def convert_mp2():
            dist.build_mesh(mp=2)
            model = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=5)
            shard_model(model, env.mesh_group(env.get_global_mesh(), "mp"))
            _load(model, inp["gpt"])
            return dict(shapes={k: tuple(p.shape)
                                for k, p in model.named_parameters()},
                        params={k: _np(v) for k, v in
                                dist.full_state_dict(model).items()})

        case("convert_mp2", convert_mp2)

    # the step's loss over the global batch (a masked mean, a sum)
    def masked(noted=True):
        cfg = gpt3_tiny()
        mesh = dist.build_mesh(dp=world)
        model = GPTForCausalLM(cfg, device="cpu")
        crit = GPTPretrainingCriterion(cfg)

        def unnoted(lg, lb, m):  # the masked mean without its note
            return (crit.ce(lg, lb) * m).sum() / m.sum().clamp(min=1.0)

        step = dist.DistributedTrainStep(
            model, (lambda lg, lb, m: crit(lg, lb, m)) if noted else unnoted,
            SGD(learning_rate=inp["sgd_lr"], parameters=model.parameters()),
            mesh=mesh)
        _load(model, inp["gpt"])
        labels = [inp["gpt_labels"], inp["mask"]]
        losses = [step(inp["gpt_ids"], labels).item() for _ in range(3)]
        return dict(losses=losses, params=_full(step))

    def summed(clip):
        mesh = dist.build_mesh(dp=world)
        net = Cls()
        step = dist.DistributedTrainStep(
            net, lambda o, y: F.cross_entropy(o, y, reduction="sum"),
            SGD(learning_rate=inp["sum_lr"], parameters=net.parameters(),
                grad_clip=None if clip is None else ClipGradByGlobalNorm(clip)),
            mesh=mesh)
        _load(net, inp["cls"])
        losses = [step(inp["cls_x"], inp["cls_y"]).item() for _ in range(3)]
        return dict(losses=losses, params=_full(step))

    case(f"masked_dp{world}", masked)
    case(f"masked_unnoted_dp{world}", lambda: masked(noted=False))
    case(f"summed_dp{world}", lambda: summed(None))
    case(f"summed_clip_dp{world}", lambda: summed(inp["sum_clip"]))
    return out
