"""One rank of the port's multi-rank CPU tests (`tests/test_torch_collective.py`,
`tests/test_torch_sharding.py`, `tests/test_torch_tensor_parallel.py`,
whose cases are in `tests/torch_tp_cases.py`, and
`tests/test_torch_pipeline.py`, whose cases are in
`tests/torch_pp_cases.py`, `tests/test_torch_ring_attention.py`, whose
cases are in `tests/torch_sep_cases.py`, and
`tests/test_torch_expert_parallel.py`, whose cases are in
`tests/torch_ep_cases.py`, and `tests/test_torch_bert.py` and
`tests/test_torch_resnet.py`, whose cases are in
`tests/torch_model_dp_cases.py`, and `tests/test_torch_random.py`, whose
cases are in `tests/torch_random_cases.py`, and
`tests/test_torch_loss_modes.py`, whose cases are in
`tests/torch_amp_loss_cases.py`, and `tests/test_torch_checkpoint.py`,
suite "checkpoint"; the 2-rank "collective" suite also runs the
`eager_multiproc` cases of `tests/torch_eager_cases.py`).

    python tests/torch_dist_worker.py SUITE RANK WORLD DIR

Joins a gloo group of WORLD ranks through the file store DIR/store, reads
the suite's inputs from DIR/in.pt (numpy arrays the test made, e.g. the
JAX package's initial weights), runs every case of SUITE in order and
writes {case: result} to DIR/out<RANK>.pt. A case that raises records its
traceback as its result, so the test of that case fails with it; the
group's own timeout ends a rank whose peers went another way. Imports
torch and the port only.
"""

import datetime
import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paddle_tpu_torch.distributed as dist  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.convert import load_paddle_tpu_state  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet.base.topology import (  # noqa: E402
    CommunicateTopology, HybridCommunicateGroup)
from paddle_tpu_torch.distributed.train_step import host_memory_kind  # noqa: E402
from paddle_tpu_torch.observability.metrics import default_registry  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402

GROUP_TIMEOUT_S = 120


# -- collectives (tests/multiproc_worker.py:32-80 and the regressions of
# tests/test_distributed.py:308-357, per rank) ------------------------------ #

def collective_cases(rank, world, inp):
    out = {}

    def case(name):
        def deco(fn):
            try:
                out[name] = fn()
            except Exception:  # the case's test reports the traceback
                out[name] = "ERROR " + traceback.format_exc()
            return fn
        return deco

    @case("all_reduce_sum")
    def _():
        t = torch.full((4,), rank + 1.0)
        dist.all_reduce(t)
        return t.tolist()

    @case("all_reduce_max")
    def _():
        t = torch.full((2,), float(rank))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()

    @case("all_gather")
    def _():
        lst = []
        dist.all_gather(lst, torch.tensor([rank], dtype=torch.int32))
        return [int(x[0]) for x in lst]

    @case("broadcast")
    def _():
        b = torch.full((3,), float(rank))
        dist.broadcast(b, src=1)
        return b.tolist()

    @case("broadcast_object_list")
    def _():
        objs = [{"rank": rank, "blob": "x" * (5 * (rank + 1))}]
        dist.broadcast_object_list(objs, src=0)
        return objs[0]

    @case("all_gather_object")
    def _():
        got = []
        dist.all_gather_object(got, {"r": rank, "pad": "y" * (10 * (rank + 1))})
        return [o["r"] for o in got]

    @case("alltoall_single")
    def _():
        a = torch.full((world, 2), float(rank))
        o = torch.zeros(world, 2)
        dist.alltoall_single(o, a)
        return o.tolist()

    @case("send_recv")
    def _():
        if rank == 0:
            dist.send(torch.arange(5.0), dst=1)
            return None
        if rank == 1:
            r = torch.zeros(5)
            dist.recv(r, src=0)
            return r.tolist()
        return None

    @case("barrier")
    def _():
        dist.barrier()
        return True

    @case("send_recv_nonzero_dst")
    def _():
        last = world - 1
        if rank == 0:
            dist.send(torch.arange(4.0) + 10, dst=last)
        elif rank == last:
            r = torch.zeros(4)
            dist.recv(r, src=0)
            return r.tolist()
        return None

    @case("alltoall_single_transpose")
    def _():
        # rank i holds chunks [i * world + j for each destination j]
        src = (rank * world + torch.arange(world, dtype=torch.float32))[:, None]
        o = torch.zeros(world, 1)
        dist.alltoall_single(o, src)
        return o.ravel().tolist()

    @case("reduce_scatter_max")
    def _():
        # entry j is what this rank sends to rank j
        vals = inp["rs_vals"][rank]
        o = torch.zeros(1)
        dist.reduce_scatter(o, [torch.tensor([float(v)]) for v in vals],
                            op=dist.ReduceOp.MAX)
        return o.tolist()

    @case("alltoall_list")
    def _():
        lst = []
        dist.alltoall(lst, [torch.tensor([float(rank * 10 + j)])
                            for j in range(world)])
        return [float(t[0]) for t in lst]

    @case("scatter")
    def _():
        t = torch.zeros(2)
        dist.scatter(t, [torch.full((2,), float(j)) for j in range(world)]
                     if rank == 0 else None, src=0)
        return t.tolist()

    @case("reduce")
    def _():
        t = torch.full((2,), float(rank + 1))
        dist.reduce(t, dst=0)
        return t.tolist() if rank == 0 else None

    @case("batch_isend_irecv")
    def _():
        r = torch.zeros(3)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, torch.full((3,), float(rank)),
                       (rank + 1) % world),
            dist.P2POp(dist.irecv, r, (rank - 1) % world)])
        for w in works:
            w.wait()
        return r.tolist()

    @case("counters")
    def _():
        since = default_registry().snapshot()
        dist.all_reduce(torch.ones(3))
        dist.all_gather([], torch.ones(2))
        dist.broadcast(torch.ones(4), src=0)
        dist.reduce_scatter(torch.zeros(1), [torch.ones(1)] * world)
        dist.alltoall_single(torch.zeros(world), torch.ones(world))
        dist.barrier()
        return dist.collective.traffic(since)

    @case("topology")
    def _():
        res = {}
        for dims in inp["hcg_dims"]:
            hcg = HybridCommunicateGroup(CommunicateTopology(dims=dims))
            res[tuple(dims)] = dict(
                mode=hcg.get_parallel_mode(),
                data=hcg.get_data_parallel_group().ranks,
                model=hcg.get_model_parallel_group().ranks,
                sharding=hcg.get_sharding_parallel_group().ranks,
                sep=hcg.get_sep_parallel_group().ranks,
                pipe=hcg.get_pipe_parallel_group().ranks,
                dp_sep=hcg.get_dp_sep_parallel_group().ranks,
                sizes=(hcg.get_data_parallel_world_size(),
                       hcg.get_model_parallel_world_size(),
                       hcg.get_sharding_parallel_world_size(),
                       hcg.get_sep_parallel_world_size()),
                mesh=dist.env.mesh_shape(hcg.mesh))
        return res

    if inp.get("eager_multiproc"):
        from torch_eager_cases import eager_multiproc_cases

        out.update(eager_multiproc_cases(rank, world, inp))
    if "attr_mlp" in inp:
        for stage in (1, 2, 3):
            case(f"attr_sharded_stage{stage}")(
                lambda stage=stage: attr_sharded(inp, stage))
    return out


def attr_sharded(inp, stage):
    """The MLP with the attributes of `inp["attrs"]` ({name: ParamAttr
    keywords}) through a sharded step over every rank at `stage`: AdamW
    with weight decay and a global-norm clip, 3 steps on the whole batch;
    the full parameters after."""
    from paddle_tpu_torch import ParamAttr, regularizer
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.layer.layers import set_param_attr

    model = mlp(inp["attr_mlp"])
    for name, p in model.named_parameters():
        kw = dict(inp["attrs"].get(name, {}))
        if "regularizer" in kw:
            kind, coeff = kw["regularizer"]
            kw["regularizer"] = getattr(regularizer, kind)(coeff)
        set_param_attr(p, ParamAttr(**kw))
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(inp["attr_clip"]))
    step = dist.DistributedTrainStep(model, mse, opt,
                                     mesh=dist.build_mesh(sharding=2),
                                     sharding_stage=stage)
    x, y = torch.from_numpy(inp["attr_x"]), torch.from_numpy(inp["attr_y"])
    losses = [step(x, y).item() for _ in range(3)]
    return dict(losses=losses, params={
        k: v.numpy() for k, v in dist.full_state_dict(model).items()})


# -- the sharded training step --------------------------------------------- #

H = 256


class MLP(torch.nn.Module):
    """tests/test_sharding_stages.py:28 `_MLP` in the port."""

    def __init__(self):
        super().__init__()
        self.l1 = pnn.Linear(H, H, device="cpu")
        self.l2 = pnn.Linear(H, H, device="cpu")
        self.l3 = pnn.Linear(H, 8, device="cpu")

    def forward(self, x):
        h = torch.relu(self.l1(x))
        h = torch.relu(self.l2(h))
        return self.l3(h)


def mse(o, y):
    return ((o - y) ** 2).mean()


def mlp(state):
    return load_paddle_tpu_state(MLP(), state)


def state_bytes(opt):
    return sum(v.numel() * v.element_size() for st in opt._states.values()
               for v in st.values())


def sharding_cases(rank, world, inp):
    out = {}
    x, y = inp["x"], inp["y"]

    def case(name, fn):
        try:
            out[name] = fn()
        except Exception:  # the case's test reports the traceback
            out[name] = "ERROR " + traceback.format_exc()

    def run(mesh, stage, steps=4, clip=None, **kw):
        from paddle_tpu_torch.nn import ClipGradByGlobalNorm

        model = mlp(inp["mlp"])
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
        step = dist.DistributedTrainStep(model, mse, opt, mesh=mesh,
                                         sharding_stage=stage, **kw)
        losses = [step(x, y).item() for _ in range(steps)]
        return dict(
            losses=losses, host_kind=host_memory_kind(mesh),
            params={k: v.numpy() for k, v in step.state_dict().items()},
            state_bytes=state_bytes(opt),
            param_bytes=sum(p.numel() * p.element_size()
                            for p in model.parameters()),
            state_devices=sorted({v.device.type for st in opt._states.values()
                                  for v in st.values()}))

    if world == 1:
        mesh = dist.build_mesh(sharding=1)
        for stage in (0, 1, 2, 3):
            case(f"one_rank_stage{stage}", lambda: run(mesh, stage))
        for stage in (2, 3):
            case(f"one_rank_stage{stage}_offload",
                 lambda: run(mesh, stage, offload=True))
        return out

    meshes = {"sharding4": dict(sharding=4), "dp2_sharding2": dict(dp=2, sharding=2)}
    for mname, shape in meshes.items():
        mesh = dist.build_mesh(**shape)
        for stage in (0, 1, 2, 3):
            case(f"{mname}_stage{stage}", lambda: run(mesh, stage))
        for stage in (2, 3):
            case(f"{mname}_stage{stage}_no_overlap",
                 lambda: run(mesh, stage, comm_overlap=False))
    mesh = dist.build_mesh(sharding=4)
    for stage in (2, 3):
        case(f"sharding4_stage{stage}_offload",
             lambda: run(mesh, stage, offload=True))
        case(f"sharding4_stage{stage}_offload_no_overlap",
             lambda: run(mesh, stage, offload=True, comm_overlap=False))
        case(f"sharding4_stage{stage}_clip",
             lambda: run(mesh, stage, steps=3, clip=inp["clip_norm"]))

    def whole_norms(opt_name, shape, stage=0, offload=False, tp=False,
                    local=False):
        """Lamb or Lars (`inp["norm_opts"]`) over the mesh `shape`: on the
        MLP at a ZeRO stage (with offload in slices of 4096 elements, so
        that a shard spans several), or on the tensor-parallel MLP (its
        ColumnParallelLinear cut over mp). `local`: the rule takes this
        rank's piece's own norms (the control)."""
        from paddle_tpu_torch import optimizer as popt
        from paddle_tpu_torch.distributed import train_step
        from torch_tp_cases import TPMLP

        net = load_paddle_tpu_state(TPMLP(), inp["tp_mlp"]) if tp \
            else mlp(inp["mlp"])
        cls, kw = inp["norm_opts"][opt_name]
        step = dist.DistributedTrainStep(
            net, mse, getattr(popt, cls)(parameters=net.parameters(), **kw),
            mesh=dist.build_mesh(**shape), sharding_stage=stage,
            offload=offload)
        saved = train_step.OFFLOAD_SLICE, train_step.DistributedTrainStep.\
            _whole_sq_norms
        train_step.OFFLOAD_SLICE = 4096
        if local:
            train_step.DistributedTrainStep._whole_sq_norms = \
                lambda self, name, parts: parts
        xs, ys = (inp["tp_x"], inp["tp_y"]) if tp else (x, y)
        try:
            losses = [step(xs, ys).item() for _ in range(3)]
        finally:
            (train_step.OFFLOAD_SLICE,
             train_step.DistributedTrainStep._whole_sq_norms) = saved
        return dict(losses=losses, params={
            k: v.numpy() for k, v in step.state_dict().items()})

    for opt_name in ("lamb", "lars"):
        for where, kw in (
                ("dp2_sharding2_stage2", dict(shape=dict(dp=2, sharding=2),
                                              stage=2)),
                ("sharding4_stage2_offload", dict(shape=dict(sharding=4),
                                                  stage=2, offload=True)),
                ("dp2_mp2", dict(shape=dict(dp=2, mp=2), tp=True))):
            case(f"{opt_name}_{where}",
                 lambda: whole_norms(opt_name, **kw))
            case(f"{opt_name}_{where}_local",
                 lambda: whole_norms(opt_name, local=True, **kw))

    def zero_d_state(opt_name, offload):
        """NAdam or ASGD (`inp["zero_d_opts"]`), whose state holds a 0-d
        value of the whole parameter (mu_prod, the ring's index), at
        sharding 4 stage 2, with offload in slices of 4096 elements (a
        shard spans several) or without."""
        from paddle_tpu_torch import optimizer as popt
        from paddle_tpu_torch.distributed import train_step

        net = mlp(inp["mlp"])
        cls, kw = inp["zero_d_opts"][opt_name]
        step = dist.DistributedTrainStep(
            net, mse, getattr(popt, cls)(parameters=net.parameters(), **kw),
            mesh=dist.build_mesh(sharding=4), sharding_stage=2,
            offload=offload)
        saved = train_step.OFFLOAD_SLICE
        train_step.OFFLOAD_SLICE = 4096
        try:
            losses = [step(x, y).item() for _ in range(4)]
        finally:
            train_step.OFFLOAD_SLICE = saved
        return dict(losses=losses, params={
            k: v.numpy() for k, v in step.state_dict().items()})

    for opt_name in inp["zero_d_opts"]:
        for offload in (False, True):
            case(f"{opt_name}_sharding4_stage2" + "_offload" * offload,
                 lambda: zero_d_state(opt_name, offload))

    def gpt(stage):
        from paddle_tpu_torch.models import (GPTForCausalLM,
                                             GPTPretrainingCriterion, gpt3_tiny)

        cfg = gpt3_tiny()
        model = load_paddle_tpu_state(GPTForCausalLM(cfg, device="cpu"),
                                      inp["gpt"])
        crit = GPTPretrainingCriterion(cfg)
        step = dist.DistributedTrainStep(
            model, lambda lg, lb: crit(lg, lb),
            AdamW(learning_rate=1e-4, parameters=model.parameters()),
            mesh=dist.build_mesh(dp=2, sharding=2), sharding_stage=stage)
        return step(inp["gpt_ids"], inp["gpt_labels"]).item()

    for stage in (2, 3):
        case(f"gpt3_tiny_dp2_sharding2_stage{stage}", lambda: gpt(stage))

    def levels():
        dist.build_mesh(sharding=4)
        res = {}
        for level in ("os", "os_g", "p_g_os"):
            net = mlp(inp["mlp"])
            o = AdamW(learning_rate=1e-3, parameters=net.parameters())
            m, o, s = dist.group_sharded_parallel(net, o, level)
            step = dist.DistributedTrainStep(m, mse, o)
            res[level] = dict(stage=o._sharding_stage, step=step.sharding_stage,
                              dist_attr=getattr(net.l1.weight, "dist_attr", None),
                              loss=step(x, y).item())
        return res

    case("group_sharded_levels", levels)

    def save():
        net = mlp(inp["mlp"])
        o = AdamW(learning_rate=1e-3, parameters=net.parameters())
        step = dist.DistributedTrainStep(net, mse, o,
                                         mesh=dist.build_mesh(sharding=4),
                                         sharding_stage=3, offload=True)
        for _ in range(2):
            step(x, y)
        path = os.path.join(inp["dir"], "saved")
        dist.save_group_sharded_model(net, path, o)
        return dict(path=path, params={k: v.numpy() for k, v in
                                       step.state_dict().items()})

    case("save_group_sharded_model", save)

    def released():
        import gc
        import weakref

        net = mlp(inp["mlp"])
        step = dist.DistributedTrainStep(
            net, mse, AdamW(parameters=net.parameters()),
            mesh=dist.build_mesh(sharding=4), sharding_stage=2)
        step(x, y)
        refs = [weakref.ref(net), weakref.ref(step)]
        del net, step
        gc.collect()
        return [r() is None for r in refs]

    case("released", released)

    def eager(model, opt, xs, ys, steps=3):
        for _ in range(steps):
            mse(model(torch.as_tensor(xs)), torch.as_tensor(ys)).backward()
            opt.step()
            opt.clear_grad()

    def data_parallel():
        dist.build_mesh(dp=4)
        net = mlp(inp["mlp"])
        dp = dist.DataParallel(net)
        part = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
        eager(dp, AdamW(learning_rate=1e-3, parameters=dp.parameters()),
              x[part], y[part])
        return {k: v.numpy() for k, v in net.state_dict().items()}

    case("data_parallel_eager", data_parallel)

    def fleet_dp():
        from paddle_tpu_torch.nn import ClipGradByGlobalNorm

        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 4}
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        model = fleet.distributed_model(mlp(inp["mlp"]))
        opt = fleet.distributed_optimizer(AdamW(
            learning_rate=1e-3, parameters=model.parameters(),
            grad_clip=ClipGradByGlobalNorm(inp["clip_norm"])))
        part = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
        eager(model, opt, x[part], y[part], steps=1)
        return dict(mode=hcg.get_parallel_mode(),
                    wrapped=type(model).__name__,
                    clip=type(opt._inner_opt._grad_clip).__name__,
                    params={k: v.numpy() for k, v in model.state_dict().items()})

    case("fleet_data_parallel", fleet_dp)

    def unported():
        import re

        def item(fn):
            try:
                built = fn()
            except NotImplementedError as e:
                return re.search(r"item (1[a-e])", str(e)).group(1)
            return type(built).__name__

        res = {}
        for axis in ("mp", "pp", "sep", "ep"):
            mesh = dist.build_mesh(**{axis: world})
            net = mlp(inp["mlp"])
            res[axis] = item(lambda: dist.DistributedTrainStep(
                net, mse, AdamW(parameters=net.parameters()), mesh=mesh))
        for mode, degree in (("tensor_parallel", "mp_degree"),
                             ("pipeline_parallel", "pp_degree"),
                             ("segment_parallel", "sep_degree")):
            strategy = fleet.DistributedStrategy()
            strategy.hybrid_configs = {degree: world}
            fleet.init(is_collective=True, strategy=strategy)
            res[mode] = item(lambda: fleet.distributed_model(mlp(inp["mlp"])))
        return res

    case("unported", unported)
    return out


def tensor_parallel_cases(rank, world, inp):
    from torch_tp_cases import tensor_parallel_cases as cases

    return cases(rank, world, inp)


def pipeline_cases(rank, world, inp):
    from torch_pp_cases import pipeline_cases as cases

    return cases(rank, world, inp)


def pipeline_gate_cases(rank, world, inp):
    from torch_pp_cases import gate_cases

    return gate_cases(rank, world, inp)


def segment_parallel_cases(rank, world, inp):
    from torch_sep_cases import segment_cases

    return segment_cases(rank, world, inp)


def segment_gate_cases(rank, world, inp):
    from torch_sep_cases import gate_cases

    return gate_cases(rank, world, inp)


def expert_parallel_cases(rank, world, inp):
    from torch_ep_cases import expert_parallel_cases as cases

    return cases(rank, world, inp)


def bert_dp_cases(rank, world, inp):
    from torch_model_dp_cases import bert_cases

    return bert_cases(rank, world, inp)


def resnet_dp_cases(rank, world, inp):
    from torch_model_dp_cases import resnet_cases

    return resnet_cases(rank, world, inp)


def random_cases(rank, world, inp):
    from torch_random_cases import random_cases as cases

    return cases(rank, world, inp)


def amp_loss_cases(rank, world, inp):
    from torch_amp_loss_cases import amp_loss_cases as cases

    return cases(rank, world, inp)


def checkpoint_cases(rank, world, inp):
    """A gpt3_tiny step at ZeRO-3 over `world` sharding ranks saves its
    training state after 2 AdamW steps (each rank its own shards), then a
    fresh step at mp `world` restores it: both return the whole parameters
    and moments (gathered) for the test to hold to each other, to one rank
    and to the JAX package."""
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         Metadata)
    from paddle_tpu_torch.distributed.checkpoint.metadata import metadata_path
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)

    out = {}
    root = os.path.join(inp["dir"], "ck")

    def case(name, fn):
        try:
            out[name] = fn()
        except Exception:  # the case's test reports the traceback
            out[name] = "ERROR " + traceback.format_exc()

    def build(shape, stage, seed):
        mesh = dist.build_mesh(**shape)
        model = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=seed)
        crit = GPTPretrainingCriterion()
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        return dist.DistributedTrainStep(model, lambda lg, lb: crit(lg, lb),
                                         opt, mesh=mesh, sharding_stage=stage)

    def whole(step):
        """Every parameter and moment whole (a collective)."""
        from paddle_tpu_torch.parallel.pipeline import gather_stages

        opt = step.optimizer
        names = {id(p): k for k, p in step.params.items()}
        state = {k: v.numpy() for k, v in step.state_dict().items()}
        for i, p in enumerate(opt._params()):
            for key, v in opt._states[id(p)].items():
                v = step._gather_state(names[id(p)], v)
                if getattr(p, "pp_part", None) is not None:
                    v = gather_stages(v, step._pp_pg, p.pp_part[2])
                state[f"optimizer.param_{i}.{key}"] = v.numpy()
        state["optimizer._step_count"] = np.asarray(opt._step_count)
        return state

    def zero3_save():
        step = build(dict(sharding=world), 3, seed=3)
        for ids in inp["ids"][:2]:
            step(ids, ids)
        st = step.train_state()
        mgr = CheckpointManager(root)
        mgr.save(st, 2)
        meta = Metadata.load(metadata_path(mgr.path_for(2)))
        files = sorted({m.file_name for v in meta.state_dict_metadata.values()
                        for m in v})
        shards = {k: [tuple(m.global_offset) for m in v]
                  for k, v in meta.state_dict_metadata.items()}
        state = whole(step)
        losses = [step(ids, ids).item() for ids in inp["ids"][2:]]
        return dict(state=state, files=files, shards=shards, losses=losses,
                    local={k: tuple(t.shape) for k, t in
                           step.model.state_dict().items()})

    def mp_restore():
        step = build(dict(mp=world), 0, seed=11)
        got = CheckpointManager(root).restore_latest(step.train_state())
        state = whole(step)
        losses = [step(ids, ids).item() for ids in inp["ids"][2:]]
        return dict(step=got, state=state, losses=losses)

    def vpp_save():
        """gpt3_tiny at 4 layers over pp 2 with VPP (2 chunks a stage):
        each rank writes its stage's rows of every stack, two runs."""
        import dataclasses

        from paddle_tpu_torch.models import GPTForCausalLMPipe

        mesh = dist.build_mesh(pp=world)
        cfg = dataclasses.replace(gpt3_tiny(), num_layers=4)
        model = GPTForCausalLMPipe(cfg, num_microbatches=2, pp_schedule="vpp",
                                   vpp_degree=2, device="cpu", seed=7)
        crit = GPTPretrainingCriterion()
        step = dist.DistributedTrainStep(
            model, lambda lg, lb: crit(lg, lb),
            AdamW(learning_rate=1e-3, parameters=model.parameters()),
            mesh=mesh)
        for ids in inp["ids"][:2]:
            step(ids, ids)
        mgr = CheckpointManager(os.path.join(inp["dir"], "ck_vpp"))
        mgr.save(step.train_state(), 2)
        meta = Metadata.load(metadata_path(mgr.path_for(2)))
        return dict(state=whole(step), shards={
            k: sorted(tuple(m.global_offset) for m in v)
            for k, v in meta.state_dict_metadata.items()})

    case("zero3_save", zero3_save)
    dist.barrier()
    case("mp_restore", mp_restore)
    dist.barrier()
    case("vpp_save", vpp_save)
    return out


SUITES = {"collective": collective_cases, "sharding": sharding_cases,
          "tensor_parallel": tensor_parallel_cases,
          "pipeline": pipeline_cases, "pipeline_gate": pipeline_gate_cases,
          "segment_parallel": segment_parallel_cases,
          "segment_gate": segment_gate_cases,
          "expert_parallel": expert_parallel_cases,
          "bert_dp": bert_dp_cases, "resnet_dp": resnet_dp_cases,
          "random": random_cases, "amp_loss": amp_loss_cases,
          "checkpoint": checkpoint_cases}


def main():
    suite, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    inp["dir"] = tmp
    dist.init_parallel_env(device="cpu", init_method=f"file://{tmp}/store",
                           rank=rank, world_size=world,
                           timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = SUITES[suite](rank, world, inp)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt.part"))
        os.replace(os.path.join(tmp, f"out{rank}.pt.part"),
                   os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """WORLD ranks of SUITE started as processes (`start`), their results
    collected (`results`): {case: [rank 0's result, rank 1's, ...]}. A rank
    that exits non-zero, or a group still running after `timeout` seconds,
    is a RuntimeError naming what the ranks printed; every rank is killed
    on the way out."""

    def __init__(self, suite, world, tmp, inputs):
        import subprocess

        self.world, self.tmp = world, str(tmp)
        os.makedirs(self.tmp, exist_ok=True)
        torch.save(inputs, os.path.join(self.tmp, "in.pt"))
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(r),
             str(world), self.tmp], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self, timeout=180):
        import subprocess
        import time

        end = time.monotonic() + timeout
        logs = []
        try:
            for p in self.procs:
                try:
                    logs.append(p.communicate(
                        timeout=max(1.0, end - time.monotonic()))[0])
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"{self.world} ranks still running "
                                       f"after {timeout} s") from None
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, logs[r][-3000:])
               for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks failed: {bad}")
        outs = [torch.load(os.path.join(self.tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(self.world)]
        return {k: [o[k] for o in outs] for k in outs[0]}


def check(result):
    """A case's result, or the traceback it recorded raised."""
    if isinstance(result, str) and result.startswith("ERROR "):
        raise AssertionError(result)
    return result


if __name__ == "__main__":
    main()
