"""The cases of one rank of `tests/test_torch_pipeline.py` (suites
"pipeline" and "pipeline_gate" of `tests/torch_dist_worker.py`): the
schedules of `parallel.pipeline`, `GPTForCausalLMPipe` through
`DistributedTrainStep`, fleet's `PipelineLayer` / `PipelineParallel`, and
`dryrun_multichip`'s config A. Imports torch and the port only."""

import traceback

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import env, fleet
from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import (
    ColumnParallelLinear, RowParallelLinear)
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, SharedLayerDesc)
from paddle_tpu_torch.models import (GPTForCausalLMPipe,
                                     GPTPretrainingCriterion, gpt3_tiny,
                                     llama_tiny, stack_layered_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.parallel import pipeline as P

M = 2   # microbatches of the GPT cases


def _np(t):
    return t.detach().numpy().copy()


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _tanh_stage(W):
    def stage(x, m):
        h, tag = x
        return torch.tanh(h @ W), tag
    return stage


def schedule_cases(rank, world, inp, group):
    """The three schedules on `world` stages against the JAX ones; the
    sizes and arrays are the test's (inp["sched"][world])."""
    a = inp["sched"][world]
    S, res = world, {}

    # GPipe: outputs (riders in order) and the gradients of sum(out^2)
    W = _t(a["Ws"][rank], True)
    x = _t(a["x"], True)
    tags = _t(a["tags"])
    out, otags = P.unmicrobatch(P.pipeline_spmd(
        _tanh_stage(W), P.microbatch((x, tags), a["M"]), group=group))
    (out ** 2).sum().backward()
    res["spmd"] = dict(out=_np(out), tags=_np(otags), dW=_np(W.grad),
                       dx=_np(x.grad) if rank == 0 else None,
                       in_flight=P.IN_FLIGHT["gpipe"])

    # double_buffer keeps the math: the same bits
    W2 = _t(a["Ws"][rank], True)
    out2, _ = P.unmicrobatch(P.pipeline_spmd(
        _tanh_stage(W2), P.microbatch((_t(a["x"]), tags), a["M"]),
        group=group, double_buffer=True))
    (out2 ** 2).sum().backward()
    res["spmd_double_buffer_same_bits"] = bool(
        torch.equal(out2, out.detach()) and torch.equal(W2.grad, W.grad))

    # 1F1B: the loss (riders take part) and the gradients of stage
    # weights, head weights and inputs
    W = _t(a["Ws"][rank], True)
    Wl = _t(a["Wl"], True)
    x = _t(a["xm"], True)

    def loss_fn(y, m):
        h, tag = y
        return torch.mean((h @ Wl) ** 2 * (1.0 + 0.01 * tag[:, None]))

    loss = P.pipeline_1f1b(_tanh_stage(W), loss_fn, (x, _t(a["tags_m"])),
                           group=group)
    res["1f1b"] = dict(loss=loss.item(), dW=_np(W.grad),
                       dWl=_np(Wl.grad) if rank == S - 1 else None,
                       dx=_np(x.grad) if rank == 0 else None,
                       in_flight=P.IN_FLIGHT["1f1b"])
    if S == 2:
        # VPP: chunk v of stage s is virtual stage v * S + s
        V = a["V"]
        Wc = [_t(a["Wv"][v * S + rank], True) for v in range(V)]

        def chunk(v, x, m):
            (h,) = x
            return (torch.tanh(h @ Wc[v]),)

        (o,) = P.pipeline_interleaved(chunk, (_t(a["xm"]),), group=group,
                                      num_chunks=V)
        (o ** 2).sum().backward()
        res["vpp"] = dict(out=_np(o), dW=[_np(w.grad) for w in Wc],
                          in_flight=P.IN_FLIGHT["vpp"])
        try:
            P.pipeline_interleaved(chunk, (_t(a["xm"][:S]),), group=group,
                                   num_chunks=V, double_buffer=True)
            res["vpp_double_buffer_raises"] = None
        except ValueError as e:
            res["vpp_double_buffer_raises"] = str(e)
    return res


def one_stage_cases(inp):
    """group=None: the one-stage schedules, no sends."""
    a = inp["sched"][1]
    W = _t(a["Ws"][0])
    Wl = _t(a["Wl"])
    before = dict(P.PP_CALLS)
    loss = P.pipeline_1f1b(
        lambda x, m: (torch.tanh(x[0] @ W),),
        lambda y, m: torch.mean((y[0] @ Wl) ** 2), (_t(a["xm"]),))
    (out,) = P.pipeline_spmd(lambda x, m: (torch.tanh(x[0] @ W),),
                             (_t(a["xm"]),))
    return dict(loss=loss.item(), out=_np(out),
                calls={k: v - before.get(k, 0) for k, v in P.PP_CALLS.items()
                       if v != before.get(k, 0)})


def _cfg(name, **kw):
    cfg = (llama_tiny if name == "llama" else gpt3_tiny)(**kw)
    cfg.num_layers = 4
    return cfg


def pipeline_cases(rank, world, inp):
    out = {}

    def case(name, fn):
        try:
            out[name] = fn()
        except Exception:  # the case's test reports the traceback
            out[name] = "ERROR " + traceback.format_exc()
        env.set_global_mesh(None)

    def sched():
        mesh = dist.build_mesh(pp=world)
        return schedule_cases(rank, world, inp, env.mesh_group(mesh, "pp"))

    case(f"schedules_s{world}", sched)
    if world == 2:
        case("one_stage", lambda: one_stage_cases(inp))

    def step(shape, cfg, state, schedule="1f1b", stage=0, steps=4,
             opt=None, clip=None, mask=False, specs=False):
        mesh = dist.build_mesh(**shape)
        model = GPTForCausalLMPipe(cfg, num_microbatches=M,
                                   pp_schedule=schedule, device="cpu", seed=5)
        crit = GPTPretrainingCriterion(cfg)
        lr = inp["gpt_lr"] if opt is None else inp["sgd_lr"]
        o = (opt or AdamW)(learning_rate=lr, parameters=model.parameters(),
                           grad_clip=None if clip is None
                           else ClipGradByGlobalNorm(clip))
        fn = ((lambda lg, lb, m: crit(lg, lb, m)) if mask
              else (lambda lg, lb: crit(lg, lb)))
        # specs: the batch cut by input_specs / label_specs over dp
        spec = [env.PartitionSpec("dp", None)] if specs else None
        st = dist.DistributedTrainStep(
            model, fn, o, mesh=mesh, sharding_stage=stage, input_specs=spec,
            label_specs=spec and spec * (2 if mask else 1))
        load_paddle_tpu_state(model, state)
        labels = [inp["gpt_labels"], inp["mask"]] if mask else \
            [inp["gpt_labels"]]
        losses, calls = [], []
        for _ in range(steps):
            before = dict(P.PP_CALLS)
            losses.append(st(inp["gpt_ids"], labels).item())
            calls.append({k: v - before.get(k, 0)
                          for k, v in P.PP_CALLS.items()})
        return dict(losses=losses, pp_calls=calls,
                    in_flight=P.IN_FLIGHT.get("1f1b"),
                    stage_layers=tuple(
                        model.stack__input_layernorm__weight.shape)[0],
                    params={k: _np(v) for k, v in st.state_dict().items()})

    gpt, llama, layered = inp["gpt_pipe"], inp["llama_pipe"], inp["layered"]

    def forward(shape, schedule, state, V=1):
        dist.build_mesh(**shape)
        model = GPTForCausalLMPipe(_cfg("gpt"), num_microbatches=4,
                                   pp_schedule=schedule, vpp_degree=V,
                                   device="cpu", seed=5)
        model.eval()
        assert model.num_stages() == shape["pp"]   # cut over the mesh's pp
        load_paddle_tpu_state(model, state)
        with torch.no_grad():
            return _np(model(_t(inp["gpt_ids"])))

    def masked_1f1b(shape, specs=False):
        # the layered weights; the test holds the loss to the reference's
        # (pp 1: the whole batch's; pp > 1: the mean of the microbatches')
        return step(shape, _cfg("gpt"),
                    stack_layered_state_dict(layered, 4), mask=True,
                    opt=SGD, steps=3, specs=specs)

    if world == 2:
        case("gpt_1f1b_pp2", lambda: step(dict(pp=2), _cfg("gpt"), gpt))
        case("llama_1f1b_pp2", lambda: step(dict(pp=2), _cfg("llama"), llama,
                                            steps=3))
        case("gpt_clip_sgd_pp2", lambda: step(
            dict(pp=2), _cfg("gpt"), gpt, opt=SGD, clip=inp["gpt_clip"],
            steps=3))
        case("forward_pp2", lambda: forward(dict(pp=2), "gpipe", gpt))
        case("forward_vpp_pp2", lambda: forward(dict(pp=2), "vpp", gpt, V=2))
        case("forward_layered_pp2", lambda: forward(
            dict(pp=2), "gpipe", stack_layered_state_dict(layered, 4)))
        case("masked_1f1b_dp2", lambda: masked_1f1b(dict(dp=2)))

        def convert_back(V):
            dist.build_mesh(pp=2)
            model = GPTForCausalLMPipe(_cfg("gpt"), num_microbatches=2,
                                       pp_schedule="vpp" if V > 1 else
                                       "1f1b", vpp_degree=V, device="cpu")
            assert model.num_stages() == 2
            load_paddle_tpu_state(model, gpt)
            return dict(rows=tuple(model.stack__mlp__fc1__weight.shape)[0],
                        params={k: _np(v) for k, v in
                                dist.full_state_dict(model).items()})

        case("convert_pp2", lambda: convert_back(1))
        case("convert_vpp_pp2", lambda: convert_back(2))
        case("wrapper", lambda: wrapper_cases(rank, inp))
    if world == 4:
        case("gpt_1f1b_pp2_mp2_sp", lambda: step(
            dict(pp=2, mp=2), _cfg("gpt", sequence_parallel=True), gpt))
        case("gpt_1f1b_dp2_pp2", lambda: step(dict(dp=2, pp=2), _cfg("gpt"),
                                              gpt))
        for stage in (1, 2, 3):
            case(f"gpt_1f1b_pp2_sharding2_stage{stage}",
                 lambda: step(dict(pp=2, sharding=2), _cfg("gpt"), gpt,
                              stage=stage))
        case("masked_gpipe_dp2_pp2", lambda: step(
            dict(dp=2, pp=2), _cfg("gpt"), gpt, schedule="gpipe", mask=True,
            opt=SGD, steps=3))
        case("masked_1f1b_dp2_pp2", lambda: masked_1f1b(dict(dp=2, pp=2)))
        case("masked_1f1b_dp2_pp2_specs", lambda: masked_1f1b(
            dict(dp=2, pp=2), specs=True))
        case("wrapper_dp2_pp2", lambda: wrapper_mesh_cases(rank, inp, dp=2))
        case("wrapper_pp2_mp2", lambda: wrapper_mesh_cases(rank, inp, mp=2))
        case("forward_pp4", lambda: forward(dict(pp=4), "gpipe", gpt))
    return out


class _Lin(pnn.Linear):
    """A Linear that takes the layer-description signature (in, out,
    bias)."""

    def __init__(self, i, o, bias=True):
        super().__init__(i, o, bias_attr=None if bias else False,
                         device="cpu")


def wrapper_cases(rank, inp):
    """fleet's PipelineLayer / PipelineParallel at pp 2 (the reference's
    TestPipelineLayerWrapper): partition, shared layers, train_batch. The
    weights are the test's, by entry (a shared key's from its first)."""
    w = inp["wrapper"]
    res = {}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    res["place"] = (hcg.get_stage_id(), hcg.is_first_stage(),
                    hcg.is_last_stage(), hcg._get_p2p_prev_rank(),
                    hcg._get_p2p_next_rank())
    for name, descs in (("uniform", [LayerDesc(_Lin, 16, 16)
                                     for _ in range(4)]),
                        ("nonuniform", [LayerDesc(_Lin, 16, 32),
                                        LayerDesc(_Lin, 32, 16, False),
                                        LayerDesc(_Lin, 16, 16)]),
                        ("shared", [SharedLayerDesc("tie", _Lin, None,
                                                    "weight", 16, 16),
                                    LayerDesc(_Lin, 16, 16),
                                    LayerDesc(_Lin, 16, 16),
                                    SharedLayerDesc("tie", _Lin, None,
                                                    "weight", 16, 16)])):
        for mode in ("1F1B", "FThenB") + (("clip",) if name == "shared"
                                          else ()):
            pl = PipelineLayer(descs, num_stages=2,
                               loss_fn=lambda o, y: ((o - y) ** 2).mean())
            entries = _entries(pl)
            with torch.no_grad():
                for i, layer in entries.items():
                    for k, p in layer.named_parameters():
                        p.copy_(_t(w[name][i][k]))
            strategy.hybrid_configs = {"pp_configs": {
                "micro_batch_size": 2,
                "schedule_mode": "1F1B" if mode == "clip" else mode}}
            model = fleet.distributed_model(pl)
            # "clip": a binding global-norm clip through fleet's optimizer,
            # whose squared sum spans the stages, the tie counted once
            opt = SGD(learning_rate=0.05, parameters=pl.parameters(),
                      grad_clip=ClipGradByGlobalNorm(w["clip"])
                      if mode == "clip" else None)
            if mode == "clip":
                opt = fleet.distributed_optimizer(opt)
            losses = [model.train_batch((w["x"], w["y"]), opt).item()
                      for _ in range(3)]
            res[f"{name}_{mode}"] = dict(
                wrapped=type(model).__name__, losses=losses,
                eval=model.eval_batch((w["x"], w["y"])).item(),
                parts=pl.segment_parts,
                mine=len(pl.get_stage_layers(rank)),
                owned=[bool(p.is_firstly_shared) for layer in
                       pl.shared_layers.values() for p in layer.parameters()],
                params={i: {k: _np(p) for k, p in layer.named_parameters()}
                        for i, layer in entries.items()})
    return res


def wrapper_mesh_cases(rank, inp, dp=1, mp=1):
    """train_batch at dp 2 x pp 2 (each batch rank given its own rows) and
    at pp 2 x mp 2 (a column- then a row-parallel Linear on stage 0, cut
    by the wrapper from the full weights), 1F1B and FThenB. The ranks that
    are not their group's first (dp rank 1, mp rank 1) start from other
    replicated weights, which the wrapper's broadcasts replace. The
    parameters come back whole (an mp cut gathered)."""
    w = inp["wrapper"]
    name = "mp" if mp > 1 else "uniform"
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "pp_degree": 2,
                               "mp_degree": mp}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    mpg = hcg.get_model_parallel_group()
    other = (hcg.get_data_parallel_rank() if dp > 1
             else hcg.get_model_parallel_rank()) > 0
    if mp > 1:
        descs = [LayerDesc(ColumnParallelLinear, 16, 32, has_bias=True,
                           gather_output=False, device="cpu"),
                 LayerDesc(RowParallelLinear, 32, 16, has_bias=True,
                           input_is_parallel=True, device="cpu"),
                 LayerDesc(_Lin, 16, 16), LayerDesc(_Lin, 16, 16)]
    else:
        descs = [LayerDesc(_Lin, 16, 16) for _ in range(4)]
    k = w["x"].shape[0] // dp
    rows = slice(hcg.get_data_parallel_rank() * k,
                 (hcg.get_data_parallel_rank() + 1) * k)
    res = {}
    for mode in ("1F1B", "FThenB"):
        pl = PipelineLayer(descs, num_stages=2,
                           loss_fn=lambda o, y: ((o - y) ** 2).mean())
        entries = _entries(pl)
        with torch.no_grad():
            for i, layer in entries.items():
                for key, p in layer.named_parameters():
                    p.copy_(_t(w[name][i][key]))
                    if other and isinstance(layer, _Lin):
                        p.add_(1.0)
        strategy.hybrid_configs = {"pp_configs": {"micro_batch_size": 2,
                                                  "schedule_mode": mode}}
        model = fleet.distributed_model(pl)
        opt = SGD(learning_rate=0.05, parameters=pl.parameters())
        data = (w["x"][rows], w["y"][rows])
        losses = [model.train_batch(data, opt).item() for _ in range(3)]
        params = {}
        for i, layer in entries.items():
            params[i] = {}
            for key, p in layer.named_parameters():
                full = w[name][i][key].shape
                v = p.detach()
                if tuple(v.shape) != full:
                    d = next(j for j, (a, b) in enumerate(zip(v.shape, full))
                             if a != b)
                    parts = []
                    dist.all_gather(parts, v.contiguous(), group=mpg)
                    v = torch.cat(parts, d)
                params[i][key] = _np(v)
        res[mode] = dict(
            wrapped=type(model).__name__, losses=losses,
            eval=model.eval_batch(data).item(),
            cut=[tuple(p.shape) for layer in entries.values()
                 for p in layer.parameters()],
            params=params)
    return res


def _entries(pl):
    """{entry index: layer} of the layers this rank runs, a shared layer
    under the first entry of its key."""
    first = {}
    for i, d in enumerate(pl.descs):
        if isinstance(d, SharedLayerDesc):
            first.setdefault(d.layer_name, i)
    out = {}
    for i, f, _ in pl.run_funcs:
        d = pl.descs[i]
        out[first[d.layer_name] if isinstance(d, SharedLayerDesc) else i] = f
    return out


def gate_cases(rank, world, inp):
    """dryrun_multichip's config A (`__graft_entry__.py:111-139`): dp 1 x pp
    2 x sharding 2 x mp 2, sequence_parallel, stage 1, 4 layers, B 4 x 16,
    M 2, AdamW 1e-4: one step."""
    out = {}
    try:
        mesh = dist.build_mesh(dp=1, pp=2, sharding=2, mp=2)
        cfg = _cfg("gpt", sequence_parallel=True)
        model = GPTForCausalLMPipe(cfg, num_microbatches=2,
                                   pp_schedule="1f1b", device="cpu")
        crit = GPTPretrainingCriterion(cfg)
        st = dist.DistributedTrainStep(
            model, lambda lg, lb: crit(lg, lb),
            AdamW(learning_rate=1e-4, parameters=model.parameters()),
            mesh=mesh, sharding_stage=1)
        load_paddle_tpu_state(model, inp["gate_state"])
        out["loss"] = st(inp["gate_ids"], inp["gate_labels"]).item()
    except Exception:
        out["loss"] = "ERROR " + traceback.format_exc()
    return out
