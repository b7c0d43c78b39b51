"""The cases of one rank of `tests/test_torch_ring_attention.py` (suites
"segment_parallel" and "segment_gate" of `tests/torch_dist_worker.py`):
ring attention over a sep group, the `context_parallel` GPT and LLaMA
through the sep axis of `DistributedTrainStep`, fleet's segment mode in an
eager loop, and `dryrun_multichip`'s config B. Imports torch and the port
only."""

import traceback

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import env, fleet
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt3_tiny)
from paddle_tpu_torch.models.llama import llama_tiny
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.parallel import ring


def _np(t):
    return t.detach().numpy().copy()


def _chunk(a, n, r, dim=1):
    """Rank r of n's contiguous chunk of a along dim."""
    k = a.shape[dim] // n
    return np.take(a, np.arange(r * k, (r + 1) * k), axis=dim)


def _cfg(kind, **kw):
    cfg = (gpt3_tiny if kind == "gpt" else llama_tiny)(**kw)
    cfg.num_layers = 2
    return cfg


def _step(inp, kind, shape, state, opt="adamw", masked=False, steps=3,
          specs=False, **kw):
    """(losses, full parameters) of a context-parallel step on `shape`;
    with `specs` the batch is cut by input_specs / label_specs over dp,
    the sequence left to the step."""
    mesh = dist.build_mesh(**shape)
    cfg = _cfg(kind, context_parallel=True, **kw)
    model = GPTForCausalLM(cfg, device="cpu")
    crit = GPTPretrainingCriterion(cfg)
    o = (SGD(learning_rate=inp["sgd_lr"], parameters=model.parameters())
         if opt == "sgd" else
         AdamW(learning_rate=inp["gpt_lr"], parameters=model.parameters()))
    fn = ((lambda lg, lb, m: crit(lg, lb, m)) if masked
          else (lambda lg, lb: crit(lg, lb)))
    cut = dict(input_specs=[("dp", None)],
               label_specs=[("dp", None)] * (1 + masked)) if specs else {}
    step = dist.DistributedTrainStep(model, fn, o, mesh=mesh, **cut)
    load_paddle_tpu_state(model, state)
    ring.RING_CALLS.clear()
    labels = [inp["labels"], inp["mask"]] if masked else [inp["labels"]]
    losses = [step([inp["ids"]], labels).item() for _ in range(steps)]
    return dict(losses=losses, hops=dict(ring.RING_CALLS),
                params={k: _np(v) for k, v in step.state_dict().items()})


def segment_cases(rank, world, inp):
    out = {}

    def case(name, fn):
        try:
            out[name] = fn()
        except Exception:  # the case's test reports the traceback
            out[name] = "ERROR " + traceback.format_exc()

    def ring_case(causal):
        mesh = dist.build_mesh(sep=world)
        a = inp["ring"]
        q, k, v, do = (torch.tensor(_chunk(a[x], world, rank),
                                    requires_grad=x != "do")
                       for x in ("q", "k", "v", "do"))
        ring.RING_CALLS.clear()
        o = ring.ring_attention_spmd(q, k, v, mesh, causal=causal)
        (o * do).sum().backward()
        return dict(out=_np(o), dq=_np(q.grad), dk=_np(k.grad),
                    dv=_np(v.grad), hops=dict(ring.RING_CALLS))

    for causal in (True, False):
        case(f"ring_causal_{causal}", lambda: ring_case(causal))

    if world == 2:
        case("gpt_masked_sep2", lambda: _step(
            inp, "gpt", dict(sep=2), inp["gpt"], opt="sgd", masked=True))
    else:
        case("gpt_dp2_sep2", lambda: _step(inp, "gpt", dict(dp=2, sep=2),
                                           inp["gpt"]))
        case("gpt_dp2_sep2_specs", lambda: _step(
            inp, "gpt", dict(dp=2, sep=2), inp["gpt"], specs=True))
        case("llama_sep4", lambda: _step(inp, "llama", dict(sep=4),
                                         inp["llama"]))
        case("gpt_masked_dp2_sep2", lambda: _step(
            inp, "gpt", dict(dp=2, sep=2), inp["gpt"], opt="sgd",
            masked=True))

    def hybrid_fleet(dp, mp):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": dp, "sep_degree": 2,
                                   "mp_degree": mp}
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        cfg = _cfg("gpt", context_parallel=True)
        net = load_paddle_tpu_state(GPTForCausalLM(cfg, device="cpu"),
                                    inp["gpt"])
        model = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(
            SGD(learning_rate=inp["sgd_lr"], parameters=model.parameters()))
        crit = GPTPretrainingCriterion(cfg)
        d, s = hcg.get_data_parallel_rank(), hcg.get_sep_parallel_rank()
        ids = _chunk(_chunk(inp["ids"], dp, d, 0), 2, s)
        labels = _chunk(_chunk(inp["labels"], dp, d, 0), 2, s)
        for _ in range(3):
            crit(model(torch.tensor(ids)), torch.tensor(labels)).backward()
            opt.step()
            opt.clear_grad()
        params = {k: _np(v) for k, v in dist.full_state_dict(net).items()}
        env.set_global_mesh(None)
        return dict(mode=hcg.get_parallel_mode(), wrapped=type(model).__name__,
                    group=hcg.get_dp_sep_parallel_group().ranks,
                    params=params)

    case("segment_fleet", lambda: hybrid_fleet(world // 2, 1))
    if world == 4:
        case("tensor_fleet_sep2_mp2", lambda: hybrid_fleet(1, 2))
    return out


def gate_cases(rank, world, inp):
    """dryrun_multichip's config B (`__graft_entry__.py:52-62`, `:146-172`):
    dp 2 x sep 2 x mp 2, sequence_parallel and context_parallel, stage 0,
    gpt3_tiny at 2 layers, B 4 x 16, AdamW 1e-4: one step."""
    out = {}
    try:
        mesh = dist.build_mesh(dp=2, sep=2, mp=2)
        cfg = _cfg("gpt", sequence_parallel=True, context_parallel=True)
        model = GPTForCausalLM(cfg, device="cpu")
        crit = GPTPretrainingCriterion(cfg)
        st = dist.DistributedTrainStep(
            model, lambda lg, lb: crit(lg, lb),
            AdamW(learning_rate=1e-4, parameters=model.parameters()),
            mesh=mesh, sharding_stage=0)
        load_paddle_tpu_state(model, inp["gate_state"])
        out["loss"] = st(inp["gate_ids"], inp["gate_labels"]).item()
    except Exception:
        out["loss"] = "ERROR " + traceback.format_exc()
    return out
