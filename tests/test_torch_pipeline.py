"""The port's pipeline parallelism, held to the JAX package at 2, 4 and 8
gloo ranks on the CPU (the pattern of `tests/test_pipeline.py`).

A 2-rank and a 4-rank group (suite "pipeline") and an 8-rank group (suite
"pipeline_gate") are spawned once for the module
(`torch_dist_worker.Ranks`; the cases are in `tests/torch_pp_cases.py`);
they run while the JAX references trace here, once each, on the
conftest's virtual CPU devices. The GPT weights are the JAX package's
initial ones, carried by `convert.load_paddle_tpu_state` into a model the
step (or the global mesh) has cut already, so each rank takes its stage's
rows.

- The schedules (TestPipelineSpmd): `pipeline_spmd` forward (riders in
  order) and gradients at S 2 and 4, `pipeline_1f1b` loss and gradients
  (stage weights, head weights, inputs) at S 2 and 4, the one-stage case,
  `pipeline_interleaved` at S 2, V 2, against the JAX schedules (SCHED_TOL,
  the reference test's); the in-flight counts (1F1B min(M, S - s), GPipe
  M); `double_buffer` bit for bit; the stack/unstack round trip.
- The GPT pipe (TestGPTPipe): logits against the JAX pipe at pp 2 and 4
  (GPipe) and pp 2 x V 2 (VPP), and against the JAX layered model through
  `stack_layered_state_dict` (LOGIT_TOL); the 1F1B `DistributedTrainStep`
  at pp 2 (AdamW, 4 steps), pp 2 x mp 2 with `sequence_parallel`, dp 2 x
  pp 2, pp 2 x sharding 2 at stages 1-3, llama_tiny at pp 2, and a binding
  global-norm clip under SGD at pp 2, against the JAX step at the same
  mesh: losses (STEP_TOL) and parameters (PARAM_TOL under SGD,
  ADAM_PARAM_TOL under AdamW; the gate's rtol is 2e-3, these hold
  tighter); the pp collectives of a step. A `loss_mask`ed
  criterion at dp 2 x pp 2 under GPipe against the JAX step, and under
  1F1B at dp 2 (one stage: the whole batch's loss) and dp 2 x pp 2 (the
  mean of the global microbatches' losses) against the JAX layered step
  with that loss, also with the batch cut by `input_specs` /
  `label_specs`. The 1F1B route's refusal of a second input. `convert`
  into a pp-cut (and a VPP-cut) model and `full_state_dict` back, bit for
  bit.
- The wrapper (TestPipelineLayerWrapper): `PipelineLayer`'s partition,
  shared-layer ownership, and `PipelineParallel.train_batch` with 1F1B and
  FThenB against the JAX wrapper's sequential loop, for uniform,
  non-uniform and shared-layer stages, and at dp 2 x pp 2 and pp 2 x mp 2
  (column- and row-parallel Linears cut by the wrapper).
- The gate, once: `dryrun_multichip`'s config A at 8 gloo ranks within
  rtol 2e-3 of the JAX single-device baseline and of the JAX step at the
  same 8-device mesh.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet.base.distributed_strategy import (
    DistributedStrategy as JaxStrategy)
from paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel import (
    PipelineParallel as JaxPipelineParallel)
from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import (
    LayerDesc as JaxLayerDesc, PipelineLayer as JaxPipelineLayer,
    SharedLayerDesc as JaxSharedLayerDesc)
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTForCausalLMPipe as JaxPipe
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt3_tiny as jax_gpt3_tiny
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.parallel import pipeline as jpp
from paddle_tpu_torch.models import stack_layered_state_dict
from paddle_tpu_torch.parallel import pipeline as P
from torch_dist_worker import Ranks, check

WORLDS = (2, 4)
SCHED_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
# AdamW moves a coordinate whose gradient is rounding noise by up to lr a
# step either way: the JAX step's own stack__mlp__fc1__weight differs by
# 6.6e-6 between its pp 2 and pp 2 x mp 2 meshes after 4 steps at lr 1e-4
ADAM_PARAM_TOL = dict(rtol=1e-4, atol=3e-5)
GATE_RTOL = 2e-3
GPT_LR, SGD_LR, GPT_CLIP, WRAP_LR, WRAP_CLIP = 1e-4, 0.5, 0.1, 0.05, 0.05
AXES = ("dp", "pp", "sharding", "sep", "mp")


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _jt(a):
    t = paddle.to_tensor(np.asarray(a))
    t.stop_gradient = True
    return t


def _mesh(S):
    return Mesh(np.array(jax.devices()[:S]).reshape(1, S, 1, 1, 1), AXES)


def _cfg(fn=jax_gpt3_tiny, **kw):
    cfg = fn(**kw)
    cfg.num_layers = 4
    return cfg


# -- inputs ------------------------------------------------------------------ #

def _sched_inputs():
    out = {}
    for S, seed in ((1, 3), (2, 1), (4, 2)):
        rng = np.random.default_rng(seed)
        M, mb, H, V = 4, 2, 8, 2

        def f32(*shape, scale=1.0):
            return (rng.normal(size=shape) * scale).astype(np.float32)

        tags = np.arange(M * mb, dtype=np.int32)
        out[S] = dict(M=M, mb=mb, V=V, Ws=f32(S, H, H, scale=0.4),
                      Wl=f32(H, 1), x=f32(M * mb, H), xm=f32(M, mb, H),
                      tags=tags, tags_m=tags.reshape(M, mb),
                      Wv=f32(S * V, H, H, scale=0.4))
    return out


def _wrapper_inputs():
    rng = np.random.default_rng(4)
    shapes = {"uniform": [(16, 16, True)] * 4,
              "nonuniform": [(16, 32, True), (32, 16, False), (16, 16, True)],
              "shared": [(16, 16, True)] * 4}
    out = {}
    for name, layers in shapes.items():
        entries = {}
        for i, (a, b, bias) in enumerate(layers):
            if name == "shared" and i == 3:
                continue   # the tie of entry 0
            e = {"weight": (rng.normal(size=(a, b)) * 0.3).astype(np.float32)}
            if bias:
                e["bias"] = (rng.normal(size=b) * 0.1).astype(np.float32)
            entries[i] = e
        out[name] = entries
    out["x"] = rng.normal(size=(8, 16)).astype(np.float32)
    out["y"] = rng.normal(size=(8, 16)).astype(np.float32)
    out["clip"] = WRAP_CLIP
    # the pp 2 x mp 2 case's layers (a column- and a row-parallel Linear,
    # then two Linears), whole
    out["mp"] = {i: {"weight": (rng.normal(size=(a, b)) * 0.3).astype(
        np.float32), "bias": (rng.normal(size=b) * 0.1).astype(np.float32)}
        for i, (a, b) in enumerate([(16, 32), (32, 16), (16, 16), (16, 16)])}
    return out


def _inputs():
    paddle.seed(0)
    gpt_pipe = _state(JaxPipe(_cfg(), num_microbatches=2, pp_schedule="1f1b"))
    paddle.seed(0)
    llama_pipe = _state(JaxPipe(_cfg(jax_llama_tiny), num_microbatches=2,
                                pp_schedule="1f1b"))
    paddle.seed(0)
    layered = _state(JaxGPT(_cfg()))
    paddle.seed(0)
    gate_state = _state(JaxPipe(_cfg(sequence_parallel=True),
                                num_microbatches=2, pp_schedule="1f1b"))
    mask = np.zeros((4, 16), np.float32)
    mask[0] = 1.0          # microbatch 0 keeps 19 tokens, microbatch 1 keeps 24
    mask[1, :3] = 1.0
    mask[2:, :12] = 1.0
    return dict(
        sched=_sched_inputs(), wrapper=_wrapper_inputs(), gpt_pipe=gpt_pipe,
        llama_pipe=llama_pipe, layered=layered, gate_state=gate_state,
        gpt_ids=np.random.default_rng(0).integers(0, 1024, (4, 16)),
        gpt_labels=np.random.default_rng(1).integers(0, 1024, (4, 16)),
        gate_ids=np.random.default_rng(0).integers(0, 1024, (4, 16)),
        gate_labels=np.random.default_rng(1).integers(0, 1024, (4, 16)),
        mask=mask, gpt_lr=GPT_LR, sgd_lr=SGD_LR, gpt_clip=GPT_CLIP)


# -- the JAX references --------------------------------------------------------- #

def _jax_schedules(a, S):
    mesh = _mesh(S)
    Ws, x, tags = (jnp.asarray(a[k]) for k in ("Ws", "x", "tags"))

    def stage_fn(W, inp):
        h, tag = inp
        return (jnp.tanh(h @ W), tag)

    def spmd(Ws, x):
        return jpp.unmicrobatch(jpp.pipeline_spmd(
            stage_fn, Ws, jpp.microbatch((x, tags), a["M"]), mesh=mesh))

    out, otags = spmd(Ws, x)
    dW, dx = jax.grad(lambda W, xx: (spmd(W, xx)[0] ** 2).sum(),
                      (0, 1))(Ws, x)
    Wl, xm, tm = (jnp.asarray(a[k]) for k in ("Wl", "xm", "tags_m"))

    def loss_fn(lp, out):
        h, tag = out
        return jnp.mean((h @ lp) ** 2 * (1.0 + 0.01 * tag[:, None]))

    def f1b(Ws, Wl, xm):
        return jpp.pipeline_1f1b(stage_fn, loss_fn, Ws, Wl, (xm, tm),
                                 mesh=mesh)

    ref = dict(spmd=dict(out=np.asarray(out), tags=np.asarray(otags),
                         dW=np.asarray(dW), dx=np.asarray(dx)))
    loss = f1b(Ws, Wl, xm)
    g = jax.grad(f1b, (0, 1, 2))(Ws, Wl, xm)
    ref["1f1b"] = dict(loss=float(loss), dW=np.asarray(g[0]),
                       dWl=np.asarray(g[1]), dx=np.asarray(g[2]))
    if S == 2:
        V, Wv = a["V"], jnp.asarray(a["Wv"])

        def vpp(Wv):
            (o,) = jpp.pipeline_interleaved(
                lambda W, inp: (jnp.tanh(inp[0] @ W),),
                jpp.pack_chunked(Wv, S, V), (xm,), mesh=mesh, num_chunks=V)
            return o

        ref["vpp"] = dict(out=np.asarray(vpp(Wv)), dW=np.asarray(
            jax.grad(lambda W: (vpp(W) ** 2).sum())(Wv)))
    return ref


def _jax_one_stage(a):
    mesh = _mesh(1)
    Ws, Wl, xm = (jnp.asarray(a[k]) for k in ("Ws", "Wl", "xm"))
    loss = jpp.pipeline_1f1b(
        lambda W, inp: (jnp.tanh(inp[0] @ W),),
        lambda lp, out: jnp.mean((out[0] @ lp) ** 2), Ws, Wl, (xm,),
        mesh=mesh)
    (out,) = jpp.pipeline_spmd(lambda W, inp: (jnp.tanh(inp[0] @ W),), Ws,
                               (xm,), mesh=mesh)
    return dict(loss=float(loss), out=np.asarray(out))


def _jax_step(model, loss_fn, opt, mesh_kw, stage, inputs, labels, steps):
    """Losses and final parameters of the JAX DistributedTrainStep on a
    mesh of the conftest's virtual devices (jit.TrainStep without one)."""
    if mesh_kw:
        n = int(np.prod(list(mesh_kw.values())))
        step = jdist.DistributedTrainStep(
            model, loss_fn, opt, sharding_stage=stage,
            mesh=jdist.build_mesh(**mesh_kw, devices=jax.devices()[:n]))
    else:
        step = JaxTrainStep(model, loss_fn, opt)
    losses = [float(step([_jt(x) for x in inputs], [_jt(y) for y in labels]))
              for _ in range(steps)]
    step.sync_weights()
    jdist.env.set_global_mesh(None)
    return losses, _state(model)


def _jax_pipe_step(inp, mesh_kw, stage=0, cfg_fn=jax_gpt3_tiny,
                   schedule="1f1b", opt=None, clip=None, mask=False, steps=4,
                   **cfg_kw):
    paddle.seed(0)
    cfg = _cfg(cfg_fn, **cfg_kw)
    model = JaxPipe(cfg, num_microbatches=2, pp_schedule=schedule)
    crit = JaxCriterion(cfg)
    grad_clip = None if clip is None else jnn.ClipGradByGlobalNorm(clip)
    o = (jopt.SGD(learning_rate=SGD_LR, parameters=model.parameters(),
                  grad_clip=grad_clip) if opt == "sgd" else
         jopt.AdamW(learning_rate=GPT_LR, parameters=model.parameters()))
    fn = ((lambda lg, lb, m: crit(lg, lb, m)) if mask
          else (lambda lg, lb: crit(lg, lb)))
    labels = [inp["gpt_labels"], inp["mask"]] if mask else [inp["gpt_labels"]]
    return _jax_step(model, fn, o, mesh_kw, stage, [inp["gpt_ids"]], labels,
                     steps)


def _jax_masked_layered(inp, microbatches):
    """The layered model (seed 0) under SGD with the masked criterion: over
    the whole batch (microbatches 1), or the mean of it over each global
    microbatch of B / microbatches rows."""
    paddle.seed(0)
    cfg = _cfg()
    model = JaxGPT(cfg)
    crit = JaxCriterion(cfg)
    k = inp["gpt_ids"].shape[0] // microbatches

    def loss_fn(lg, lb, m):
        parts = [crit(lg[i * k:(i + 1) * k], lb[i * k:(i + 1) * k],
                      m[i * k:(i + 1) * k]) for i in range(microbatches)]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total / microbatches

    losses, state = _jax_step(
        model, loss_fn,
        jopt.SGD(learning_rate=SGD_LR, parameters=model.parameters()), {}, 0,
        [inp["gpt_ids"]], [inp["gpt_labels"], inp["mask"]], 3)
    return losses, stack_layered_state_dict(state, cfg.num_layers)


def _jax_wrapper(w):
    """The JAX wrapper's sequential loop (FThenB) on each layer list."""
    descs = {
        "uniform": [JaxLayerDesc(jnn.Linear, 16, 16) for _ in range(4)],
        "nonuniform": [JaxLayerDesc(jnn.Linear, 16, 32),
                       JaxLayerDesc(jnn.Linear, 32, 16, bias_attr=False),
                       JaxLayerDesc(jnn.Linear, 16, 16)],
        "shared": [JaxSharedLayerDesc("tie", jnn.Linear, None, "weight",
                                      16, 16),
                   JaxLayerDesc(jnn.Linear, 16, 16),
                   JaxLayerDesc(jnn.Linear, 16, 16),
                   JaxSharedLayerDesc("tie", jnn.Linear, None, "weight",
                                      16, 16)],
        "mp": [JaxLayerDesc(jnn.Linear, 16, 32),
               JaxLayerDesc(jnn.Linear, 32, 16),
               JaxLayerDesc(jnn.Linear, 16, 16),
               JaxLayerDesc(jnn.Linear, 16, 16)]}
    jdist.env.build_mesh(pp=2, devices=jax.devices()[:2])
    out = {}
    for name, ds in list(descs.items()) + [("shared_clip", descs["shared"])]:
        pl = JaxPipelineLayer(ds, num_stages=2, loss_fn=jnn.MSELoss())
        entries = w[name.replace("_clip", "")]
        layers = {i: f for i, (f, _) in enumerate(pl.run_funcs)
                  if i in entries}
        for i, layer in layers.items():
            for k, v in entries[i].items():
                getattr(layer, k).set_value(v)
        strat = JaxStrategy()
        strat.hybrid_configs = {"pp_configs": {"micro_batch_size": 2,
                                               "schedule_mode": "FThenB"}}
        model = JaxPipelineParallel(pl, None, strat)
        opt = jopt.SGD(learning_rate=WRAP_LR, parameters=pl.parameters(),
                       grad_clip=jnn.ClipGradByGlobalNorm(WRAP_CLIP)
                       if name.endswith("_clip") else None)
        losses = [float(model.train_batch((_jt(w["x"]), _jt(w["y"])),
                                          opt).numpy()) for _ in range(3)]
        out[name] = dict(losses=losses, eval=float(model.eval_batch(
            (_jt(w["x"]), _jt(w["y"]))).numpy()), params={
            i: {k: np.asarray(p.numpy()) for k, p in layer.named_parameters()}
            for i, layer in layers.items()})
    jdist.env.set_global_mesh(None)
    return out


def _jax_gate(inp):
    """`dryrun_multichip`'s config A in JAX: the single-device baseline
    (`__graft_entry__.py:157-170`: the same pipe at pp 1, stage 0) and the
    step at the 8-device mesh."""
    out = {}
    for name, mesh_kw, stage, sp in (
            ("baseline", dict(dp=1), 0, False),
            ("mesh", dict(dp=1, pp=2, sharding=2, mp=2), 1, True)):
        paddle.seed(0)
        cfg = _cfg(sequence_parallel=sp)
        model = JaxPipe(cfg, num_microbatches=2, pp_schedule="1f1b")
        crit = JaxCriterion(cfg)
        losses, _ = _jax_step(
            model, lambda lg, lb: crit(lg, lb),
            jopt.AdamW(learning_rate=1e-4, parameters=model.parameters()),
            mesh_kw, stage, [inp["gate_ids"]], [inp["gate_labels"]], 1)
        out[name] = losses[0]
    return out


def _jax_refs(inp):
    ref = {f"schedules_s{S}": _jax_schedules(inp["sched"][S], S)
           for S in WORLDS}
    ref["one_stage"] = _jax_one_stage(inp["sched"][1])
    paddle.seed(0)
    pipe = JaxPipe(_cfg(), num_microbatches=2)
    pipe.eval()
    ref["logits"] = pipe(_jt(inp["gpt_ids"])).numpy()
    paddle.seed(0)
    layered = JaxGPT(_cfg())
    layered.eval()
    ref["layered_logits"] = layered(_jt(inp["gpt_ids"])).numpy()
    ref["gpt_1f1b_pp2"] = _jax_pipe_step(inp, dict(pp=2))
    ref["llama_1f1b_pp2"] = _jax_pipe_step(inp, dict(pp=2), 0,
                                           jax_llama_tiny, steps=3)
    ref["gpt_clip_sgd_pp2"] = _jax_pipe_step(inp, dict(pp=2), opt="sgd",
                                             clip=GPT_CLIP, steps=3)
    ref["gpt_1f1b_pp2_mp2_sp"] = _jax_pipe_step(
        inp, dict(pp=2, mp=2), sequence_parallel=True)
    ref["gpt_1f1b_dp2_pp2"] = _jax_pipe_step(inp, dict(dp=2, pp=2))
    for stage in (1, 2, 3):
        ref[f"gpt_1f1b_pp2_sharding2_stage{stage}"] = _jax_pipe_step(
            inp, dict(pp=2, sharding=2), stage)
    ref["masked_gpipe_dp2_pp2"] = _jax_pipe_step(
        inp, dict(dp=2, pp=2), schedule="gpipe", opt="sgd", mask=True,
        steps=3)
    ref["masked_1f1b_dp2"] = _jax_masked_layered(inp, 1)
    ref["masked_1f1b_dp2_pp2"] = _jax_masked_layered(inp, 2)
    # the same step, its batch cut by input_specs / label_specs
    ref["masked_1f1b_dp2_pp2_specs"] = ref["masked_1f1b_dp2_pp2"]
    ref["wrapper"] = _jax_wrapper(inp["wrapper"])
    ref["gate"] = _jax_gate(inp)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = _inputs()
    groups = {w: Ranks("pipeline", w, tmp_path_factory.mktemp(f"pp{w}"), inp)
              for w in WORLDS}
    groups[8] = Ranks("pipeline_gate", 8, tmp_path_factory.mktemp("gate"),
                      inp)
    out = {"inp": inp, "jax": _jax_refs(inp)}
    for w, g in groups.items():
        try:
            out[w] = g.results(timeout=240)
        except RuntimeError as e:
            out[w] = e
    return out


def _case(runs, world, name):
    r = runs[world]
    if isinstance(r, Exception):
        raise r
    return [check(v) for v in r[name]]


def _close_params(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol,
                                   err_msg=f"{what} {k}")


# -- the schedules ------------------------------------------------------------ #

@pytest.mark.parametrize("world", WORLDS)
def test_spmd_forward_riders_and_grads_match_jax(runs, world):
    want = runs["jax"][f"schedules_s{world}"]["spmd"]
    got = _case(runs, world, f"schedules_s{world}")
    for rank, r in enumerate(got):
        g = r["spmd"]
        np.testing.assert_allclose(g["out"], want["out"], **SCHED_TOL)
        np.testing.assert_array_equal(g["tags"], want["tags"])
        np.testing.assert_allclose(g["dW"], want["dW"][rank], **SCHED_TOL)
    np.testing.assert_allclose(got[0]["spmd"]["dx"], want["dx"], **SCHED_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_1f1b_loss_and_grads_match_jax(runs, world):
    want = runs["jax"][f"schedules_s{world}"]["1f1b"]
    got = [r["1f1b"] for r in _case(runs, world, f"schedules_s{world}")]
    for rank, g in enumerate(got):
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["dW"], want["dW"][rank], **SCHED_TOL)
    np.testing.assert_allclose(got[-1]["dWl"], want["dWl"], **SCHED_TOL)
    np.testing.assert_allclose(got[0]["dx"], want["dx"], **SCHED_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_1f1b_holds_at_most_min_m_s_minus_stage_in_flight(runs, world):
    """1F1B's memory claim: stage s holds min(M, S - s) microbatches'
    inputs at most (and reaches it); GPipe holds all M."""
    M = runs["inp"]["sched"][world]["M"]
    for s, r in enumerate(_case(runs, world, f"schedules_s{world}")):
        assert r["1f1b"]["in_flight"] == min(M, world - s), (s, r["1f1b"])
        assert r["spmd"]["in_flight"] == M


def test_one_stage_schedules_match_jax_and_send_nothing(runs):
    want = runs["jax"]["one_stage"]
    for g in _case(runs, 2, "one_stage"):
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["out"], want["out"], **SCHED_TOL)
        assert g["calls"] == {}, g["calls"]


def test_interleaved_forward_and_grads_match_jax(runs):
    want = runs["jax"]["schedules_s2"]["vpp"]
    for rank, r in enumerate(_case(runs, 2, "schedules_s2")):
        g = r["vpp"]
        np.testing.assert_allclose(g["out"], want["out"], **SCHED_TOL)
        for v, dW in enumerate(g["dW"]):   # chunk v = virtual stage v*S+s
            np.testing.assert_allclose(dW, want["dW"][v * 2 + rank],
                                       **SCHED_TOL)
        assert g["in_flight"] == 2 * runs["inp"]["sched"][2]["M"]


def test_double_buffer_keeps_the_math(runs):
    for r in _case(runs, 2, "schedules_s2"):
        assert r["spmd_double_buffer_same_bits"]
        assert "2*pp-1" in r["vpp_double_buffer_raises"]


def test_stack_unstack_roundtrip():
    import torch

    trees = [{"w": torch.ones(2) * i} for i in range(3)]
    stacked = P.stack_pytrees(trees)
    assert tuple(stacked["w"].shape) == (3, 2)
    back = P.unstack_leading(stacked, 3)
    assert back[2]["w"].tolist() == [2.0, 2.0]
    x = torch.arange(12.0).reshape(6, 2)
    mb = P.microbatch(x, 3)
    assert tuple(mb.shape) == (3, 2, 2) and torch.equal(P.unmicrobatch(mb), x)
    layers = torch.arange(8)
    assert P.pack_chunked(layers, 2, 4)[:, 1].tolist() == [1, 3, 5, 7]
    assert P.stage_rows(layers, 2, 1).tolist() == [4, 5, 6, 7]
    assert P.stage_rows(layers, 2, 1, 2).tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="not divisible"):
        P.microbatch(x, 4)


def test_1f1b_route_refuses_a_second_input():
    """The forward_loss route takes the token ids alone, as the reference's
    forward_loss, whose extra input fails there: position_ids are not
    dropped in silence."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLMPipe,
                                         GPTPretrainingCriterion, gpt3_tiny)
    from paddle_tpu_torch.optimizer import SGD

    cfg = gpt3_tiny()
    cfg.num_layers = 2
    model = GPTForCausalLMPipe(cfg, num_microbatches=2, pp_schedule="1f1b",
                               device="cpu")
    crit = GPTPretrainingCriterion(cfg)
    step = TrainStep(model, lambda lg, lb: crit(lg, lb),
                     SGD(learning_rate=0.1, parameters=model.parameters()))
    ids = np.random.default_rng(0).integers(0, 1024, (2, 8))
    pos = np.broadcast_to(np.arange(8), (2, 8)).copy()
    with pytest.raises(ValueError, match="input_ids alone"):
        step([ids, pos], [ids])
    assert np.isfinite(step([ids], [ids]).item())


# -- the GPT pipe -------------------------------------------------------------- #

@pytest.mark.parametrize("case,world,key", [
    ("forward_pp2", 2, "logits"), ("forward_pp4", 4, "logits"),
    ("forward_vpp_pp2", 2, "logits"),
    ("forward_layered_pp2", 2, "layered_logits")])
def test_pipe_logits_match_jax_on_every_rank(runs, case, world, key):
    """GPipe at pp 2 and 4, VPP at pp 2 x V 2, and the JAX layered model's
    weights through stack_layered_state_dict: every rank's logits."""
    for got in _case(runs, world, case):
        np.testing.assert_allclose(got, runs["jax"][key], **LOGIT_TOL)


def _hold_step(runs, world, name):
    want_losses, want_params = runs["jax"][name]
    sgd = "sgd" in name or "masked" in name
    for r in _case(runs, world, name):
        np.testing.assert_allclose(r["losses"], want_losses, **STEP_TOL,
                                   err_msg=name)
        _close_params(r["params"], want_params,
                      PARAM_TOL if sgd else ADAM_PARAM_TOL, name)
    return _case(runs, world, name)


def test_1f1b_step_pp2_matches_jax(runs):
    got = _hold_step(runs, 2, "gpt_1f1b_pp2")
    for s, r in enumerate(got):
        assert r["stage_layers"] == 2
        assert r["in_flight"] == min(2, 2 - s)
        # a step's pp collectives: per microbatch one activation forward
        # and one gradient back (and a shape header before the first
        # activation), the loss broadcast, one sum of the shared bucket
        for calls in r["pp_calls"][1:]:
            assert (calls["send"], calls["recv"]) == \
                ((3, 2) if s == 0 else (2, 3)), calls
            assert calls["broadcast"] == 1 and calls["all_reduce"] == 1


@pytest.mark.parametrize("name,world", [
    ("gpt_1f1b_pp2_mp2_sp", 4), ("gpt_1f1b_dp2_pp2", 4),
    ("gpt_1f1b_pp2_sharding2_stage1", 4), ("gpt_1f1b_pp2_sharding2_stage2", 4),
    ("gpt_1f1b_pp2_sharding2_stage3", 4), ("llama_1f1b_pp2", 2),
    ("gpt_clip_sgd_pp2", 2), ("masked_gpipe_dp2_pp2", 4)])
def test_pipelined_step_matches_jax(runs, name, world):
    """The 1F1B step on the hybrid meshes (sequence parallel, dp, ZeRO
    stages 1-3), llama_tiny (GQA, RoPE, SwiGLU, untied head), a binding
    global-norm clip under SGD, and a loss_mask'ed criterion under GPipe,
    each against the JAX step at the same mesh."""
    _hold_step(runs, world, name)


@pytest.mark.parametrize("name,world", [("masked_1f1b_dp2", 2),
                                        ("masked_1f1b_dp2_pp2", 4),
                                        ("masked_1f1b_dp2_pp2_specs", 4)])
def test_masked_1f1b_loss_is_the_references(runs, name, world):
    """A loss_mask'ed criterion whose microbatches keep 19 and 24 tokens:
    one stage gives the whole batch's masked mean (the reference's pp = 1
    path), two the mean of the global microbatches' (its pp > 1 path),
    whether the batch is cut by default or by input_specs / label_specs
    over dp (each rank's microbatch m is its part of global microbatch
    m)."""
    _hold_step(runs, world, name)


@pytest.mark.parametrize("case", ["convert_pp2", "convert_vpp_pp2"])
def test_convert_into_a_pp_cut_model_and_back(runs, case):
    want = runs["inp"]["gpt_pipe"]
    for r in _case(runs, 2, case):
        assert r["rows"] == 2
        assert set(r["params"]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


# -- the wrapper ---------------------------------------------------------------- #

@pytest.mark.parametrize("name,mode", [
    (n, m) for n in ("uniform", "nonuniform", "shared")
    for m in ("1F1B", "FThenB")] + [("shared", "clip")])
def test_pipeline_parallel_train_batch_matches_sequential_loop(runs, name,
                                                               mode):
    """train_batch against the JAX wrapper's sequential loop; "clip": a
    binding global-norm clip through fleet.distributed_optimizer, whose
    _HybridParallelClipGrad sums over the pp group and counts the shared
    weight on its owner only."""
    want = runs["jax"]["wrapper"][name + ("_clip" if mode == "clip" else "")]
    parts = {"uniform": [0, 2, 4], "nonuniform": [0, 2, 3],
             "shared": [0, 2, 4]}[name]
    for rank, res in enumerate(_case(runs, 2, "wrapper")):
        r = res[f"{name}_{mode}"]
        assert r["wrapped"] == "PipelineParallel"
        assert r["parts"] == parts
        assert r["mine"] == parts[rank + 1] - parts[rank]
        if name == "shared":   # the first stage that declares it owns it
            assert r["owned"] == [rank == 0] * 2
        np.testing.assert_allclose(r["losses"], want["losses"], **STEP_TOL)
        np.testing.assert_allclose(r["eval"], want["eval"], **STEP_TOL)
        for i, ps in r["params"].items():
            for k, v in ps.items():
                np.testing.assert_allclose(v, want["params"][i][k],
                                           **PARAM_TOL, err_msg=f"{i}.{k}")


@pytest.mark.parametrize("case", ["wrapper_dp2_pp2", "wrapper_pp2_mp2"])
@pytest.mark.parametrize("mode", ["1F1B", "FThenB"])
def test_pipeline_parallel_over_batch_and_mp_ranks(runs, case, mode):
    """train_batch at dp 2 x pp 2, each batch rank given its half of the
    rows, and at pp 2 x mp 2 with a column- and a row-parallel Linear cut
    by the wrapper: the losses and the whole parameters of the JAX
    wrapper's sequential loop over the whole batch, on every rank."""
    name = "mp" if case.endswith("mp2") else "uniform"
    want = runs["jax"]["wrapper"][name]
    for rank, res in enumerate(_case(runs, 4, case)):
        r = res[mode]
        assert r["wrapped"] == "PipelineParallel"
        if name == "mp" and rank < 2:   # stage 0 holds the cut layers
            assert r["cut"] == [(16, 16), (16,), (16, 16), (16,)]
        np.testing.assert_allclose(r["losses"], want["losses"], **STEP_TOL)
        np.testing.assert_allclose(r["eval"], want["eval"], **STEP_TOL)
        for i, ps in r["params"].items():
            for k, v in ps.items():
                np.testing.assert_allclose(v, want["params"][i][k],
                                           **PARAM_TOL, err_msg=f"{i}.{k}")


def test_topology_places_each_stage_on_the_ring(runs):
    """fleet's topology at pp 2: stage id, first and last, and the global
    ranks of the stages beside it on the ring."""
    got = [r["place"] for r in _case(runs, 2, "wrapper")]
    assert got == [(0, True, False, 1, 1), (1, False, True, 0, 0)]


# -- the gate -------------------------------------------------------------------- #

def test_dryrun_multichip_config_a_at_8_ranks(runs):
    """dp 1 x pp 2 x sharding 2 x mp 2, sequence_parallel, stage 1: every
    rank's loss within the gate's rtol of the JAX single-device baseline
    and of the JAX step at the same mesh."""
    want = runs["jax"]["gate"]
    for r in _case(runs, 8, "loss"):
        np.testing.assert_allclose(r, want["baseline"], rtol=GATE_RTOL)
        np.testing.assert_allclose(r, want["mesh"], rtol=GATE_RTOL)
