"""The port's segment parallelism (ring attention under `context_parallel`),
held to the JAX package at 2, 4 and 8 gloo ranks on the CPU (the pattern
of `tests/test_ring_attention.py`).

A 2-rank and a 4-rank group (suite "segment_parallel") and an 8-rank group
(suite "segment_gate") are spawned once for the module
(`torch_dist_worker.Ranks`; the cases are in `tests/torch_sep_cases.py`);
they run while the JAX references trace here, once each, on the
conftest's virtual CPU devices. The GPT and LLaMA weights are the JAX
package's initial ones, carried by `convert.load_paddle_tpu_state`.

- The ring: `ring_attention_spmd` at sep 2 (L 8) and sep 4
  (L 4, where an off-by-one row at a chunk's edge shows), causal and not,
  GQA 4 query heads over 2 kv heads: each rank's output and q/k/v
  gradients against the JAX `ring_attention_spmd` on a JAX mesh of the
  same sep (the reference test's tolerances: rtol 1e-5, atol 1e-5 on
  values, rtol 1e-4 on gradients); the hops (the forward's n - 1, the
  backward's n - 1 and the last) and no hop at sep 1; the dense fallback
  without a mesh.
- The steps: gpt3_tiny at dp 2 x sep 2 and
  llama_tiny (RoPE, GQA, RMSNorm, SwiGLU) at sep 4 with
  `context_parallel`, 3 AdamW steps; a `loss_mask`ed criterion that keeps
  unequal counts in each sep chunk under SGD (where no AdamW normalisation
  hides a scaled gradient) at sep 2 and at dp 2 x sep 2: losses (STEP_TOL)
  and every parameter against the JAX `DistributedTrainStep` on the same
  mesh.
- fleet's segment mode: `fleet.distributed_model` gives `SegmentParallel`
  over the (dp, sep) group; 3 eager SGD steps, each rank feeding its rows
  and its chunk, against the JAX step on one device.
- The gate, once: `dryrun_multichip`'s config B (dp 2 x sep 2 x mp 2,
  `sequence_parallel`, stage 0) at 8 gloo ranks within rtol 2e-3 of the
  JAX single-device baseline and of the JAX step at the same mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt3_tiny as jax_gpt3_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.parallel.ring import ring_attention_spmd as jax_ring
from torch_dist_worker import Ranks, check

WORLDS = (2, 4)
RING_TOL = dict(rtol=1e-5, atol=1e-5)
RING_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
# AdamW moves a coordinate whose gradient is rounding noise by up to lr a
# step either way (tests/test_torch_pipeline.py's ADAM_PARAM_TOL)
ADAM_PARAM_TOL = dict(rtol=1e-4, atol=3e-5)
GATE_RTOL = 2e-3
GPT_LR, SGD_LR = 1e-4, 0.5


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _jt(a):
    t = paddle.to_tensor(np.asarray(a))
    t.stop_gradient = True
    return t


def _cfg(fn=jax_gpt3_tiny, **kw):
    cfg = fn(**kw)
    cfg.num_layers = 2
    return cfg


def _initial(cls, fn):
    paddle.seed(0)
    return _state(cls(_cfg(fn)))


def _inputs():
    rng = np.random.default_rng(5)
    B, S, H, Hkv, D = 2, 16, 4, 2, 8

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    mask = np.zeros((4, 16), np.float32)
    mask[0, :8] = 1.0          # sep chunk 0 of row 0 keeps all, chunk 1 none
    mask[1, 5:] = 1.0
    mask[2, :3] = 1.0
    mask[2, 12:] = 1.0
    mask[3, ::3] = 1.0
    return dict(
        ring=dict(q=f32(B, S, H, D), k=f32(B, S, Hkv, D), v=f32(B, S, Hkv, D),
                  do=f32(B, S, H, D)),
        gpt=_initial(JaxGPT, jax_gpt3_tiny),
        llama=_initial(JaxLlama, jax_llama_tiny),
        ids=np.random.default_rng(0).integers(0, 1024, (4, 16)),
        labels=np.random.default_rng(1).integers(0, 1024, (4, 16)),
        mask=mask, gpt_lr=GPT_LR, sgd_lr=SGD_LR,
        gate_state=_initial(JaxGPT, jax_gpt3_tiny),
        gate_ids=np.random.default_rng(0).integers(0, 1024, (4, 16)),
        gate_labels=np.random.default_rng(1).integers(0, 1024, (4, 16)))


def _jax_ring(a, n, causal):
    mesh = jdist.build_mesh(sep=n, devices=jax.devices()[:n])
    q, k, v, do = (jnp.asarray(a[x]) for x in ("q", "k", "v", "do"))

    def loss(q, k, v):
        return (jax_ring(q, k, v, mesh, causal=causal) * do).sum()

    out = jax_ring(q, k, v, mesh, causal=causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    jdist.env.set_global_mesh(None)
    return dict(out=np.asarray(out),
                **{f"d{x}": np.asarray(g) for x, g in zip("qkv", grads)})


def _jax_step(inp, cls, fn, mesh_kw, opt="adamw", masked=False, steps=3,
              **cfg_kw):
    """Losses and final parameters of the JAX DistributedTrainStep on a
    mesh of the conftest's virtual devices (jit.TrainStep without one)."""
    paddle.seed(0)
    cfg = _cfg(fn, **cfg_kw)
    model = cls(cfg)
    crit = JaxCriterion(cfg)
    o = (jopt.SGD(learning_rate=SGD_LR, parameters=model.parameters())
         if opt == "sgd" else
         jopt.AdamW(learning_rate=GPT_LR, parameters=model.parameters()))
    loss_fn = ((lambda lg, lb, m: crit(lg, lb, m)) if masked
               else (lambda lg, lb: crit(lg, lb)))
    if mesh_kw:
        n = int(np.prod(list(mesh_kw.values())))
        step = jdist.DistributedTrainStep(
            model, loss_fn, o,
            mesh=jdist.build_mesh(**mesh_kw, devices=jax.devices()[:n]))
    else:
        step = JaxTrainStep(model, loss_fn, o)
    labels = [inp["labels"], inp["mask"]] if masked else [inp["labels"]]
    losses = [float(step([_jt(inp["ids"])], [_jt(y) for y in labels]))
              for _ in range(steps)]
    step.sync_weights()
    jdist.env.set_global_mesh(None)
    return losses, _state(model)


def _jax_gate(inp):
    """`dryrun_multichip`'s config B in JAX: the single-device baseline
    (`__graft_entry__.py:157-170`: stage 0, no context or sequence
    parallelism) and the step at the 8-device mesh."""
    out = {}
    for name, mesh_kw, par in (("baseline", dict(dp=1), False),
                               ("mesh", dict(dp=2, sep=2, mp=2), True)):
        paddle.seed(0)
        cfg = _cfg(sequence_parallel=par, context_parallel=par)
        model = JaxGPT(cfg)
        crit = JaxCriterion(cfg)
        n = int(np.prod(list(mesh_kw.values())))
        step = jdist.DistributedTrainStep(
            model, lambda lg, lb: crit(lg, lb),
            jopt.AdamW(learning_rate=1e-4, parameters=model.parameters()),
            mesh=jdist.build_mesh(**mesh_kw, devices=jax.devices()[:n]),
            sharding_stage=0)
        out[name] = float(step([_jt(inp["gate_ids"])],
                               [_jt(inp["gate_labels"])]))
        jdist.env.set_global_mesh(None)
    return out


def _jax_refs(inp):
    ref = {f"ring_{n}_{c}": _jax_ring(inp["ring"], n, c)
           for n in WORLDS for c in (True, False)}
    ref["gpt_dp2_sep2"] = _jax_step(inp, JaxGPT, jax_gpt3_tiny,
                                    dict(dp=2, sep=2), context_parallel=True)
    ref["llama_sep4"] = _jax_step(inp, JaxLlama, jax_llama_tiny, dict(sep=4),
                                  context_parallel=True)
    ref["gpt_masked_sep2"] = _jax_step(inp, JaxGPT, jax_gpt3_tiny,
                                       dict(sep=2), opt="sgd", masked=True,
                                       context_parallel=True)
    ref["gpt_masked_dp2_sep2"] = _jax_step(
        inp, JaxGPT, jax_gpt3_tiny, dict(dp=2, sep=2), opt="sgd",
        masked=True, context_parallel=True)
    ref["segment_fleet"] = _jax_step(inp, JaxGPT, jax_gpt3_tiny, {},
                                     opt="sgd")
    ref["gate"] = _jax_gate(inp)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = _inputs()
    groups = {w: Ranks("segment_parallel", w,
                       tmp_path_factory.mktemp(f"sep{w}"), inp)
              for w in WORLDS}
    groups[8] = Ranks("segment_gate", 8, tmp_path_factory.mktemp("gate"), inp)
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
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=f"{what} {k}")


# -- the ring ------------------------------------------------------------------ #

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", (True, False))
def test_ring_matches_jax_values_and_grads(runs, world, causal):
    """Each rank's chunk of the output and of dQ, dK, dV (GQA 4 over 2)
    against the JAX ring on a mesh of the same sep; n - 1 hops forward, n
    backward (the dK/dV accumulators' last hop to their owner)."""
    want = runs["jax"][f"ring_{world}_{causal}"]
    L = want["out"].shape[1] // world
    for rank, r in enumerate(_case(runs, world, f"ring_causal_{causal}")):
        mine = slice(rank * L, (rank + 1) * L)
        np.testing.assert_allclose(r["out"], want["out"][:, mine], **RING_TOL)
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(r[g], want[g][:, mine],
                                       **RING_GRAD_TOL, err_msg=g)
        assert r["hops"]["hops"] == 2 * world - 1


def test_ring_of_one_makes_no_hop_and_is_dense_attention():
    """A ring of one (no group) sends nothing and gives the dense causal
    attention's values and gradients."""
    from paddle_tpu_torch.nn.functional.flash_attention import _ref_attention
    from paddle_tpu_torch.parallel import ring

    rng = np.random.default_rng(6)
    arrs = [rng.normal(size=(1, 8, h, 8)).astype(np.float32) for h in (4, 2, 2)]
    ours = [torch.tensor(a, requires_grad=True) for a in arrs]
    dense = [torch.tensor(a, requires_grad=True) for a in arrs]
    ring.RING_CALLS.clear()
    out = ring.ring_attention(*ours, None, causal=True)
    ref = _ref_attention(*dense, causal=True)
    torch.testing.assert_close(out, ref, **RING_TOL)
    out.sum().backward()
    ref.sum().backward()
    for a, b in zip(ours, dense):
        torch.testing.assert_close(a.grad, b.grad, **RING_GRAD_TOL)
    assert ring.RING_CALLS == {}


def test_ring_flash_attention_without_a_mesh_is_the_references():
    """nn.functional.ring_flash_attention with no global mesh: the dense
    attention, as the JAX package's fallback (:353-359)."""
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.nn import functional as F

    assert env.get_global_mesh() is None
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 8, 2, 4)).astype(np.float32)
               for _ in range(3))
    want = JF.ring_flash_attention(_jt(q), _jt(k), _jt(v), causal=True)
    got = F.ring_flash_attention(*map(torch.tensor, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **RING_TOL)


# -- the context-parallel steps -------------------------------------------------- #

@pytest.mark.parametrize("name,world", [("gpt_dp2_sep2", 4), ("llama_sep4", 4),
                                        ("gpt_dp2_sep2_specs", 4)])
def test_context_parallel_step_matches_jax(runs, name, world):
    """3 AdamW steps (lr 1e-4) with the sequence cut over sep: every rank's
    losses and every gathered parameter against the JAX step on the same
    mesh; the ring hopped. With input_specs / label_specs that cut the
    rows over dp and leave the sequence whole, the step still cuts the
    sequence over sep."""
    losses, params = runs["jax"][name.replace("_specs", "")]
    for rank, r in enumerate(_case(runs, world, name)):
        np.testing.assert_allclose(r["losses"], losses, **STEP_TOL,
                                   err_msg=f"{name} rank {rank}")
        _close_params(r["params"], params, ADAM_PARAM_TOL,
                      f"{name} rank {rank}")
        assert r["hops"]["hops"] > 0
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name,world", [("gpt_masked_sep2", 2),
                                        ("gpt_masked_dp2_sep2", 4)])
def test_masked_loss_over_sep_chunks_is_the_global_mean(runs, name, world):
    """A loss_mask that keeps unequal counts in each sep chunk (a chunk
    that keeps none among them) under SGD 0.5: losses and parameters over
    3 steps are the JAX step's, whose loss is the masked mean over the
    global batch."""
    losses, params = runs["jax"][name]
    for rank, r in enumerate(_case(runs, world, name)):
        np.testing.assert_allclose(r["losses"], losses, **STEP_TOL,
                                   err_msg=f"{name} rank {rank}")
        _close_params(r["params"], params, PARAM_TOL, f"{name} rank {rank}")


@pytest.mark.parametrize("name,world,mode,wrapped", [
    ("segment_fleet", 2, "segment_parallel", "SegmentParallel"),
    ("segment_fleet", 4, "segment_parallel", "SegmentParallel"),
    ("tensor_fleet_sep2_mp2", 4, "tensor_parallel", "TensorParallel")])
def test_fleet_segment_parallel_eager_loop(runs, name, world, mode, wrapped):
    """fleet.init(dp world / 2, sep 2): distributed_model gives
    SegmentParallel over the (dp, sep) group; at sep 2 x mp 2 the
    tensor_parallel mode's TensorParallel averages over (dp, sharding,
    sep). 3 eager SGD steps, each rank on its rows and its chunk of the
    sequence, against the JAX step on the whole batch on one device."""
    _, params = runs["jax"]["segment_fleet"]
    for rank, r in enumerate(_case(runs, world, name)):
        assert (r["mode"], r["wrapped"]) == (mode, wrapped)
        assert len(r["group"]) == world // (2 if mode == "tensor_parallel"
                                            else 1)
        _close_params(r["params"], params, PARAM_TOL, f"rank {rank}")


# -- the gate ------------------------------------------------------------------ #

def test_dryrun_multichip_config_b_at_8_ranks(runs):
    """dp 2 x sep 2 x mp 2, sequence_parallel and context_parallel, stage
    0: every rank's loss within the gate's rtol of the JAX single-device
    baseline and of the JAX step at the same mesh."""
    want = runs["jax"]["gate"]
    for r in _case(runs, 8, "loss"):
        np.testing.assert_allclose(r, want["baseline"], rtol=GATE_RTOL)
        np.testing.assert_allclose(r, want["mesh"], rtol=GATE_RTOL)
