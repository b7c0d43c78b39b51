"""The port's GPT-3 training step held against the JAX package's on
`gpt3_tiny` with (2, 16) token batches, the weights carried across by
`load_paddle_tpu_state`: logits, loss and every parameter gradient; a
5-step AdamW trajectory and the parameters after it (`jit.TrainStep` in
both packages); a 3-step bf16 O2 run with bf16 moments and per-layer
recompute; resuming from the JAX optimizer state after step 2. Also the
port's own rules: recompute changes no gradient, the single-device
`DistributedTrainStep` is `TrainStep`, stage 3 and offload on a 1-rank
group are stage 0, the decode kernels refuse gradients, and the unported
modes raise. The JAX side runs its Pallas
kernels in interpret mode."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt3_tiny as jax_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import (load_paddle_tpu_opt_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch.distributed import DistributedTrainStep
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt3_tiny)
from paddle_tpu_torch.ops import decode_attention as port_da
from paddle_tpu_torch.ops import flash_attention as port_fa
from paddle_tpu_torch.ops import fused_norm as port_norm
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
STEPS = 5
# f32 on both sides: matmuls, norms and softmaxes sum in other orders, so
# logits of magnitude ~0.3 and losses ~7 agree to a few 1e-6, and AdamW
# steps of size lr move parameters identically up to that rounding.
TOL = dict(rtol=1e-4, atol=1e-5)
# The k-projection biases get an analytically zero gradient (a per-row
# constant added to every logit leaves the softmax unchanged), so both
# packages update them from rounding noise, which Adam scales up to as much
# as lr per step. They are held to |diff| <= lr * steps, the most those
# steps can move them; every other parameter to TOL (absolute 1e-4 for
# parameters moved by lr-sized steps).
NOISE_ONLY = "self_attn.k_proj.bias"


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1024, (2, 16)).astype(np.int64),
            rng.integers(0, 1024, (2, 16)).astype(np.int64))


def _jax_model(**kw):
    paddle.seed(0)
    return JaxGPT(jax_tiny(**kw))


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_model(state, **kw):
    tm = GPTForCausalLM(gpt3_tiny(**kw), device="cpu", seed=1)
    load_paddle_tpu_state(tm, state)
    return tm


def _assert_params_match(tm, want, steps, atol=1e-4):
    for k, v in tm.state_dict().items():
        got = v.float().numpy()
        ref = np.asarray(want[k], np.float32)
        if NOISE_ONLY in k:
            assert np.abs(got - ref).max() <= LR * steps, k
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol,
                                       err_msg=k)


def test_logits_loss_and_every_gradient_match_jax():
    jm = _jax_model()
    tm = _port_model(_state(jm))
    ids, labels = _batch()
    jlogits = jm(paddle.to_tensor(ids))
    jloss = JaxCriterion()(jlogits, paddle.to_tensor(labels))
    jloss.backward()
    tlogits = tm(torch.from_numpy(ids))
    tloss = GPTPretrainingCriterion()(tlogits, torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits.numpy(), **TOL)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    jgrads = {k: p.grad.numpy() for k, p in jm.named_parameters()}
    tgrads = {k: p.grad for k, p in tm.named_parameters()}
    assert set(jgrads) == set(tgrads)
    for k, g in tgrads.items():
        assert g is not None, f"{k} has no gradient"
        scale = max(1.0, float(np.abs(jgrads[k]).max()))
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
    assert port_fa.FWD_LAUNCHES == port_norm.DX_LAUNCHES == 0


def test_recompute_gives_identical_gradients():
    state = _state(_jax_model())
    ids, labels = _batch(1)
    grads = []
    for rc in (False, True):
        tm = _port_model(state, use_recompute=rc)
        GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                  torch.from_numpy(labels)).backward()
        grads.append({k: p.grad.clone() for k, p in tm.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def jax_run():
    """Five JAX TrainStep steps of f32 AdamW(lr 1e-3, weight decay 0.01),
    with the parameters and optimizer state after step 2 kept for the
    resume test. The Pallas kernels run in interpret mode, as the conftest
    fixture sets it up for a single test."""
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    init = _state(jm)
    crit = JaxCriterion()
    step = JaxTrainStep(jm, lambda lg, lb: crit(lg, lb),
                        jopt.AdamW(learning_rate=LR, parameters=jm.parameters()))
    ids, labels = _batch()
    losses, mid = [], None
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        for i in range(STEPS):
            losses.append(float(step(paddle.to_tensor(ids),
                                     paddle.to_tensor(labels))))
            if i == 1:
                mid = ({k: np.array(v) for k, v in step.params.items()},
                       {k: {kk: np.array(vv) for kk, vv in st.items()}
                        for k, st in step.opt_states.items()})
    step.sync_weights()
    return dict(init=init, losses=losses, mid=mid, final=_state(jm))


def _port_step(tm, cls=TrainStep, **opt_kw):
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=tm.parameters(), **opt_kw)
    return cls(tm, lambda lg, lb: crit(lg, lb), opt), opt


def test_five_step_adamw_trajectory_matches_jax(jax_run):
    tm = _port_model(jax_run["init"])
    step, _ = _port_step(tm)
    ids, labels = _batch()
    losses = [step(ids, labels) for _ in range(STEPS)]
    assert all(l.dtype == torch.float32 and l.dim() == 0 for l in losses)
    np.testing.assert_allclose([l.item() for l in losses], jax_run["losses"],
                               rtol=1e-4)
    _assert_params_match(tm, jax_run["final"], STEPS)


def test_resume_from_jax_optimizer_state_matches_steps_3_to_5(jax_run):
    params, opt_states = jax_run["mid"]
    tm = _port_model(params)
    step, opt = _port_step(tm)
    load_paddle_tpu_opt_state(opt, opt_states, step=2)
    ids, labels = _batch()
    losses = [step(ids, labels).item() for _ in range(STEPS - 2)]
    np.testing.assert_allclose(losses, jax_run["losses"][2:], rtol=1e-4)
    assert opt._step_count == STEPS
    _assert_params_match(tm, jax_run["final"], STEPS)


def test_bf16_o2_recompute_three_steps_match_jax():
    """The bench recipe at tiny size: amp.decorate O2 (bf16 parameters,
    LayerNorm in f32), AdamW with bf16 moments, per-layer recompute, an O2
    bf16 step."""
    steps = 3
    jm = _jax_model(use_recompute=True)
    init = _state(jm)
    jamp.decorate(jm, level="O2", dtype="bfloat16")
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb),
                         jopt.AdamW(learning_rate=LR, moment_dtype="bfloat16",
                                    parameters=jm.parameters()),
                         amp_level="O2", amp_dtype="bfloat16")
    tm = _port_model(init, use_recompute=True)
    amp.decorate(tm, level="O2", dtype="bfloat16")
    for (k, p), (jk, jp) in zip(tm.named_parameters(), jm.named_parameters()):
        assert k == jk and str(p.dtype).split(".")[-1] == str(jp.dtype), k
    tstep, opt = _port_step(tm, moment_dtype="bfloat16")
    tstep.amp_level = "O2"
    ids, labels = _batch()
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)))
          for _ in range(steps)]
    tl = [tstep(ids, labels).item() for _ in range(steps)]
    # bf16 activations and weights round at other places in the two
    # frameworks: losses of ~7 agree to a few 1e-4 (one bf16 ulp of a
    # logit is 2^-9 relative)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    jstep.sync_weights()
    want = _state(jm)
    st = next(iter(tstep.opt_states.values()))
    assert st["m"].dtype == st["v"].dtype == torch.bfloat16
    diff2 = ref2 = 0.0
    for k, v in tm.state_dict().items():
        if NOISE_ONLY in k:
            continue
        # bf16 parameters updated by lr-sized Adam steps from bf16
        # gradients: an element whose gradient sits near zero may step the
        # other way in one package, so the updates are held as wholes, not
        # per element: each tensor's update is within 30% of JAX's (a bias
        # of 64 elements moves by a few flipped elements) and all of them
        # together within 10%
        base = torch.tensor(np.asarray(init[k], np.float32)).to(v.dtype).float()
        got = v.float() - base
        ref = torch.tensor(np.asarray(want[k], np.float32)) - base
        assert (got - ref).norm() <= 0.3 * ref.norm(), k
        diff2 += float((got - ref).square().sum())
        ref2 += float(ref.square().sum())
    assert diff2 <= 0.01 * ref2


def test_distributed_train_step_without_a_mesh_is_train_step():
    state = _state(_jax_model())
    ids, labels = _batch(2)
    runs = []
    for cls in (TrainStep, DistributedTrainStep):
        tm = _port_model(state)
        step, _ = _port_step(tm, cls)
        runs.append(([step(ids, labels).item() for _ in range(2)],
                     {k: v.clone() for k, v in tm.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        torch.testing.assert_close(runs[1][1][k], runs[0][1][k], rtol=0, atol=0)
    # on one device sharding stage 2 is the stage-0 step (the reference's
    # sharding axis has size 1)
    tm = _port_model(state)
    step, _ = _port_step(tm, lambda *a: DistributedTrainStep(
        *a, sharding_stage=2))
    assert [step(ids, labels).item() for _ in range(2)] == runs[0][0]
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, runs[0][1][k], rtol=0, atol=0)
    # stage 3 and offload shard over a mesh, and a mesh needs the process
    # group: without init_parallel_env both raise, saying so
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        _port_step(_port_model(state), lambda *a: DistributedTrainStep(
            *a, sharding_stage=3))
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        pdist.build_mesh(sharding=2)


def test_stage3_and_offload_on_one_rank_equal_stage0(tmp_path):
    """On a 1-rank gloo group, stage 3 (gpt3_tiny's tied head gathered once
    for both uses, every layer gathered again in its recomputed forward)
    and stage 2 and 3 with offload follow the stage-0 step bit for bit:
    the gathers and reduce-scatters over a group of one change nothing."""
    state = _state(_jax_model())
    ids, labels = _batch(2)
    pdist.init_parallel_env(device="cpu", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = pdist.build_mesh(sharding=1)
        runs = {}
        for kw in (dict(sharding_stage=0), dict(sharding_stage=3),
                   dict(sharding_stage=2, offload=True),
                   dict(sharding_stage=3, offload=True)):
            tm = _port_model(state, use_recompute=True)
            step, opt = _port_step(tm, lambda *a: DistributedTrainStep(
                *a, mesh=mesh, **kw))
            losses = [step(ids, labels).item() for _ in range(2)]
            runs[tuple(kw.items())] = (losses, pdist.full_state_dict(tm))
            if kw.get("offload"):
                assert all(v.device.type == "cpu" for st in opt._states.values()
                           for v in st.values())
    finally:
        pdist.destroy_process_group()
    (ref_l, ref_p), *others = runs.values()
    for losses, params in others:
        assert losses == ref_l
        for k in ref_p:
            torch.testing.assert_close(params[k], ref_p[k], rtol=0, atol=0,
                                       msg=k)


def test_eager_optimizer_step_equals_train_step():
    """loss.backward(); opt.step(); opt.clear_grad() runs the same rule as
    TrainStep, which shares the optimizer's state and step count."""
    state = _state(_jax_model())
    ids, labels = _batch(3)
    tm = _port_model(state)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=tm.parameters())
    for _ in range(2):
        crit(tm(torch.from_numpy(ids)), torch.from_numpy(labels)).backward()
        opt.step()
        opt.clear_grad()
    ref = _port_model(state)
    step, ref_opt = _port_step(ref)
    for _ in range(2):
        step(ids, labels)
    assert opt._step_count == ref_opt._step_count == 2
    for (k, a), b in zip(tm.state_dict().items(), ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_decode_wrappers_raise_under_grad():
    q = torch.randn(1, 2, 8, requires_grad=True)
    kc = torch.randn(2, 2, 4, 8)
    tables = torch.tensor([[1]], dtype=torch.int32)
    lengths = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        port_da.paged_decode_attention(q, kc, kc, tables, lengths)
    with pytest.raises(RuntimeError, match="no gradient"):
        port_da.paged_kv_write(kc, q, tables, lengths)
    with torch.no_grad():
        out = port_da.paged_decode_attention(q, kc, kc, tables, lengths)
        port_da.paged_kv_write(kc, q, tables, lengths)
    assert out.shape == q.shape


def test_unported_training_modes_raise():
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as TF

    params = [torch.nn.Parameter(torch.zeros(2))]
    clip = ClipGradByGlobalNorm(1.0)
    opt = AdamW(parameters=params, grad_clip=clip)
    assert opt._grad_clip is clip
    (_, g), = clip([(params[0], torch.tensor([3.0, 4.0]))])
    torch.testing.assert_close(g, torch.tensor([0.6, 0.8]))
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        AdamW(learning_rate=lambda: 1.0, parameters=params)
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        TF.cross_entropy(torch.zeros(2, 3), torch.zeros(2, 3), soft_label=True)
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        GPTForCausalLM(gpt3_tiny(attention_dropout_prob=0.1), device="cpu")
