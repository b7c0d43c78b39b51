"""The port's LLaMA form (paddle_tpu_torch.models.llama: RMSNorm, SwiGLU,
RoPE, GQA, an untied head, flash or flashmask attention) held against the
JAX package's on `llama_tiny` (2 layers, hidden 64, 4 query heads over 2
kv heads, vocab 1024) with the weights carried across by
`load_paddle_tpu_state`: logits, loss and every gradient with both
attention variants and with a document mask; a 5-step AdamW trajectory;
bench.py's LLaMA recipe (AMP O2 over f32 parameters, sharding stage 2 on
one device) for 3 steps; incubate `swiglu`, `fused_rms_norm` and
`fused_layer_norm`; greedy tokens of the paged engine (prefix sharing on,
and under preemption), the dense engine and `generate` with and without a
cache. The JAX side runs its Pallas kernels in interpret mode. Also the
port's own rules: state_dict names equal the reference's, sharding stage 2
on one device is the stage-0 step bit for bit, and a document mask is
refused together with KV caches."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.optimizer as jopt
import jax
from paddle_tpu.incubate.nn import functional as jax_inc
from paddle_tpu.inference.paged import PagedServingEngine as JaxPagedEngine
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JaxDense
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import DistributedTrainStep
from paddle_tpu_torch.incubate.nn import functional as port_inc
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTPretrainingCriterion, LlamaForCausalLM,
                                     llama_tiny)
from paddle_tpu_torch.ops import fused_rope as port_rope
from paddle_tpu_torch.ops import masked_flash as port_mf
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
STEPS = 5
MAX_NEW = 6
PS = 8  # page size: 14-token prompts span two pages


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1024, (2, 16)).astype(np.int64),
            rng.integers(0, 1024, (2, 16)).astype(np.int64))


def _doc_index():
    """A causal n = 1 document mask [2, 1, 16, 1]: row 0 splits its 16
    tokens 5 / 11, row 1 is 9 / 7."""
    idx = np.empty((2, 1, 16, 1), np.int32)
    for b, cut in enumerate((5, 9)):
        idx[b, 0, :, 0] = np.where(np.arange(16) < cut, cut, 16)
    return idx


def _jax_model(**kw):
    paddle.seed(0)
    return JaxLlama(jax_llama_tiny(**kw))


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_model(state, **kw):
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu", seed=1)
    load_paddle_tpu_state(tm, state)
    return tm


@pytest.fixture(scope="module")
def state():
    return _state(_jax_model())


def test_state_dict_names_and_sizes_equal_the_reference(state):
    """load_paddle_tpu_state moves LLaMA weights with no renaming: the same
    names (untied lm_head, RMSNorm weights only, no biases, no position
    table, gate/up/down projections) and shapes; the configs count the
    same parameters."""
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    own = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert own == {k: v.shape for k, v in state.items()}
    assert "lm_head.weight" in own and own["lm_head.weight"] == (64, 1024)
    assert own["gpt.layers.0.self_attn.k_proj.weight"] == (64, 32)  # 2 kv heads
    assert not any(k.endswith(".bias") or "embed_positions" in k for k in own)
    for kw in (dict(), dict(include_embeddings=False)):
        assert llama_tiny().num_params(**kw) == \
            jax_llama_tiny().num_params(**kw)
    assert sum(v.numel() for v in tm.state_dict().values()) == \
        llama_tiny().num_params()
    load_paddle_tpu_state(tm, state)
    torch.testing.assert_close(tm.lm_head.weight,
                               torch.tensor(state["lm_head.weight"]))


# name: (attn_variant, document mask)
FORWARDS = {"flash": ("flash", False), "flashmask": ("flashmask", False),
            "flashmask_docs": ("flashmask", True)}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_logits_loss_and_every_gradient_match_jax(name, state):
    av, docs = FORWARDS[name]
    jm = JaxLlama(jax_llama_tiny(attn_variant=av))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tm = _port_model(state, attn_variant=av)
    ids, labels = _batch()
    idx = _doc_index() if docs else None
    jlogits = jm(paddle.to_tensor(ids), attn_startend_row_indices=None
                 if idx is None else paddle.to_tensor(idx))
    jloss = JaxCriterion()(jlogits, paddle.to_tensor(labels))
    jloss.backward()
    tlogits = tm(torch.from_numpy(ids), attn_startend_row_indices=None
                 if idx is None else torch.from_numpy(idx))
    tloss = GPTPretrainingCriterion()(tlogits, torch.from_numpy(labels))
    tloss.backward()
    # f32 on both sides: logits of magnitude ~0.5 summed in other orders
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jgrads = {k: p.grad.numpy() for k, p in jm.named_parameters()}
    tgrads = {k: p.grad for k, p in tm.named_parameters()}
    assert set(jgrads) == set(tgrads)
    for k, g in tgrads.items():
        assert g is not None, f"{k} has no gradient"
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=0,
                                   atol=1e-4 * np.abs(jgrads[k]).max(),
                                   err_msg=k)
    if docs:  # the mask reaches the attention: the logits differ without it
        plain = tm(torch.from_numpy(ids)).detach()
        assert (plain - tlogits.detach()).abs().max() > 1e-3
    assert port_mf.FWD_LAUNCHES == port_rope.LAUNCHES == 0


@pytest.fixture(scope="module")
def jax_run(state):
    """Five JAX TrainStep steps of f32 AdamW on llama_tiny with flashmask
    attention (the Pallas kernels in interpret mode)."""
    jm = _jax_model(attn_variant="flashmask")
    crit = JaxCriterion()
    step = JaxTrainStep(jm, lambda lg, lb: crit(lg, lb),
                        jopt.AdamW(learning_rate=LR, parameters=jm.parameters()))
    ids, labels = _batch()
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        losses = [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels)))
                  for _ in range(STEPS)]
    step.sync_weights()
    return dict(losses=losses, final=_state(jm))


def _port_step(tm, cls=TrainStep, **kw):
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=tm.parameters())
    return cls(tm, lambda lg, lb: crit(lg, lb), opt, **kw)


def test_five_step_adamw_trajectory_matches_jax(state, jax_run):
    """f32: losses and parameters after five lr-sized Adam steps agree to
    rounding (1e-5)."""
    tm = _port_model(state, attn_variant="flashmask")
    step = _port_step(tm)
    ids, labels = _batch()
    losses = [step(ids, labels).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jax_run["final"][k], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_bench_recipe_o2_over_f32_parameters_matches_jax(state):
    """bench.py's LLaMA rung at tiny size: f32 parameters (no decorate),
    f32 AdamW moments, AMP O2 bf16 and sharding stage 2 on one device, in
    both packages. Every op casts its inputs as the JAX interceptor does
    (bf16, the black list in f32), so the bf16 losses and the f32 updates
    agree to bf16 rounding placed differently by the two frameworks."""
    steps = 3
    jm = _jax_model(attn_variant="flashmask")
    jcrit = JaxCriterion()
    jstep = jdist.DistributedTrainStep(
        jm, lambda lg, lb: jcrit(lg, lb),
        jopt.AdamW(learning_rate=LR, parameters=jm.parameters()),
        mesh=jdist.build_mesh(devices=jax.devices()[:1]), sharding_stage=2,
        amp_level="O2", amp_dtype="bfloat16")
    tm = _port_model(state, attn_variant="flashmask")
    tstep = _port_step(tm, DistributedTrainStep, sharding_stage=2,
                       amp_level="O2", amp_dtype="bfloat16")
    ids, labels = _batch()
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)))
          for _ in range(steps)]
    tl = [tstep(ids, labels).item() for _ in range(steps)]
    # a loss of ~7 from bf16 logits: one bf16 ulp of a logit is 2^-9
    # relative, and the rounding points differ, so a few 1e-4
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    jstep.sync_weights()
    want = _state(jm)
    diff2 = ref2 = 0.0
    for k, v in tm.state_dict().items():
        assert v.dtype == torch.float32, k  # O2 keeps f32 parameters
        base = torch.tensor(state[k])
        got, ref = v - base, torch.from_numpy(want[k]) - base
        # lr-sized Adam steps from bf16-computed gradients: an element whose
        # gradient sits near zero may step the other way, so each tensor's
        # update is held as a whole (within 30% of JAX's) and all of them
        # together within 10%
        assert (got - ref).norm() <= 0.3 * ref.norm(), k
        diff2 += float((got - ref).square().sum())
        ref2 += float(ref.square().sum())
    assert diff2 <= 0.01 * ref2


def test_sharding_stage_2_on_one_device_is_stage_0_bit_for_bit(state):
    ids, labels = _batch(2)
    runs = []
    for stage in (0, 1, 2):
        tm = _port_model(state, attn_variant="flashmask")
        step = _port_step(tm, DistributedTrainStep, sharding_stage=stage,
                          mesh=np.empty((1,)))
        runs.append(([step(ids, labels).item() for _ in range(2)],
                     {k: v.clone() for k, v in tm.state_dict().items()}))
    for losses, params in runs[1:]:
        assert losses == runs[0][0]
        for k in params:
            torch.testing.assert_close(params[k], runs[0][1][k], rtol=0, atol=0)


def test_swiglu_and_fused_norms_match_jax():
    """incubate swiglu (both forms), fused_rms_norm and fused_layer_norm with
    a norm bias, a pre-norm bias and a residual (the JAX norms run their
    Pallas kernels): f32 values to 1e-5, the residual output exactly."""
    rng = np.random.default_rng(4)
    x, y, r = (rng.standard_normal((2, 10, 64)).astype(np.float32)
               for _ in range(3))
    w, nb, b = (rng.standard_normal(64).astype(np.float32) for _ in range(3))
    J, T = paddle.to_tensor, torch.from_numpy
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port_inc.swiglu(T(x), T(y)).numpy(),
                               jax_inc.swiglu(J(x), J(y)).numpy(), **tol)
    np.testing.assert_allclose(port_inc.swiglu(T(x)).numpy(),
                               jax_inc.swiglu(J(x)).numpy(), **tol)
    for name, kw in (("fused_rms_norm", {}),
                     ("fused_layer_norm", dict(residual_alpha=0.5))):
        for extra in (dict(), dict(norm_bias=nb, bias=b, residual=r)):
            got = getattr(port_inc, name)(
                T(x), T(w), **{k: T(v) for k, v in extra.items()}, **kw)
            want = getattr(jax_inc, name)(
                J(x), J(w), **{k: J(v) for k, v in extra.items()}, **kw)
            np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **tol,
                                       err_msg=f"{name} {sorted(extra)}")
            np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    # over the last two axes: the composite in both packages
    got, _ = port_inc.fused_rms_norm(T(x), T(np.ones((10, 64), np.float32)),
                                     begin_norm_axis=1)
    want, _ = jax_inc.fused_rms_norm(J(x), J(np.ones((10, 64), np.float32)),
                                     begin_norm_axis=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


# --------------------------------------------------------------------------- #
# serving: the paged engine, the dense engine and generate
# --------------------------------------------------------------------------- #


def _prompts():
    """Four 14-token prompts; 0 and 2 share their first page (8 tokens)."""
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 1000, PS).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, 1000, 6).astype(np.int32)])
            if i % 2 == 0 else rng.integers(1, 1000, 14).astype(np.int32)
            for i in range(4)]


def _staggered():
    return [(np.arange(2 + i, dtype=np.int32) + 3, 4 + i % 3)
            for i in range(6)]


def _gen_ids():
    return np.random.RandomState(0).randint(1, 1000, (2, 8)).astype(np.int32)


def _drive(eng, reqs, priorities=None):
    ids = [eng.add_request(p, max_new_tokens=n, temperature=0.0,
                           priority=0 if priorities is None else priorities[i])
           for i, (p, n) in enumerate(reqs)]
    by = {r.req_id: r for r in eng.run()}
    return [by[i].generated for i in ids]


@pytest.fixture(scope="module")
def jax_serving(state):
    """Greedy tokens of the JAX paged engine, dense engine and cached
    `generate` on llama_tiny (RoPE at each row's own positions, K cached
    after the rotation)."""
    jm = _jax_model()
    jm.eval()
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        paged = _drive(JaxPagedEngine(jm, max_batch_size=4, max_seq_len=64,
                                      page_size=PS, seed=3),
                       [(p, MAX_NEW) for p in _prompts()])
        dense = _drive(JaxDense(jm, max_batch_size=4, max_seq_len=64),
                       _staggered())
        gen = jm.generate(_gen_ids(), max_new_tokens=6,
                          temperature=0.0).numpy()
    return dict(paged=paged, dense=dense, generate=gen)


ENGINES = {
    "sharing_on": dict(),
    # 4 prompts x 2 pages admit into 9 usable pages; growing past 16 tokens
    # wants 4 more pages, so decode must spill requests and resume them
    # (their pages come back from the host, already rotated)
    "preempting_pool": dict(num_pages=10, watermark_pages=0,
                            prefix_sharing=False),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_paged_engine_greedy_tokens_match_jax(state, jax_serving, name):
    tm = _port_model(state)
    eng = create_serving_engine(tm, max_batch_size=4, max_seq_len=64,
                                page_size=PS, seed=3, **ENGINES[name])
    got = _drive(eng, [(p, MAX_NEW) for p in _prompts()],
                 priorities=[0, -1, -2, -3])
    assert got == jax_serving["paged"]
    m = eng.metrics
    if name == "sharing_on":
        assert m["prefix_hits"].value() > 0  # a page of rotated K reused
    else:
        assert m["preemptions"].value() > 0 and m["resumes"].value() > 0


def test_dense_engine_matches_jax_under_staggered_admission(state, jax_serving):
    tm = _port_model(state)
    eng = create_serving_engine(tm, paged=False, max_batch_size=4,
                                max_seq_len=64)
    assert _drive(eng, _staggered()) == jax_serving["dense"]


@pytest.mark.parametrize("use_cache", [True, False])
def test_generate_matches_jax(state, jax_serving, use_cache):
    tm = _port_model(state)
    got = tm.generate(_gen_ids(), max_new_tokens=6, temperature=0.0,
                      use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), jax_serving["generate"])


def test_document_mask_with_caches_raises(state):
    tm = _port_model(state, attn_variant="flashmask")
    caches = tm.init_kv_caches(2, 16)
    with pytest.raises(ValueError, match="document boundaries"):
        tm(torch.zeros(2, 4, dtype=torch.long), None, caches, 0,
           attn_startend_row_indices=torch.from_numpy(_doc_index()))
