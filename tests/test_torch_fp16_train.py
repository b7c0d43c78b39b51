"""float16 mixed precision in the port held against the JAX package on
`gpt3_tiny` and `llama_tiny` with (2, 16) token batches, the weights carried
across by `load_paddle_tpu_state`, three eager steps each:

- `amp.decorate(level="O2", dtype="float16")` alone (fp16 parameters,
  LayerNorm in f32, the ops computing in the parameters' type) with AdamW
  and `amp.GradScaler(init_loss_scaling=1024)`, against the JAX package's
  same eager loop;
- the port's eager loop under `auto_cast(level="O2", dtype="float16")`
  over f32 parameters with a GradScaler at 2^16, against the JAX package's
  `TrainStep(amp_level="O2", amp_dtype="float16")`, which takes no scaler:
  a power-of-two scale is exact to apply and to remove barring overflow,
  so the scaler changes nothing there;
- the JAX package's own eager loop under `auto_cast(level="O2")` fails in
  its backward (ROADMAP queue C), where the port's computes.

Also fp16 through the engines (paged and dense, `generate`) and the MoE
layer on the CPU. The JAX side runs its Pallas kernels in interpret mode."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt3_tiny as jax_gpt3_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertFFN,
                                                              MoELayer)
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     LlamaForCausalLM, gpt3_tiny, llama_tiny)
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
STEPS = 3
MODELS = {
    "gpt3_tiny": (lambda: JaxGPT(jax_gpt3_tiny()),
                  lambda: GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)),
    "llama_tiny": (lambda: JaxLlama(jax_llama_tiny()),
                   lambda: LlamaForCausalLM(llama_tiny(), device="cpu",
                                            seed=1)),
}
# Parameters whose gradient is analytically zero (a per-row constant added
# to every logit leaves the softmax unchanged): both packages move them by
# rounding noise, which Adam scales up to lr a step.
NOISE_ONLY = "self_attn.k_proj.bias"


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 1024, (2, 16)).astype(np.int64),
            rng.integers(0, 1024, (2, 16)).astype(np.int64))


def _pair(name):
    """(the JAX model, its initial state as numpy, the port model holding
    the same weights)."""
    paddle.seed(0)
    jm = MODELS[name][0]()
    init = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = MODELS[name][1]()
    load_paddle_tpu_state(tm, init)
    return jm, init, tm


def _jax_eager(jm, opt, scaler, ids, labels):
    crit = JaxCriterion()
    losses = []
    for _ in range(STEPS):
        loss = crit(jm(paddle.to_tensor(ids)), paddle.to_tensor(labels))
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _port_eager(tm, opt, scaler, ids, labels, level=None):
    crit = GPTPretrainingCriterion()
    losses = []
    for _ in range(STEPS):
        with amp.auto_cast(enable=level is not None, level=level or "O1",
                           dtype="float16"):
            loss = crit(tm(torch.from_numpy(ids)), torch.from_numpy(labels))
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


def _assert_updates_match(tm, init, want, per_tensor, total):
    """Each tensor's update (the final weights less the initial ones, both
    at the port's dtype) is within `per_tensor` of the JAX update's norm,
    and all of them together within `total` of their summed squares."""
    diff2 = ref2 = 0.0
    for k, v in tm.state_dict().items():
        base = torch.tensor(np.asarray(init[k], np.float32)).to(v.dtype).float()
        got = v.float() - base
        ref = torch.tensor(np.asarray(want[k], np.float32)) - base
        if NOISE_ONLY in k:
            assert (got - ref).abs().max() <= 2 * LR * STEPS, k
            continue
        assert (got - ref).norm() <= per_tensor * ref.norm(), k
        diff2 += float((got - ref).square().sum())
        ref2 += float(ref.square().sum())
    assert diff2 <= total * ref2


@pytest.mark.parametrize("name", list(MODELS))
def test_decorate_fp16_eager_with_scaler_matches_jax(name):
    """fp16 parameters (LayerNorm kept f32, as the reference keeps it; the
    dtypes held equal name by name), AdamW on them, a
    GradScaler at 1024: both packages compute each op in fp16 and round at
    other places, so the losses (~7) agree to a few fp16 ulps of a logit
    (2^-11 relative), and the updates of fp16 parameters by lr-sized Adam
    steps are held as wholes: an element whose gradient is near zero may
    step the other way in one package. fp16's grid is 8 times finer than
    bf16's, whose run (test_torch_train.py) is held at 30% a tensor and 1%
    overall; fp16 is held at 10% and 0.1%."""
    ids, labels = _batch()
    jm, init, tm = _pair(name)
    jamp.decorate(jm, level="O2", dtype="float16")
    amp.decorate(tm, level="O2", dtype="float16")
    for (k, p), (jk, jp) in zip(tm.named_parameters(), jm.named_parameters()):
        assert k == jk and str(p.dtype).split(".")[-1] == str(jp.dtype), k
    jscaler = jamp.GradScaler(init_loss_scaling=1024)
    jl = _jax_eager(jm, jopt.AdamW(learning_rate=LR,
                                   parameters=jm.parameters()),
                    jscaler, ids, labels)
    tscaler = amp.GradScaler(init_loss_scaling=1024)
    tl = _port_eager(tm, AdamW(learning_rate=LR, parameters=tm.parameters()),
                     tscaler, ids, labels)
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    assert tl[-1] < tl[0]
    assert tscaler._scale == jscaler._scale == 1024
    assert torch.float16 in {p.dtype for p in tm.parameters()}
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    _assert_updates_match(tm, init, want, per_tensor=0.1, total=1e-3)


@pytest.mark.parametrize("name", list(MODELS))
def test_auto_cast_o2_fp16_eager_matches_jax_train_step(name):
    """f32 parameters, every op's inputs cast to fp16 (O2), f32 AdamW on
    the f32 gradients: the port's eager loop with a GradScaler at 2^16
    against the JAX package's compiled O2 fp16 step. The losses agree to a
    few fp16 ulps; the f32 parameters, moved by lr-sized steps from
    gradients computed in fp16, to 10% of each tensor's update and 0.1%
    overall."""
    ids, labels = _batch()
    jm, init, tm = _pair(name)
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb),
                         jopt.AdamW(learning_rate=LR,
                                    parameters=jm.parameters()),
                         amp_level="O2", amp_dtype="float16")
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)))
          for _ in range(STEPS)]
    jstep.sync_weights()
    scaler = amp.GradScaler()
    tl = _port_eager(tm, AdamW(learning_rate=LR, parameters=tm.parameters()),
                     scaler, ids, labels, level="O2")
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    assert scaler._scale == 2.0 ** 16 and not scaler._found_inf
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    _assert_updates_match(tm, init, want, per_tensor=0.1, total=1e-3)


def test_reference_eager_auto_cast_o2_fails_in_backward():
    """A reference fault (ROADMAP queue C): the JAX package's eager loop
    under auto_cast(level="O2") fails in backward(), an f32 cotangent
    where its tape holds an fp16 value (paddle_tpu/framework/core.py:873);
    the port's same loop computes."""
    ids, labels = _batch()
    jm, _, tm = _pair("gpt3_tiny")
    with jamp.auto_cast(level="O2", dtype="float16"):
        loss = JaxCriterion()(jm(paddle.to_tensor(ids)),
                              paddle.to_tensor(labels))
    with pytest.raises(ValueError, match="unexpected JAX type"):
        loss.backward()
    with amp.auto_cast(level="O2", dtype="float16"):
        tloss = GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                          torch.from_numpy(labels))
    tloss.backward()
    assert np.isfinite(tloss.item())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tm.parameters())


@pytest.mark.parametrize("name", list(MODELS))
def test_fp16_models_serve_through_every_engine(name):
    """An fp16 model served by the paged and the dense engine and by
    `generate`: the KV cache takes the model's dtype, and the greedy
    tokens of all three agree (the same fp16 kernels' plain versions)."""
    _, _, tm = _pair(name)
    tm = tm.to(torch.float16)
    prompt = np.arange(1, 12)
    tokens = []
    for paged in (True, False):
        kw = dict(page_size=16) if paged else {}
        eng = create_serving_engine(tm, max_batch_size=4, max_seq_len=64,
                                    paged=paged, **kw)
        eng.add_request(prompt, max_new_tokens=6)
        tokens.append([r.generated for r in eng.run()][0])
        if paged:
            assert eng.pool.kv[0][0].dtype == torch.float16
        else:
            assert eng.kv_dtype == torch.float16
    gen = tm.generate(torch.from_numpy(prompt)[None], max_new_tokens=6,
                      temperature=0.0)
    tokens.append(gen[0, len(prompt):].tolist())
    assert tokens[0] == tokens[1] == tokens[2], tokens


def test_fp16_moe_fast_path_matches_its_dense_oracle():
    """The MoE layer in fp16: the sorted fast path (two grouped GEMMs, the
    fp16 kernel's plain version on the CPU) against the layer's einsum
    oracle on the same fp16 weights, values and gradients, to a few fp16
    ulps of the largest value (the two sum in other orders)."""
    torch.manual_seed(0)
    E, M, H = 4, 32, 64
    layer = MoELayer(M, ExpertFFN(E, M, H, device="cpu"),
                     gate={"type": "gshard", "top_k": 2,
                           "random_routing": False}, device="cpu")
    layer = layer.to(torch.float16)
    x = torch.randn(48, M).to(torch.float16)
    outs = []
    for fn in (layer, layer._forward_dense):
        xi = x.clone().requires_grad_()
        y = fn(xi)
        y.float().square().sum().backward()
        outs.append((y.detach().float(), xi.grad.float()))
    for got, want in zip(*outs):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=8 * 2 ** -11 * want.abs().max().item())
