"""The port's AdamW/Adam update rule (paddle_tpu_torch.optimizer) held against
the JAX package's `AdamW.update` / `Adam.update` over five steps, for f32
and bf16 moments, with weight decay, and with an f32 master copy of a bf16
parameter; and the port's AMP (paddle_tpu_torch.amp) against the JAX
package's: the O2 parameter dtypes `decorate` leaves, name by name, and the
output dtype of each op class under O1 and O2."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt3_tiny as jax_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt3_tiny)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Adam, AdamW


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _name(dtype):
    return str(dtype).replace("torch.", "").replace("paddle.", "")


# (optimizer, moment dtype, param dtype, master copy)
RULES = {
    "adamw_f32": ("AdamW", None, "float32", False),
    "adamw_bf16_moments": ("AdamW", "bfloat16", "float32", False),
    "adamw_bf16_param_bf16_moments": ("AdamW", "bfloat16", "bfloat16", False),
    "adamw_bf16_param_f32_master": ("AdamW", None, "bfloat16", True),
    "adam_l2_decay": ("Adam", None, "float32", False),
}


@pytest.mark.parametrize("case", list(RULES))
def test_update_rule_matches_jax_over_five_steps(case):
    kind, mdt, pdt, master = RULES[case]
    rng = np.random.default_rng(len(case))
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(5)]
    lr, wd = 1e-2, 0.01
    jcls = getattr(jopt, kind)
    jo = jcls(learning_rate=lr, weight_decay=wd, moment_dtype=mdt)
    tcls = {"AdamW": AdamW, "Adam": Adam}[kind]
    pt = torch.nn.Parameter(torch.from_numpy(p0).to(getattr(torch, pdt)))
    to = tcls(learning_rate=lr, parameters=[pt], weight_decay=wd,
              moment_dtype=mdt, multi_precision=master)

    pj = jnp.asarray(p0).astype(getattr(jnp, pdt))
    state = jo.init_state(pj)
    mj = pj.astype(jnp.float32) if master else None
    for t, g in enumerate(grads, start=1):
        ctx = {"step": t, "weight_decay": wd}
        src = mj if master else pj
        # the gradient arrives in the parameter's dtype, as in a TrainStep
        gj = jnp.asarray(g).astype(pj.dtype).astype(src.dtype)
        new, state = jo.update(src, gj, state, lr, ctx)
        if master:
            mj, pj = new, new.astype(pj.dtype)
        else:
            pj = new
        to.apply_update(pt, torch.from_numpy(g).to(pt.dtype), lr, ctx)

    st = to._states[id(pt)]
    assert str(st["m"].dtype).endswith(_name(state["m"].dtype))
    assert pt.dtype == getattr(torch, pdt)
    # f32 rule on both sides: a few ulps; a bf16 tensor may round to the
    # neighbouring value: one ulp (2^-8 relative)
    tol = dict(rtol=1e-5, atol=1e-6) if pdt == "float32" and mdt is None \
        else dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(_f32(pt.detach()), _f32(pj), **tol)
    np.testing.assert_allclose(_f32(st["m"]), _f32(state["m"]), **tol)
    np.testing.assert_allclose(_f32(st["v"]), _f32(state["v"]), **tol)
    if master:
        np.testing.assert_allclose(_f32(st["master"]), _f32(mj), rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def o2_models():
    """gpt3_tiny in both packages with the same weights, each decorated O2
    to bf16."""
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu")
    load_paddle_tpu_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    jamp.decorate(jm, level="O2", dtype="bfloat16")
    amp.decorate(tm, level="O2", dtype="bfloat16")
    return jm, tm


def test_decorate_o2_parameter_dtypes_match_jax(o2_models):
    jm, tm = o2_models
    want = {k: _name(p.dtype) for k, p in jm.named_parameters()}
    got = {k: _name(p.dtype) for k, p in tm.named_parameters()}
    assert got == want
    assert got["gpt.layers.0.input_layernorm.weight"] == "float32"
    assert got["gpt.layers.0.mlp.fc1.weight"] == "bfloat16"


def _op_dtypes(F, tensor, ctx):
    """Output dtype of each op class under `ctx`, from f32 inputs."""
    rng = np.random.default_rng(0)
    x = tensor(rng.standard_normal((2, 6, 8)).astype(np.float32))
    w = tensor(rng.standard_normal((8, 8)).astype(np.float32))
    b = tensor(np.zeros(8, np.float32))
    q = tensor(rng.standard_normal((2, 6, 2, 4)).astype(np.float32))
    full = tensor(np.tril(np.ones((6, 6), bool))[None, None])
    logits = tensor(rng.standard_normal((2, 6, 8)).astype(np.float32))
    labels = tensor(rng.integers(0, 8, (2, 6)))
    table = tensor(rng.standard_normal((8, 8)).astype(np.float32))
    with ctx:
        out = {
            "linear": F.linear(x, w, b),
            "gelu": F.gelu(x),
            "layer_norm": F.layer_norm(x, 8, b + 1, b),
            "flash_attention": F.scaled_dot_product_attention(q, q, q, is_causal=True),
            "sdpa": F.scaled_dot_product_attention(q, q, q, attn_mask=full),
            "cross_entropy": F.cross_entropy(logits, labels),
            "embedding": F.embedding(labels, table),
        }
    return {k: _name(v.dtype) for k, v in out.items()}


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_op_dtypes_under_auto_cast_match_jax(level):
    want = _op_dtypes(JF, paddle.to_tensor,
                      jamp.auto_cast(level=level, dtype="bfloat16"))
    got = _op_dtypes(TF, torch.from_numpy,
                     amp.auto_cast(level=level, dtype="bfloat16"))
    assert got == want
    assert got["layer_norm"] == got["cross_entropy"] == "float32"
    assert got["linear"] == got["flash_attention"] == got["sdpa"] == "bfloat16"


def test_model_dtypes_under_o2_match_jax(o2_models):
    """Decorated gpt3_tiny under O2: the decoder layer's residual stream,
    the final norm, the logits and the loss."""
    jm, tm = o2_models
    ids = np.random.default_rng(1).integers(0, 1024, (2, 16))
    got, want = {}, {}
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        h = jm.gpt.embed_tokens(paddle.to_tensor(ids))
        want["embedding"] = h.dtype
        want["decoder_layer"] = jm.gpt.layers[0](h).dtype
        want["final_norm"] = jm.gpt.final_norm(h).dtype
        lg = jm(paddle.to_tensor(ids))
        want["logits"] = lg.dtype
        want["loss"] = JaxCriterion()(lg, paddle.to_tensor(ids)).dtype
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        h = tm.gpt.embed_tokens(torch.from_numpy(ids))
        got["embedding"] = h.dtype
        got["decoder_layer"] = tm.gpt.layers[0](h).dtype
        got["final_norm"] = tm.gpt.final_norm(h).dtype
        lg = tm(torch.from_numpy(ids))
        got["logits"] = lg.dtype
        got["loss"] = GPTPretrainingCriterion()(lg, torch.from_numpy(ids)).dtype
    assert {k: _name(v) for k, v in got.items()} == {k: _name(v) for k, v in want.items()}
    assert _name(got["logits"]) == "bfloat16" and _name(got["loss"]) == "float32"


def test_auto_cast_nests_and_restores():
    x = torch.zeros(2, 2)
    with amp.auto_cast(level="O2"):
        with amp.auto_cast(enable=False):
            assert TF.linear(x, x).dtype == torch.float32
        assert TF.linear(x, x).dtype == torch.bfloat16
    assert TF.linear(x, x).dtype == torch.float32
