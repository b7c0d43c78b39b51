"""The port's incubate epilogue ops, `fused_moe`, the misc fused ops and
the softmax-mask operators held against the JAX package's (mirroring
tests/test_moe.py:159-250 and the TestFusedMiscOps part of
tests/test_fused_attention.py): `fused_bias_act` (every activation, the
gated ones acting on the first half), `fused_dropout_add` (at p = 0 and
outside training exactly; in training by its keep rate and scale, the two
RNGs differ), `fused_linear`, `fused_linear_activation`, `fused_moe`
(GShard top-k with capacity, group routing, weight-only int8, a token
count whose capacity drops routes), `fused_dot_product_attention` (the
flash route, a custom scale, a mask), `fused_gate_attention` (merged and
separate weights, bool, int and additive masks, the nonbatched bias),
`fused_matmul_bias`, `softmax_mask_fuse` and
`softmax_mask_fuse_upper_triangle`. Values within 1e-5, gradients within
1e-4 (f32). The options the JAX package accepts and never reads raise in
the port."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate as jax_inc
import paddle_tpu.incubate.nn.functional as jax_if
import paddle_tpu_torch.incubate as port_inc
from paddle_tpu_torch.framework import random as port_random
from paddle_tpu_torch.incubate.nn import functional as port_if
from paddle_tpu_torch.ops import flash_attention as port_fa

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _pair(jfn, tfn, *arrays, grad=False, **kw):
    """(jax out, port out[, jax grads, port grads]) on the same arrays; the
    gradients of sum(out * R) with respect to each float array."""
    js = [paddle.to_tensor(a, stop_gradient=not (grad and a.dtype == np.float32))
          if isinstance(a, np.ndarray) else a for a in arrays]
    ts = [torch.tensor(a, requires_grad=grad and a.dtype == np.float32)
          if isinstance(a, np.ndarray) else a for a in arrays]
    jo, to = jfn(*js, **kw), tfn(*ts, **kw)
    if not grad:
        return jo, to
    r = np.random.default_rng(9).standard_normal(tuple(to.shape)).astype(
        np.float32)
    (jo * paddle.to_tensor(r)).sum().backward()
    (to * torch.from_numpy(r)).sum().backward()
    jg = [np.asarray(t.grad.numpy()) for t in js
          if isinstance(t, paddle.Tensor) and not t.stop_gradient]
    tg = [t.grad.numpy() for t in ts if isinstance(t, torch.Tensor)
          and t.requires_grad]
    return jo, to, jg, tg


def _close(to, jo, tol=VAL):
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **tol)


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "identity", "geglu",
                                 "swiglu"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_bias_act_matches_jax(act, with_bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    args = (x, b) if with_bias else (x,)
    jo, to, jg, tg = _pair(jax_if.fused_bias_act, port_if.fused_bias_act,
                           *args, grad=True, act_method=act)
    assert tuple(to.shape) == ((3, 5, 4) if act in ("geglu", "swiglu")
                               else (3, 5, 8))
    _close(to, jo)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a, b_, **GRAD)


def test_fused_bias_act_gated_acts_on_the_first_half():
    x = torch.tensor([[1.0, -2.0, 3.0, 4.0]])
    out = port_if.fused_bias_act(x, act_method="swiglu")
    torch.testing.assert_close(out, torch.nn.functional.silu(x[:, :2])
                               * x[:, 2:])


def test_fused_bias_act_unread_options_raise():
    """dequant_scales, shift, smooth, quant_scale and compute_dtype are
    taken and never read by the JAX package
    (paddle_tpu/incubate/nn/functional/__init__.py:332-367): the port
    raises on them."""
    x = torch.zeros(2, 4)
    for bad in (dict(dequant_scales=torch.ones(4)), dict(shift=torch.ones(4)),
                dict(smooth=torch.ones(4)), dict(quant_scale=0.5),
                dict(compute_dtype="bf16")):
        with pytest.raises(NotImplementedError):
            port_if.fused_bias_act(x, **bad)
    xj = paddle.to_tensor(np.ones((2, 4), np.float32))
    np.testing.assert_array_equal(
        jax_if.fused_bias_act(xj, quant_scale=0.5, compute_dtype="bf16",
                              shift=xj).numpy(),
        jax_if.fused_bias_act(xj).numpy())
    with pytest.raises(ValueError):
        port_if.fused_bias_act(x, act_method="mish")


def test_fused_norm_quant_scale_raises():
    """fused_rms_norm / fused_layer_norm take quant_scale and never read
    it in the JAX package (:193-330): the port raises."""
    x, w = torch.ones(2, 4), torch.ones(4)
    for fn in (port_if.fused_rms_norm, port_if.fused_layer_norm):
        with pytest.raises(NotImplementedError):
            fn(x, w, quant_scale=0.5)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_fused_dropout_add(mode):
    """At p = 0 and outside training x + y in both packages (no
    downscale at inference, as the JAX package); in training the keep rate
    within 5 sigma and kept values x / (1 - p) (upscale) or x."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    y = rng.standard_normal((4, 64)).astype(np.float32)
    for kw in (dict(p=0.0), dict(p=0.4, training=False)):
        jo, to = _pair(jax_if.fused_dropout_add, port_if.fused_dropout_add,
                       x, y, mode=mode, **kw)
        _close(to, jo)
    p, n = 0.4, 1 << 18
    xt, yt = torch.rand(n) + 0.5, torch.rand(n)
    port_random.seed(3)
    out = port_if.fused_dropout_add(xt, yt, p=p, mode=mode)
    kept = (out - yt).abs() > 1e-6
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * (
        p * (1 - p) / n) ** 0.5
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    torch.testing.assert_close(out[kept], xt[kept] * scale + yt[kept])


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_and_matmul_bias_match_jax(transpose):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 6, 8)).astype(np.float32)
    w = rng.standard_normal((5, 8) if transpose else (8, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    jo, to, jg, tg = _pair(jax_if.fused_linear, port_if.fused_linear, x, w, b,
                           grad=True, transpose_weight=transpose)
    _close(to, jo)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a, b_, **GRAD)
    a2 = rng.standard_normal((8, 3)).astype(np.float32)
    jo, to = _pair(jax_if.fused_matmul_bias, port_if.fused_matmul_bias,
                   a2, w if transpose else w.T, None, transpose_x=True,
                   transpose_y=True)
    _close(to, jo)
    jo, to = _pair(jax_if.fused_matmul_bias, port_if.fused_matmul_bias,
                   x[0], w.T if transpose else w, b)
    _close(to, jo)


@pytest.mark.parametrize("act", ["gelu", "relu", "none", "swiglu", "geglu"])
def test_fused_linear_activation_matches_jax(act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.standard_normal((10, 8)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    jo, to, jg, tg = _pair(jax_if.fused_linear_activation,
                           port_if.fused_linear_activation, x, y, b,
                           grad=True, trans_x=True, trans_y=True,
                           activation=act)
    _close(to, jo)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a, b_, **GRAD)
    with pytest.raises(ValueError):
        port_if.fused_linear_activation(torch.zeros(2, 2), torch.zeros(2, 2),
                                        torch.zeros(2), activation="mish")


# --------------------------------------------------------------------------- #
# fused_moe (tests/test_moe.py:159-250)
# --------------------------------------------------------------------------- #

def _moe_arrays(seed, E=4, M=8, H=16, T=12, glu=True, gscale=0.1):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, M).astype(np.float32) * 0.5,
            rng.randn(M, E).astype(np.float32) * gscale,
            rng.randn(E, M, (2 if glu else 1) * H).astype(np.float32) * 0.1,
            rng.randn(E, H, M).astype(np.float32) * 0.1)


# name: (arrays kwargs, fused_moe kwargs)
MOE = {
    "top2_swiglu": (dict(seed=5), dict(moe_topk=2)),
    "top2_gelu_biases": (dict(seed=6, glu=False), dict(moe_topk=2)),
    "top1_unnormalized": (dict(seed=8), dict(moe_topk=1,
                                             norm_topk_prob=False)),
    "group_moe": (dict(seed=7, gscale=0.5), dict(moe_topk=2, group_moe=True)),
    # 64 tokens over 16 experts, one favoured: its 4 ceil(kT / E) = 16
    # slots overflow and the later routes are dropped
    "capacity_drops": (dict(seed=9, T=64, E=16, gscale=3.0),
                       dict(moe_topk=1)),
    "batched_input": (dict(seed=10, T=12), dict(moe_topk=2)),
}


@pytest.mark.parametrize("name", list(MOE))
def test_fused_moe_matches_jax(name):
    akw, kw = MOE[name]
    x, gw, w1, w2 = _moe_arrays(**akw)
    extra = {}
    if name == "top2_gelu_biases":
        rng = np.random.RandomState(1)
        extra = dict(ffn1_bias=rng.randn(4, w1.shape[-1]).astype(np.float32),
                     ffn2_bias=rng.randn(4, 8).astype(np.float32))
    if name == "capacity_drops":
        x = x + 2.0 * np.abs(x[:, :1])   # push most tokens to one expert
    if name == "batched_input":
        x = x.reshape(3, 4, 8)
    js = {k: paddle.to_tensor(v) for k, v in extra.items()}
    jo = jax_if.fused_moe(*[paddle.to_tensor(a) for a in (x, gw, w1, w2)],
                          **js, **kw)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, gw, w1, w2)]
    to = port_if.fused_moe(*ts, **{k: torch.from_numpy(v)
                                   for k, v in extra.items()}, **kw)
    _close(to, jo)
    if name == "capacity_drops":
        # some tokens were dropped by capacity: rows of zeros
        assert (to.abs().sum(-1) == 0).any()
    r = np.random.default_rng(0).standard_normal(tuple(to.shape)).astype(
        np.float32)
    (to * torch.from_numpy(r)).sum().backward()
    jts = [paddle.to_tensor(a, stop_gradient=False) for a in (x, gw, w1, w2)]
    (jax_if.fused_moe(*jts, **js, **kw) * paddle.to_tensor(r)).sum().backward()
    for a, b in zip(ts, jts):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **GRAD)


def test_fused_moe_weight_only_int8_matches_jax():
    x, gw, w1, w2 = _moe_arrays(7)

    def quant(w):
        scale = np.abs(w).max(axis=1) / 127.0
        return (np.clip(np.round(w / scale[:, None, :]), -128, 127).astype(
            np.int8), scale.astype(np.float32))

    (q1, s1), (q2, s2) = quant(w1), quant(w2)
    kw = dict(quant_method="weight_only_int8", moe_topk=2)
    jo = jax_if.fused_moe(*[paddle.to_tensor(a) for a in (x, gw, q1, q2)],
                          ffn1_scale=paddle.to_tensor(s1),
                          ffn2_scale=paddle.to_tensor(s2), **kw)
    to = port_if.fused_moe(*[torch.from_numpy(a) for a in (x, gw, q1, q2)],
                           ffn1_scale=torch.from_numpy(s1),
                           ffn2_scale=torch.from_numpy(s2), **kw)
    _close(to, jo)
    ref = port_if.fused_moe(*[torch.from_numpy(a) for a in (x, gw, w1, w2)],
                            moe_topk=2)
    assert (to - ref).abs().max() < 0.05 * ref.abs().max() + 1e-3
    with pytest.raises(ValueError):
        port_if.fused_moe(torch.from_numpy(x), torch.from_numpy(gw),
                          torch.from_numpy(q1), torch.from_numpy(q2), **kw)
    with pytest.raises(NotImplementedError):
        port_if.fused_moe(torch.from_numpy(x), torch.from_numpy(gw),
                          torch.from_numpy(w1), torch.from_numpy(w2),
                          quant_method="w4a8")
    with pytest.raises(ValueError):
        port_if.fused_moe(torch.from_numpy(x), torch.from_numpy(gw),
                          torch.from_numpy(w1), torch.from_numpy(w2),
                          moe_topk=3, group_moe=True)


# --------------------------------------------------------------------------- #
# fused_dot_product_attention, fused_gate_attention
# --------------------------------------------------------------------------- #

# name: (causal, scaling_factor, additive mask)
FDPA = {"causal": (True, None, False), "scaled": (False, 0.3, False),
        "masked_scaled": (False, 0.5, True)}


@pytest.mark.parametrize("name", list(FDPA))
def test_fused_dot_product_attention_matches_jax(name, monkeypatch):
    """Through scaled_dot_product_attention: without a mask the flash
    attention (its plain version here), with one the composite."""
    causal, sf, with_mask = FDPA[name]
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
               for _ in range(3))
    mask = (rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
            if with_mask else None)
    fwd = []
    real = port_fa.FlashAttention.apply
    monkeypatch.setattr(port_fa.FlashAttention, "apply",
                        lambda *a: fwd.append(1) or real(*a))
    args = (q, k, v) if mask is None else (q, k, v, mask)
    jo, to, jg, tg = _pair(jax_if.fused_dot_product_attention,
                           port_if.fused_dot_product_attention, *args,
                           grad=True, is_causal=causal, scaling_factor=sf)
    _close(to, jo)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **GRAD)
    assert len(fwd) == (0 if with_mask else 1)


# name: (merge_qkv, key given, mask kind, gating, nonbatched bias)
GATE = {"merged_gated_bias": (True, False, None, True, True),
        "separate_gated_bias": (False, False, None, True, True),
        "merged_bool_mask": (True, False, "bool", False, False),
        "merged_int_mask_key": (True, True, "int", True, False),
        "separate_float_mask": (False, False, "float", True, True)}


@pytest.mark.parametrize("name", list(GATE))
def test_fused_gate_attention_matches_jax(name):
    merge, with_key, mask_kind, gating, with_nb = GATE[name]
    rng = np.random.default_rng(2)
    n, b, q_len, a, h, d = 2, 3, 5, 8, 2, 4
    q_data = rng.normal(size=(n, b, q_len, a)).astype(np.float32)
    key = rng.normal(size=(n, b, q_len, a)).astype(np.float32)
    w = {k: rng.normal(size=s).astype(np.float32) * 0.3 for k, s in dict(
        qkv_weight=(3, h, d, a), query_weight=(a, h, d), key_weight=(a, h, d),
        value_weight=(a, h, d), gate_linear_weight=(a, h, d),
        out_linear_weight=(h, d, a)).items()}
    w["gate_linear_bias"] = rng.normal(size=(h, d)).astype(np.float32) * 0.1
    w["out_linear_bias"] = rng.normal(size=(a,)).astype(np.float32) * 0.1
    if merge:
        for k in ("query_weight", "key_weight", "value_weight"):
            del w[k]
    else:
        del w["qkv_weight"]
    if not gating:
        del w["gate_linear_weight"], w["gate_linear_bias"]
    if with_nb:
        w["nonbatched_bias"] = rng.normal(size=(n, h, q_len, q_len)).astype(
            np.float32)
    if mask_kind:
        keep = rng.random((n, b, 1, 1, q_len)) > 0.3
        keep[..., 0] = True
        w["attn_mask"] = {"bool": keep, "int": keep.astype(np.int32),
                          "float": np.where(keep, 0.0, -1e9).astype(
                              np.float32)}[mask_kind]
    kw = dict(has_gating=gating, merge_qkv=merge)
    res = []
    for conv in (paddle.to_tensor, torch.from_numpy):
        res.append((jax_if if conv is paddle.to_tensor else port_if)
                   .fused_gate_attention(
                       conv(q_data), key=conv(key) if with_key else None,
                       **{k: conv(v) for k, v in w.items()}, **kw))
    _close(res[1], res[0])


def test_fused_gate_attention_validation():
    x = torch.zeros(1, 1, 2, 4)
    for kw in (dict(qkv_weight=torch.zeros(3, 1, 2, 4)),
               dict(qkv_weight=torch.zeros(3, 1, 2, 4),
                    out_linear_weight=torch.zeros(1, 2, 4)),
               dict(merge_qkv=False, out_linear_weight=torch.zeros(1, 2, 4),
                    has_gating=False),
               dict(out_linear_weight=torch.zeros(1, 2, 4),
                    has_gating=False)):
        with pytest.raises(ValueError):
            port_if.fused_gate_attention(x, **kw)


# --------------------------------------------------------------------------- #
# incubate.operators
# --------------------------------------------------------------------------- #

def test_softmax_mask_fuse_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
    m = np.where(rng.random((2, 1, 6, 6)) > 0.3, 0.0, -1e4).astype(np.float32)
    jo, to, jg, tg = _pair(jax_inc.softmax_mask_fuse,
                           port_inc.softmax_mask_fuse, x, m, grad=True)
    _close(to, jo)
    np.testing.assert_allclose(tg[0], jg[0], **GRAD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_mask_fuse_upper_triangle_matches_jax(dtype):
    """Above the diagonal the scores take the dtype's lowest finite value
    (finfo(dtype).min), so the probabilities there are exactly 0."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 7)).astype(np.float32)
    jo = jax_inc.softmax_mask_fuse_upper_triangle(
        paddle.to_tensor(x).astype(dtype))
    to = port_inc.softmax_mask_fuse_upper_triangle(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(to.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype("float32").numpy()),
                               **(VAL if dtype == "float32"
                                  else dict(rtol=0, atol=2 ** -8)))
    assert (to.float().triu(1) == 0).all()


def test_incubate_exports_match_the_reference():
    import paddle_tpu.incubate.nn as jax_inn
    import paddle_tpu_torch.incubate.nn as port_inn

    assert set(jax_if.__all__) <= set(port_if.__all__)
    assert set(jax_inn.__all__) <= set(port_inn.__all__)
    for name in ("softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
                 "operators", "nn"):
        assert hasattr(port_inc, name) and name in port_inc.__all__
