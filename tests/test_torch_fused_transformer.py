"""The port's fused transformer blocks held against the JAX package's
(mirroring tests/test_fused_attention.py and tests/test_inference.py:317-345):
`fused_multi_head_attention` (pre- and post-LN, bool, int and additive
masks, a KV cache, the [E, 3E] layout; without a mask the flash route, the
JAX Pallas kernels in interpret mode against the port's plain versions),
`fused_feedforward` and `fused_bias_dropout_residual_layer_norm`, values
and gradients of every input; the four fused layers with the weights
carried across by `load_paddle_tpu_state` (their state_dict names equal
the reference's), values and every parameter's gradient;
`FusedMultiTransformer` (the stacked [L, ...] weights carried across, the
full forward, a prefill then cached decode steps, GQA with RMSNorm, the
rotary switch), and the cached decode against the uncached forward. f32;
values within 1e-5, gradients within 1e-4. Dropout at p > 0 is held by
its statistics (keep rate, scale) on the port alone: the two RNGs differ.
Also the port's own rules: a ParamAttr raises naming ROADMAP item 6, the
options the JAX package ignores raise."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jax_inn
import paddle_tpu.incubate.nn.functional as jax_if
import paddle_tpu_torch.incubate.nn as port_inn
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.framework import random as port_random
from paddle_tpu_torch.incubate.nn import functional as port_if
from paddle_tpu_torch.incubate.nn.functional import fused_attention_ops

B, S, E, H = 2, 8, 32, 4
D = E // H
VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _run_both(jfn, tfn, arrays, kw_arrays=None, kw=None, grad=True, seed=0):
    """jfn / tfn on the same numpy inputs (float arrays take gradients),
    loss = sum(out * R) for a fixed random R; returns ((j_out, j_grads),
    (t_out, t_grads)), grads in input order (None for non-float ones)."""
    kw_arrays = kw_arrays or {}
    kw = kw or {}
    names = list(range(len(arrays))) + list(kw_arrays)
    vals = list(arrays) + list(kw_arrays.values())
    res = []
    for pkg in ("jax", "torch"):
        ts = []
        for v in vals:
            fl = v is not None and v.dtype == np.float32 and grad
            if v is None:
                ts.append(None)
            elif pkg == "jax":
                ts.append(paddle.to_tensor(v, stop_gradient=not fl))
            else:
                ts.append(torch.tensor(v, requires_grad=fl))
        pos = ts[:len(arrays)]
        kws = dict(zip(list(kw_arrays), ts[len(arrays):]))
        out = (jfn if pkg == "jax" else tfn)(*pos, **kws, **kw)
        first = out[0] if isinstance(out, tuple) else out
        r = np.random.default_rng(seed + 99).standard_normal(
            tuple(first.shape)).astype(np.float32)
        grads = [None] * len(ts)
        if grad:
            if pkg == "jax":
                (first * paddle.to_tensor(r)).sum().backward()
                grads = [None if t is None or t.stop_gradient
                         else np.asarray(t.grad.numpy()) for t in ts]
            else:
                (first * torch.from_numpy(r)).sum().backward()
                grads = [None if t is None or t.grad is None
                         else t.grad.numpy() for t in ts]
        res.append((out, grads))
    return res, names


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


def _assert_match(res, names):
    (jo, jg), (to, tg) = res
    jo = jo if isinstance(jo, tuple) else (jo,)
    to = to if isinstance(to, tuple) else (to,)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(_np(a), _np(b), **VAL)
    for n, a, b in zip(names, tg, jg):
        assert (a is None) == (b is None), n
        if a is not None:
            np.testing.assert_allclose(a, b, err_msg=str(n), **GRAD)


def _mha_arrays(rng, transpose=False):
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    if transpose:
        qkv_w = rng.normal(size=(E, 3 * E)).astype(np.float32) * 0.2
        qkv_b = rng.normal(size=(3 * E,)).astype(np.float32) * 0.1
    else:
        qkv_w = rng.normal(size=(3, H, D, E)).astype(np.float32) * 0.2
        qkv_b = rng.normal(size=(3, H, D)).astype(np.float32) * 0.1
    lin_w = rng.normal(size=(E, E)).astype(np.float32) * 0.2
    lin_b = rng.normal(size=(E,)).astype(np.float32) * 0.1
    ln_s = rng.normal(size=(E,)).astype(np.float32) * 0.1 + 1.0
    ln_b = rng.normal(size=(E,)).astype(np.float32) * 0.1
    return x, qkv_w, qkv_b, lin_w, lin_b, ln_s, ln_b


# name: (pre-LN, mask kind, cache, transpose_qkv_wb)
MHA = {"post_ln_flash": (False, None, False, False),
       "pre_ln_flash": (True, None, False, False),
       "additive_mask": (False, "float", False, False),
       "bool_mask_pre_ln": (True, "bool", False, False),
       "int_mask": (False, "int", False, False),
       "cache_kv_flash": (False, None, True, False),
       "cache_kv_bool_mask": (True, "bool", True, False),
       "transpose_qkv_wb": (False, None, False, True)}


@pytest.mark.parametrize("name", list(MHA))
def test_fused_multi_head_attention_values_and_grads_match_jax(name):
    pre, mask_kind, with_cache, transpose = MHA[name]
    rng = np.random.default_rng(0)
    x, qkv_w, qkv_b, lin_w, lin_b, ln_s, ln_b = _mha_arrays(rng, transpose)
    sc = 3 if with_cache else 0
    mask = None
    if mask_kind == "float":
        mask = np.where(rng.random((B, 1, S, S + sc)) > 0.2, 0.0,
                        -1e9).astype(np.float32)
    elif mask_kind is not None:
        keep = rng.random((B, 1, S, S + sc)) > 0.2
        keep[..., 0] = True
        mask = keep if mask_kind == "bool" else keep.astype(np.int32)
    cache = (rng.normal(size=(2, B, H, sc, D)).astype(np.float32)
             if with_cache else None)
    kw_arrays = dict(qkv_bias=qkv_b, linear_bias=lin_b, attn_mask=mask,
                     cache_kv=cache)
    if pre:
        kw_arrays.update(pre_ln_scale=ln_s, pre_ln_bias=ln_b)
    else:
        kw_arrays.update(ln_scale=ln_s, ln_bias=ln_b)
    kw = dict(pre_layer_norm=pre, dropout_rate=0.0, attn_dropout_rate=0.0,
              transpose_qkv_wb=transpose, num_heads=H if transpose else -1)
    res, names = _run_both(jax_if.fused_multi_head_attention,
                           port_if.fused_multi_head_attention,
                           (x, qkv_w, lin_w), kw_arrays, kw)
    if with_cache:
        assert tuple(res[1][0][1].shape) == (2, B, H, S + sc, D)
    _assert_match(res, names)


@pytest.mark.parametrize("act", ["relu", "gelu", "silu", "tanh"])
@pytest.mark.parametrize("pre", [False, True])
def test_fused_feedforward_values_and_grads_match_jax(act, pre):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    w1 = rng.normal(size=(E, 4 * E)).astype(np.float32) * 0.2
    w2 = rng.normal(size=(4 * E, E)).astype(np.float32) * 0.2
    kw_arrays = dict(
        linear1_bias=rng.normal(size=(4 * E,)).astype(np.float32) * 0.1,
        linear2_bias=rng.normal(size=(E,)).astype(np.float32) * 0.1)
    ln = dict(scale=rng.normal(size=(E,)).astype(np.float32) * 0.1 + 1,
              bias=rng.normal(size=(E,)).astype(np.float32) * 0.1)
    key = "ln1" if pre else "ln2"
    kw_arrays.update({f"{key}_scale": ln["scale"], f"{key}_bias": ln["bias"]})
    res, names = _run_both(
        jax_if.fused_feedforward, port_if.fused_feedforward, (x, w1, w2),
        kw_arrays, dict(dropout1_rate=0.0, dropout2_rate=0.0, activation=act,
                        pre_layer_norm=pre))
    _assert_match(res, names)


def test_fused_bias_dropout_residual_layer_norm_matches_jax():
    rng = np.random.default_rng(6)
    arrays = [rng.normal(size=(B, S, E)).astype(np.float32) for _ in range(2)]
    kw_arrays = dict(bias=rng.normal(size=(E,)).astype(np.float32),
                     ln_scale=rng.normal(size=(E,)).astype(np.float32) + 1,
                     ln_bias=rng.normal(size=(E,)).astype(np.float32))
    res, names = _run_both(jax_if.fused_bias_dropout_residual_layer_norm,
                           port_if.fused_bias_dropout_residual_layer_norm,
                           arrays, kw_arrays, dict(dropout_rate=0.0))
    _assert_match(res, names)


def test_flash_route_without_a_mask(monkeypatch):
    """No mask and no attention dropout: the flash attention (its plain
    version here); a mask or active attention dropout: the composite."""
    calls = []
    real = fused_attention_ops.flash_attention_fwd
    monkeypatch.setattr(fused_attention_ops, "flash_attention_fwd",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    rng = np.random.default_rng(0)
    x, qkv_w, _, lin_w, _, _, _ = (torch.from_numpy(a)
                                   for a in _mha_arrays(rng))
    port_if.fused_multi_head_attention(x, qkv_w, lin_w, dropout_rate=0.0,
                                       attn_dropout_rate=0.0)
    assert calls == [dict(causal=False)]
    port_if.fused_multi_head_attention(
        x, qkv_w, lin_w, attn_mask=torch.ones(B, 1, S, S, dtype=torch.bool),
        dropout_rate=0.0, attn_dropout_rate=0.0)
    port_if.fused_multi_head_attention(x, qkv_w, lin_w, dropout_rate=0.0,
                                       attn_dropout_rate=0.3)
    assert len(calls) == 1
    # in eval the attention dropout is inactive: the flash route again
    port_if.fused_multi_head_attention(x, qkv_w, lin_w, dropout_rate=0.3,
                                       attn_dropout_rate=0.3, training=False)
    assert len(calls) == 2


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_rule_statistics(mode):
    """`_dropout` (↔ fused_attention_ops.py:50): in training the keep rate
    within 5 sigma of 1 - p and kept values x / (1 - p) (upscale) or x
    (downscale); outside training x (upscale) or x (1 - p) (downscale);
    nothing drawn at p = 0 or outside training."""
    p, n = 0.3, 1 << 18
    x = torch.rand(n) + 0.5
    port_random.seed(7)
    y = fused_attention_ops._dropout(x, p, True, mode)
    kept = y != 0
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    torch.testing.assert_close(y[kept], x[kept] * scale)
    state = port_random.get_rng_state()
    ev = fused_attention_ops._dropout(x, p, False, mode)
    torch.testing.assert_close(ev, x if mode == "upscale_in_train"
                               else x * (1 - p))
    assert fused_attention_ops._dropout(x, 0.0, True, mode) is x
    after = port_random.get_rng_state()
    assert all(torch.equal(after[2][k], state[2][k]) for k in state[2])


def test_dropout_in_the_blocks_draws_from_the_port_generators():
    rng = np.random.default_rng(3)
    x, qkv_w, _, lin_w, _, _, _ = (torch.from_numpy(a)
                                   for a in _mha_arrays(rng))
    port_random.seed(1)
    a = port_if.fused_multi_head_attention(x, qkv_w, lin_w, dropout_rate=0.5,
                                           attn_dropout_rate=0.5)
    b = port_if.fused_multi_head_attention(x, qkv_w, lin_w, dropout_rate=0.5,
                                           attn_dropout_rate=0.5)
    port_random.seed(1)
    a2 = port_if.fused_multi_head_attention(x, qkv_w, lin_w, dropout_rate=0.5,
                                            attn_dropout_rate=0.5)
    assert not torch.allclose(a, b)
    torch.testing.assert_close(a, a2, rtol=0, atol=0)
    e1 = port_if.fused_multi_head_attention(x, qkv_w, lin_w, dropout_rate=0.5,
                                            attn_dropout_rate=0.5,
                                            training=False)
    e0 = port_if.fused_multi_head_attention(x, qkv_w, lin_w, dropout_rate=0.0,
                                            attn_dropout_rate=0.0)
    torch.testing.assert_close(e1, e0)


# --------------------------------------------------------------------------- #
# the layers
# --------------------------------------------------------------------------- #

LAYERS = {
    "mha_post_ln": (lambda m: m.FusedMultiHeadAttention(
        E, H, dropout_rate=0.0, attn_dropout_rate=0.0), "x"),
    "mha_pre_ln_transposed": (lambda m: m.FusedMultiHeadAttention(
        E, H, dropout_rate=0.0, attn_dropout_rate=0.0, normalize_before=True,
        transpose_qkv_wb=True), "x"),
    "ffn_pre_ln_gelu": (lambda m: m.FusedFeedForward(
        E, 2 * E, dropout_rate=0.0, activation="gelu",
        normalize_before=True), "x"),
    "encoder_post_ln": (lambda m: m.FusedTransformerEncoderLayer(
        E, H, 2 * E, dropout_rate=0.0, activation="gelu"), "x"),
    "encoder_pre_ln_no_bias": (lambda m: m.FusedTransformerEncoderLayer(
        E, H, 2 * E, dropout_rate=0.0, normalize_before=True,
        bias_attr=False), "x"),
    "bias_dropout_residual_ln": (lambda m: m.FusedBiasDropoutResidualLayerNorm(
        E, dropout_rate=0.0), "xr"),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layers_state_and_grads_match_jax(name):
    make, inputs = LAYERS[name]
    paddle.seed(0)

    class NS:
        pass

    jns, tns = NS(), NS()
    jns.__dict__.update(vars(jax_inn))
    for k, v in vars(port_inn).items():
        if isinstance(v, type):
            setattr(tns, k, (lambda cls: lambda *a, **kw: cls(
                *a, device="cpu", **kw))(v))
    jl = make(jns)
    rng = np.random.default_rng(4)
    for k, p in jl.named_parameters():   # non-trivial LN scales and biases
        p.set_value(paddle.to_tensor((rng.standard_normal(p.shape) * 0.2
                                      + ("scale" in k)).astype(np.float32)))
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    tl = make(tns)
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == \
        {k: v.shape for k, v in state.items()}
    load_paddle_tpu_state(tl, state)
    xs = [rng.standard_normal((B, S, E)).astype(np.float32)
          for _ in range(len(inputs))]
    r = rng.standard_normal((B, S, E)).astype(np.float32)
    jo = jl(*[paddle.to_tensor(a) for a in xs])
    (jo * paddle.to_tensor(r)).sum().backward()
    to = tl(*[torch.from_numpy(a) for a in xs])
    (to * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **VAL)
    jg = {k: np.asarray(p.grad.numpy()) for k, p in jl.named_parameters()}
    for k, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[k], err_msg=k, **GRAD)


def test_layer_rules():
    """A ParamAttr applies (an attr that is none raises a TypeError), False
    drops the bias; nranks > 1 (the mp cut, item 1f) and need_weights
    raise."""
    from paddle_tpu_torch import ParamAttr
    from paddle_tpu_torch.nn.initializer import Constant
    mk = port_inn.FusedMultiHeadAttention
    with pytest.raises(TypeError, match="ParamAttr"):
        mk(E, H, qkv_weight_attr=object(), device="cpu")
    layer = mk(E, H, qkv_weight_attr=ParamAttr(initializer=Constant(0.5),
                                               need_clip=False),
               device="cpu")
    assert bool((layer.qkv_weight == 0.5).all())
    assert layer.qkv_weight.need_clip is False
    layer = mk(E, H, qkv_bias_attr=False, linear_bias_attr=False,
               device="cpu")
    assert layer.qkv_bias is None and "qkv_bias" not in layer.state_dict()
    with pytest.raises(NotImplementedError, match="1f"):
        mk(E, H, nranks=2, device="cpu")
    with pytest.raises(NotImplementedError):
        mk(E, H, need_weights=True, device="cpu")
    with pytest.raises(TypeError, match="ParamAttr"):
        port_inn.FusedTransformerEncoderLayer(E, H, 2 * E, weight_attr=object(),
                                              device="cpu")


# --------------------------------------------------------------------------- #
# FusedMultiTransformer
# --------------------------------------------------------------------------- #

FMT = {"layernorm_gelu": dict(), "rmsnorm_gqa_relu": dict(
    norm_type="rmsnorm", gqa_group_size=2, activation="relu",
    num_heads=4)}


def _fmt_pair(kw, seed=3):
    kw = dict(dict(embed_dim=16, num_heads=2, dim_feedforward=32,
                   num_layers=2), **kw)
    paddle.seed(seed)
    jm = jax_inn.FusedMultiTransformer(**kw)
    rng = np.random.RandomState(seed)
    for p in jm.parameters():
        p.set_value(paddle.to_tensor(
            rng.randn(*p.shape).astype(np.float32) * 0.2))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = port_inn.FusedMultiTransformer(**kw, device="cpu")
    load_paddle_tpu_state(tm, state)
    return jm, tm


@pytest.mark.parametrize("rope", [0, 1])
@pytest.mark.parametrize("name", list(FMT))
def test_fused_multi_transformer_matches_jax(name, rope):
    """The stacked weights carried across; the full forward (with an
    additive mask), a 5-token prefill and two cached steps against the
    JAX package's, the port's caches written in place and equal to the
    JAX ones; the last cached step against the full forward."""
    jm, tm = _fmt_pair(FMT[name])
    rng = np.random.RandomState(0)
    src = rng.randn(2, 7, 16).astype(np.float32)
    mask = (rng.randn(1, 1, 7, 7) * 0.1).astype(np.float32)
    full_j = jm(paddle.to_tensor(src), attn_mask=paddle.to_tensor(mask),
                rotary_emb_dims=rope).numpy()
    full_t = tm(torch.from_numpy(src), attn_mask=torch.from_numpy(mask),
                rotary_emb_dims=rope)
    np.testing.assert_allclose(full_t.detach().numpy(), full_j, **VAL)
    cj = jm.init_caches(2, 8)
    ct = tm.init_caches(2, 8)
    with torch.no_grad():
        for s0, s1 in ((0, 5), (5, 6), (6, 7)):
            ts = None if s0 == 0 else s0
            hj, cj = jm(paddle.to_tensor(src[:, s0:s1]), caches=cj,
                        time_step=ts, rotary_emb_dims=rope)
            ht, ret = tm(torch.from_numpy(src[:, s0:s1]), caches=ct,
                         time_step=ts, rotary_emb_dims=rope)
            assert ret is ct
            np.testing.assert_allclose(ht.numpy(), hj.numpy(), **VAL)
            np.testing.assert_allclose(ct.numpy(), cj.numpy(), **VAL)
        full_nomask = tm(torch.from_numpy(src), rotary_emb_dims=rope)
    np.testing.assert_allclose(ht.numpy()[:, 0], full_nomask.numpy()[:, 6],
                               **VAL)


def test_fused_multi_transformer_gradients_match_jax():
    jm, tm = _fmt_pair(FMT["rmsnorm_gqa_relu"])
    src = np.random.RandomState(1).randn(2, 5, 16).astype(np.float32)
    r = np.random.RandomState(2).randn(2, 5, 16).astype(np.float32)
    (jm(paddle.to_tensor(src)) * paddle.to_tensor(r)).sum().backward()
    (tm(torch.from_numpy(src)) * torch.from_numpy(r)).sum().backward()
    jg = {k: np.asarray(p.grad.numpy()) for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[k], err_msg=k, **GRAD)


def test_fused_multi_transformer_unread_options_raise():
    """The JAX package reads only whether rotary_embs is given and ignores
    seq_lens, dropout_rate, trans_qkvw, nranks and ring_id
    (paddle_tpu/incubate/nn/layer/fused_transformer.py:100, :139-146):
    the port raises on them."""
    kw = dict(embed_dim=16, num_heads=2, dim_feedforward=32, num_layers=1,
              device="cpu")
    for bad in (dict(dropout_rate=0.1), dict(trans_qkvw=False),
                dict(nranks=2), dict(ring_id=0)):
        with pytest.raises(NotImplementedError):
            port_inn.FusedMultiTransformer(**kw, **bad)
    tm = port_inn.FusedMultiTransformer(**kw)
    x = torch.zeros(1, 3, 16)
    for bad in (dict(rotary_embs=torch.zeros(2, 1, 3, 1, 4)),
                dict(seq_lens=torch.ones(1, dtype=torch.int32)),
                dict(pre_caches=torch.zeros(1))):
        with pytest.raises(NotImplementedError):
            tm(x, **bad)
    # the JAX package: a rotary table of any content gives its own rotation
    jm, _ = _fmt_pair(dict(num_layers=1))
    src = paddle.to_tensor(np.ones((1, 3, 16), np.float32))
    a = jm(src, rotary_embs=paddle.to_tensor(np.zeros((2, 1, 3, 1, 4),
                                                      np.float32))).numpy()
    np.testing.assert_array_equal(a, jm(src, rotary_emb_dims=1).numpy())
