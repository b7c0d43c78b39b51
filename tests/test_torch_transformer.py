"""The port's `nn.MultiHeadAttention`, `TransformerEncoderLayer`,
`TransformerDecoderLayer` and `Transformer` held to the JAX package's on
the CPU in f32, the weights carried across by `load_paddle_tpu_state`:
self-attention with a key-padding mask (the JAX side's flash key-bias
kernel in interpret mode, the port's plain version), cross-attention with
kdim / vdim, a [B, H, S, S] mask on the exact composite, the incremental
and static caches; the encoder layer in both `normalize_before` branches
with both activations (output and every parameter gradient), the decoder
layer, and the whole `Transformer` under a square causal mask.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.ops import flash_attention as port_fa

# f32 both sides: projections and softmaxes sum in other orders; outputs
# of magnitude ~1 agree to a few 1e-6
TOL = dict(rtol=1e-5, atol=1e-5)
E, H, B, S = 32, 4, 2, 12


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _pair(jax_cls, port_cls, *args, **kw):
    """(JAX layer, port layer with the JAX layer's weights)."""
    paddle.seed(0)
    jm = jax_cls(*args, **kw)
    tm = port_cls(*args, **kw, device="cpu")
    load_paddle_tpu_state(tm, _state(jm))
    return jm, tm


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _key_padding(pad_from):
    """Additive [B, 1, 1, S] mask: row b pads its keys from pad_from[b] on
    with -1e4 (BERT's form)."""
    m = np.zeros((B, 1, 1, S), np.float32)
    for b, p in enumerate(pad_from):
        m[b, ..., p:] = -1e4
    return m


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()),
                               **TOL)


def test_self_attention_with_a_key_padding_mask():
    jm, tm = _pair(jnn.MultiHeadAttention, pnn.MultiHeadAttention, E, H)
    x, mask = _x(0, B, S, E), _key_padding([S, 7])
    want = jm(paddle.to_tensor(x), attn_mask=paddle.to_tensor(mask))
    got = tm(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    _close(got, want)
    assert port_fa.FWD_LAUNCHES == 0   # the plain version on CPU tensors


def test_cross_attention_with_kdim_vdim():
    jm, tm = _pair(jnn.MultiHeadAttention, pnn.MultiHeadAttention, E, H,
                   kdim=24, vdim=40)
    q, k, v = _x(1, B, S, E), _x(2, B, 9, 24), _x(3, B, 9, 40)
    want = jm(paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v))
    got = tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    _close(got, want)


@pytest.mark.parametrize("kind", ["additive", "bool"])
def test_a_full_mask_takes_the_composite(kind):
    jm, tm = _pair(jnn.MultiHeadAttention, pnn.MultiHeadAttention, E, H)
    x = _x(4, B, S, E)
    keep = np.random.default_rng(5).random((B, H, S, S)) > 0.3
    keep[..., 0] = True
    mask = keep if kind == "bool" else np.where(keep, 0.0, -1e4).astype(np.float32)
    want = jm(paddle.to_tensor(x), attn_mask=paddle.to_tensor(mask))
    got = tm(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    _close(got, want)


def test_incremental_and_static_caches():
    jm, tm = _pair(jnn.MultiHeadAttention, pnn.MultiHeadAttention, E, H)
    mem = _x(6, B, 5, E)
    jc = jm.gen_cache(paddle.to_tensor(mem))
    tc = tm.gen_cache(torch.from_numpy(mem))
    for t in range(3):
        x = _x(10 + t, B, 1, E)
        jo, jc = jm(paddle.to_tensor(x), cache=jc)
        to, tc = tm(torch.from_numpy(x), cache=tc)
        _close(to, jo)
    assert tuple(tc.k.shape) == (B, 3, H, E // H)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    js = jm.gen_cache(paddle.to_tensor(mem), type=jnn.MultiHeadAttention.StaticCache)
    ts = tm.gen_cache(torch.from_numpy(mem), type=pnn.MultiHeadAttention.StaticCache)
    x = _x(20, B, 4, E)
    jo, _ = jm(paddle.to_tensor(x), cache=js)
    to, out_cache = tm(torch.from_numpy(x), cache=ts)
    _close(to, jo)
    assert out_cache is ts


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_layer_output_and_gradients(normalize_before, activation):
    jm, tm = _pair(jnn.TransformerEncoderLayer, pnn.TransformerEncoderLayer,
                   E, H, 64, dropout=0.0, activation=activation,
                   normalize_before=normalize_before)
    x, mask = _x(7, B, S, E), _key_padding([9, S])
    g = _x(8, B, S, E)
    jo = jm(paddle.to_tensor(x), paddle.to_tensor(mask))
    (jo * paddle.to_tensor(g)).sum().backward()
    to = tm(torch.from_numpy(x), torch.from_numpy(mask))
    (to * torch.from_numpy(g)).sum().backward()
    _close(to, jo)
    jg = {k: p.grad.numpy() for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        scale = max(1.0, float(np.abs(jg[k]).max()))
        np.testing.assert_allclose(p.grad.numpy(), jg[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


def test_encoder_copies_its_layer():
    paddle.seed(0)
    layer = jnn.TransformerEncoderLayer(E, H, 64, dropout=0.0)
    jm = jnn.TransformerEncoder(layer, 3, norm=jnn.LayerNorm(E))
    tm = pnn.TransformerEncoder(
        pnn.TransformerEncoderLayer(E, H, 64, dropout=0.0, device="cpu"), 3,
        norm=pnn.LayerNorm(E, device="cpu"))
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    load_paddle_tpu_state(tm, _state(jm))
    x = _x(9, B, S, E)
    _close(tm(torch.from_numpy(x)), jm(paddle.to_tensor(x)))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer(normalize_before):
    jm, tm = _pair(jnn.TransformerDecoderLayer, pnn.TransformerDecoderLayer,
                   E, H, 64, dropout=0.0, normalize_before=normalize_before)
    tgt, mem = _x(11, B, S, E), _x(12, B, 7, E)
    causal = np.triu(np.full((S, S), -np.inf, np.float32), 1)
    want = jm(paddle.to_tensor(tgt), paddle.to_tensor(mem),
              paddle.to_tensor(causal))
    got = tm(torch.from_numpy(tgt), torch.from_numpy(mem),
             torch.from_numpy(causal))
    _close(got, want)


def test_transformer_under_a_square_causal_mask():
    jm, tm = _pair(jnn.Transformer, pnn.Transformer, E, H, 2, 2, 64,
                   dropout=0.0, normalize_before=True)
    src, tgt = _x(13, B, 9, E), _x(14, B, S, E)
    jmask = jnn.Transformer.generate_square_subsequent_mask(S)
    tmask = pnn.Transformer.generate_square_subsequent_mask(S, device="cpu")
    np.testing.assert_array_equal(tmask.numpy(), jmask.numpy())
    want = jm(paddle.to_tensor(src), paddle.to_tensor(tgt), tgt_mask=jmask)
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=tmask)
    _close(got, want)


def test_dropout_above_zero_in_training_raises_and_weight_attr_raises():
    """Dropout above 0 in training now runs (it raised before the port's
    generators): eval mode drops nothing, training draws from the port's
    generator (the same output again from the same seed, another from the
    next draw); a weight_attr that is no ParamAttr raises a TypeError (the
    reference's `ParamAttr._to_attr`), and a ParamAttr applies to every
    projection."""
    from paddle_tpu_torch import seed

    tm = pnn.TransformerEncoderLayer(E, H, 64, dropout=0.1, device="cpu")
    x = torch.from_numpy(_x(15, B, S, E))
    tm.eval()
    plain = tm(x)
    tm.train()
    seed(7)
    a = tm(x)
    b = tm(x)
    seed(7)
    torch.testing.assert_close(tm(x), a, rtol=0, atol=0)
    assert (a - plain).abs().max() > 1e-3 and (a - b).abs().max() > 1e-3
    with pytest.raises(TypeError, match="ParamAttr"):
        pnn.MultiHeadAttention(E, H, weight_attr=object(), device="cpu")
    from paddle_tpu_torch import ParamAttr
    from paddle_tpu_torch.nn.initializer import Constant
    mha = pnn.MultiHeadAttention(E, H, weight_attr=ParamAttr(
        initializer=Constant(0.5), learning_rate=0.25), device="cpu")
    for lin in (mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj):
        assert bool((lin.weight == 0.5).all())
        assert lin.weight.optimize_attr["learning_rate"] == 0.25
