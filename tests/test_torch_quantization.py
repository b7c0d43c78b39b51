"""The port's quantization held against the JAX package's (mirroring
tests/test_quantization.py and the PTQ/QAT part of
tests/test_quant_audio_text.py): `fake_quant` (values at a computed and a
given scale, the straight-through gradient), `AbsMaxObserver`,
`QuantConfig`, `PTQ` (the observers' activation scales, the converted
model's int8 payloads bit for bit and its outputs, convert refusing
another model) and `QAT` (outputs and gradients through the fake-quantized
weights, the stored weight untouched), on a Sequential MLP whose weights
are carried across by `load_paddle_tpu_state`. On `gpt3_tiny` the port's
PTQ converts the 12 decoder projections (its parallel layers are Linear
subclasses) to the payloads `ptq_convert_for_serving` gives; the JAX
package's converts none (ROADMAP queue C). Values within 1e-5, gradients
within 1e-4."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.quantization as jq
import paddle_tpu_torch.quantization as tq
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt3_tiny as jax_gpt3_tiny
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models import GPTForCausalLM, gpt3_tiny

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale", [None, 0.01])
def test_fake_quant_values_and_straight_through_grad_match_jax(scale):
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32) * 2
    r = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    xj = paddle.to_tensor(x, stop_gradient=False)
    yj = jq.fake_quant(xj, scale=scale)
    (yj * paddle.to_tensor(r)).sum().backward()
    xt = torch.tensor(x, requires_grad=True)
    yt = tq.fake_quant(xt, scale=scale)
    (yt * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), yj.numpy(), **VAL)
    np.testing.assert_array_equal(xt.grad.numpy(), r)   # identity
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.numpy(), **GRAD)
    if scale is None:   # 255 levels of |x|max / 127
        s = np.abs(x).max() / 127
        assert np.allclose(yt.detach().numpy() / s,
                           np.round(yt.detach().numpy() / s), atol=1e-3)
    assert torch.equal(tq.fake_quant(torch.zeros(4)), torch.zeros(4))


def test_abs_max_observer_matches_jax():
    rng = np.random.default_rng(2)
    jo, to = jq.AbsMaxObserver(), tq.AbsMaxObserver()
    assert to.scale() == jo.scale() == 1.0
    for _ in range(3):
        a = rng.standard_normal((4, 5)).astype(np.float32) * rng.uniform(1, 3)
        jo.observe(paddle.to_tensor(a))
        to.observe(torch.from_numpy(a))
    assert to.scale() == pytest.approx(jo.scale(), rel=1e-7)
    assert tq.AbsMaxObserver(quant_bits=4).scale() == 1.0


def test_quant_config():
    c = tq.QuantConfig()
    assert c.weight is tq.AbsMaxObserver and c.activation is None
    assert c._types == [tnn.Linear]
    c.add_type_config([tnn.Conv2D, tnn.Linear], activation=tq.AbsMaxObserver)
    assert c._types == [tnn.Linear, tnn.Conv2D]
    assert c.activation is tq.AbsMaxObserver


def _mlps(seed=0):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    tm = tnn.Sequential(tnn.Linear(16, 32, device="cpu"), tnn.ReLU(),
                        tnn.Linear(32, 4, device="cpu"))
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def test_ptq_calibrate_and_convert_match_jax():
    jm, tm = _mlps()
    rng = np.random.default_rng(0)
    cal = [rng.normal(size=(8, 16)).astype(np.float32) * s for s in (1, 2.5)]
    x = rng.normal(size=(8, 16)).astype(np.float32)
    ref = tm(torch.from_numpy(x)).detach()
    jp, tp = jq.PTQ(), tq.PTQ()
    jp.quantize(jm)
    tp.quantize(tm)
    for a in cal:
        jm(paddle.to_tensor(a))
        tm(torch.from_numpy(a))
    js, ts = jp.activation_scales(), tp.activation_scales()
    assert sorted(ts) == sorted(js) == ["0", "2"]
    for k in js:
        assert ts[k] == pytest.approx(js[k], rel=1e-6)
    with pytest.raises(ValueError):
        tp.convert(_mlps(1)[1])
    jp.convert(jm)
    tp.convert(tm)
    for i in (0, 2):
        assert isinstance(tm[i], tq.QuantizedLinear)
        assert tm[i].activation_scale == pytest.approx(ts[str(i)])
        np.testing.assert_array_equal(tm[i].weight_quant.numpy(),
                                      np.asarray(jm[i].weight_quant.numpy()))
        assert not hasattr(tm[i], "_ptq_observed")
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), jm(paddle.to_tensor(x)).numpy(),
                               **VAL)
    # int8 weight-only: within the quantization error of the f32 model
    assert (out - ref).abs().max() < 0.15 * ref.abs().max() + 0.05


def test_ptq_on_gpt3_tiny_converts_the_parallel_projections():
    """The port's Column/RowParallelLinear are Linear subclasses: PTQ hooks
    and converts the 12 projections of gpt3_tiny, to the payloads of
    ptq_convert_for_serving. The JAX package's parallel layers are no
    nn.Linear, so its PTQ converts none (queue C)."""
    ids = np.random.default_rng(3).integers(0, 1024, (2, 16))
    m = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=0)
    ref = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=0)
    ptq = tq.PTQ()
    ptq.quantize(m)
    with torch.no_grad():
        m(torch.as_tensor(ids))
    ptq.convert(m)
    assert len(ptq.activation_scales()) == 12
    assert tq.ptq_convert_for_serving(ref) == 12
    got = {k: b for k, b in m.named_buffers()}
    want = {k: b for k, b in ref.named_buffers()}
    assert sorted(got) == sorted(want) and len(got) == 24
    for k in want:
        assert torch.equal(got[k], want[k]), k
    paddle.seed(0)
    jm = JaxGPT(jax_gpt3_tiny())
    jp = jq.PTQ()
    jp.quantize(jm)
    jm(paddle.to_tensor(ids))
    jp.convert(jm)
    assert jp.activation_scales() == {}
    assert not any(isinstance(s, jq.QuantizedLinear)
                   for _, s in jm.named_sublayers())


def test_qat_forward_and_grads_match_jax():
    jm, tm = _mlps(2)
    jq.QAT().quantize(jm)
    tq.QAT().quantize(tm)
    tq.QAT().quantize(tm)   # a second pass wraps nothing again
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    r = rng.normal(size=(4, 4)).astype(np.float32)
    w0 = tm[0].weight.detach().clone()
    jo = jm(paddle.to_tensor(x))
    (jo * paddle.to_tensor(r)).sum().backward()
    to = tm(torch.from_numpy(x))
    (to * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **VAL)
    assert isinstance(tm[0].weight, torch.nn.Parameter)
    assert torch.equal(tm[0].weight.detach(), w0)   # the stored weight
    for i in (0, 2):
        for name in ("weight", "bias"):
            np.testing.assert_allclose(
                getattr(tm[i], name).grad.numpy(),
                np.asarray(getattr(jm[i], name).grad.numpy()), **GRAD)
    # the forward saw the fake-quantized weight, not the stored one
    plain = torch.relu(torch.from_numpy(x) @ w0 + tm[0].bias) \
        @ tm[2].weight + tm[2].bias
    assert not torch.allclose(to, plain, rtol=0, atol=1e-7)
    assert list(dict(tm.named_parameters())) == ["0.weight", "0.bias",
                                                 "2.weight", "2.bias"]
