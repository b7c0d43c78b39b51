"""`nn.utils` and `nn.quant` of the port held to `paddle_tpu` on the CPU:
the reference's own cases of `tests/test_op_tail.py:272-310`
(`weight_norm` / `remove_weight_norm`, `spectral_norm`,
`parameters_to_vector` / `vector_to_parameters`, `clip_grad_norm_` /
`clip_grad_value_`) against the reference layer holding the same
weights; `weight_quantize`'s int8, int4 and grouped outputs bit for bit,
`weight_dequantize`, `weight_only_linear` and `llm_int8_linear` (f32,
rtol 1e-5); `quantize_for_inference` on gpt3_tiny with the reference's
weights carried across, its converted state bit for bit and its greedy
tokens equal to the reference's quantized model's through `generate`
and both of the port's engines; `convert.load_paddle_tpu_state` on the
new state (weight_g / weight_v, spectral norm's buffers, weight_quant /
weight_scale, PReLU's weight); and the refusal between the two int8
formats (`serve_w8`'s and `nn.quant`'s)."""

import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.models import GPTForCausalLM as RefGPT
from paddle_tpu.models import gpt3_tiny as ref_tiny
from paddle_tpu.models.generation import generate as ref_generate
from paddle_tpu.nn import quant as RQ
from paddle_tpu.nn import utils as RU
import paddle_tpu_torch as port
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.nn import quant as PQ
from paddle_tpu_torch.nn import utils as PU

rng = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _linears(i=8, o=6):
    ref.seed(0)
    rl = ref.nn.Linear(i, o)
    pl = port.nn.Linear(i, o)
    load_paddle_tpu_state(pl, _state(rl))
    return rl, pl


def _x(*shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# nn.utils
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_roundtrip(dim):
    rl, pl = _linears()
    x = _x(4, 8)
    base = pl(torch.from_numpy(x)).detach().numpy()
    RU.weight_norm(rl, dim=dim)
    PU.weight_norm(pl, dim=dim)
    assert sorted(pl.state_dict()) == sorted(rl.state_dict())
    for k, v in _state(rl).items():
        np.testing.assert_allclose(pl.state_dict()[k].numpy(), v, rtol=1e-6,
                                   err_msg=k)
    out = pl(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), base, rtol=1e-5,
                               atol=1e-6)
    rout = rl(ref.to_tensor(x))
    w = _x(4, 6)
    (rout * ref.to_tensor(w)).sum().backward()
    (out * torch.from_numpy(w)).sum().backward()
    for name in ("weight_g", "weight_v"):
        np.testing.assert_allclose(getattr(pl, name).grad.numpy(),
                                   getattr(rl, name).grad.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    PU.remove_weight_norm(pl)
    assert "weight_g" not in dict(pl.named_parameters())
    assert isinstance(pl.weight, torch.nn.Parameter)
    np.testing.assert_allclose(pl(torch.from_numpy(x)).detach().numpy(), base,
                               rtol=1e-5, atol=1e-6)


def test_spectral_norm_unit_singular_value_and_reference_state():
    """The reference's case: a weight times 10, five power iterations,
    five training forwards: the largest singular value is 1 within 0.05.
    The buffers start as the reference's bit for bit (no iteration), and
    each forward (the weight and the updated buffers) follows the
    reference's."""
    rl, pl = _linears()
    r0 = RU.spectral_norm(ref.nn.Linear(8, 6), n_power_iterations=0)
    p0 = PU.spectral_norm(port.nn.Linear(8, 6), n_power_iterations=0)
    for k in ("weight_u", "weight_v"):
        np.testing.assert_array_equal(p0.state_dict()[k].numpy(),
                                      _state(r0)[k])
    w10 = np.asarray(rl.weight.numpy()) * 10
    rl.weight.set_value(w10)
    with torch.no_grad():
        pl.weight.copy_(torch.from_numpy(w10))
    RU.spectral_norm(rl, n_power_iterations=5)
    PU.spectral_norm(pl, n_power_iterations=5)
    assert sorted(pl.state_dict()) == sorted(rl.state_dict())
    rl.train()
    pl.train()
    x = _x(4, 8)
    for _ in range(5):
        np.testing.assert_allclose(pl(torch.from_numpy(x)).detach().numpy(),
                                   rl(ref.to_tensor(x)).numpy(), rtol=1e-4,
                                   atol=1e-5)
    for k, v in _state(rl).items():
        np.testing.assert_allclose(pl.state_dict()[k].numpy(), v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    sv = np.linalg.svd(pl.weight.detach().numpy(), compute_uv=False).max()
    assert abs(sv - 1.0) < 0.05
    pl.eval()
    u = pl.weight_u.clone()
    pl(torch.from_numpy(x))
    assert torch.equal(pl.weight_u, u)


def test_vector_roundtrip_and_clip():
    _, pl = _linears(3, 2)
    vec = PU.parameters_to_vector(pl.parameters())
    assert vec.shape == (8,)
    np.testing.assert_array_equal(
        vec.detach().numpy(), np.concatenate([pl.weight.detach().numpy().ravel(),
                                              pl.bias.detach().numpy()]))
    PU.vector_to_parameters(port.to_tensor(np.zeros(8, np.float32)),
                            pl.parameters())
    assert np.abs(pl.weight.detach().numpy()).sum() == 0
    p = torch.ones(4, requires_grad=True)
    (p * torch.tensor([3.0, 4.0, 0.0, 0.0])).sum().backward()
    total = PU.clip_grad_norm_([p], 1.0)
    np.testing.assert_allclose(float(total), 5.0, rtol=1e-4)
    np.testing.assert_allclose(p.grad.numpy(), [0.6, 0.8, 0, 0], rtol=1e-4)
    PU.clip_grad_value_([p], 0.7)
    assert float(p.grad.max()) <= 0.7
    q = torch.ones(2, requires_grad=True)
    (q * float("inf")).sum().backward()
    with pytest.raises(RuntimeError, match="error_if_nonfinite"):
        PU.clip_grad_norm_([q], 1.0, error_if_nonfinite=True)


# --------------------------------------------------------------------------- #
# nn.quant
# --------------------------------------------------------------------------- #

QUANT = {"int8": ("weight_only_int8", -1), "int4": ("weight_only_int4", -1),
         "int8_g64": ("weight_only_int8", 64), "int8_g128":
         ("weight_only_int8", 128), "int4_g64": ("weight_only_int4", 64),
         "int4_g128": ("weight_only_int4", 128), "llm_int8": ("llm.int8", -1)}


def _weight():
    return (np.random.default_rng(7).standard_normal((256, 96)) * 0.05).astype(
        np.float32)


@pytest.mark.parametrize("name", sorted(QUANT))
def test_weight_quantize_bit_for_bit(name):
    algo, gs = QUANT[name]
    w = _weight()
    rq, rs = RQ.weight_quantize(ref.to_tensor(w), algo, group_size=gs)
    pq, ps = PQ.weight_quantize(torch.from_numpy(w), algo, group_size=gs)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq.numpy()))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs.numpy()))
    deq = "weight_only_int4" if "int4" in name else "weight_only_int8"
    np.testing.assert_allclose(
        PQ.weight_dequantize(pq, ps, deq, "float32").numpy(),
        RQ.weight_dequantize(rq, rs, deq, "float32").numpy(), rtol=1e-6)
    x, b = _x(5, 256), _x(96)
    if name == "llm_int8":
        x[:, 3] *= 30.0
        want = RQ.llm_int8_linear(ref.to_tensor(x), rq, ref.to_tensor(b), rs,
                                  threshold=6.0).numpy()
        got = PQ.llm_int8_linear(torch.from_numpy(x), pq, torch.from_numpy(b),
                                 ps, threshold=6.0)
    else:
        wd = "int4" if "int4" in name else "int8"
        want = RQ.weight_only_linear(ref.to_tensor(x), rq, ref.to_tensor(b),
                                     rs, wd).numpy()
        got = PQ.weight_only_linear(torch.from_numpy(x), pq,
                                    torch.from_numpy(b), ps, wd)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_weight_quantize_refuses_what_the_reference_refuses():
    w = torch.zeros(63, 8)
    with pytest.raises(ValueError, match="even"):
        PQ.weight_quantize(w, "weight_only_int4")
    with pytest.raises(ValueError, match="group_size"):
        PQ.weight_quantize(torch.zeros(64, 8), group_size=32)
    with pytest.raises(ValueError, match="algo"):
        PQ.weight_quantize(torch.zeros(64, 8), "fp8")


@pytest.fixture(scope="module")
def tiny_pair():
    ref.seed(0)
    rm = RefGPT(ref_tiny())
    state = _state(rm)
    return rm, state


PROMPT = np.array([5, 7, 11, 13], np.int32)


@pytest.mark.parametrize("algo,gs", [("weight_only_int8", -1),
                                     ("weight_only_int4", -1),
                                     ("weight_only_int8", 64)])
def test_quantize_for_inference_on_gpt3_tiny(tiny_pair, algo, gs):
    """Converted weights bit for bit; greedy tokens equal to the
    reference's quantized model through generate and through both of the
    port's engines; a converted state loads into a port model converted
    the same way."""
    _, state = tiny_pair
    rm = RefGPT(ref_tiny())
    rm.set_state_dict({k: ref.to_tensor(v) for k, v in state.items()})
    pm = GPTForCausalLM(gpt3_tiny(), device="cpu")
    load_paddle_tpu_state(pm, state)
    n_ref = RQ.quantize_for_inference(rm, algo, group_size=gs)
    n = PQ.quantize_for_inference(pm, algo, group_size=gs)
    assert n == n_ref > 0
    assert not any(k.endswith("q_proj.weight") for k, _ in pm.named_parameters())
    rstate = _state(rm)
    assert sorted(pm.state_dict()) == sorted(rstate)
    for k, v in rstate.items():
        got = pm.state_dict()[k].numpy()
        if "weight_quant" in k or "weight_scale" in k:
            np.testing.assert_array_equal(got, v, err_msg=k)
    want = ref_generate(rm, PROMPT[None], max_new_tokens=8,
                        temperature=0.0).numpy()[0]
    got = pm.generate(PROMPT[None], max_new_tokens=8,
                      temperature=0.0)[0].numpy()
    np.testing.assert_array_equal(got, want)
    reng = RefEngine(rm, max_batch_size=2, max_seq_len=48)
    reng.add_request(PROMPT, max_new_tokens=5, temperature=0.0)
    rdone = reng.run()[0].output_ids
    np.testing.assert_array_equal(rdone, want[:len(rdone)])
    for paged in (True, False):
        eng = create_serving_engine(pm, paged=paged, max_batch_size=2,
                                    max_seq_len=48)
        eng.add_request(PROMPT, max_new_tokens=5, temperature=0.0)
        done = eng.run()[0]
        np.testing.assert_array_equal(done.output_ids,
                                      want[:len(done.output_ids)])
    # the converted state carries across into a model converted the same way
    pm2 = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=5)
    PQ.quantize_for_inference(pm2, algo, group_size=gs)
    load_paddle_tpu_state(pm2, rstate)
    for k, v in rstate.items():
        np.testing.assert_array_equal(pm2.state_dict()[k].numpy(), v,
                                      err_msg=k)


def test_the_two_int8_formats_refuse_each_other():
    from paddle_tpu_torch.quantization import ptq_convert_for_serving

    m = GPTForCausalLM(gpt3_tiny(), device="cpu")
    ptq_convert_for_serving(m)
    with pytest.raises(ValueError, match="serve_w8"):
        PQ.quantize_for_inference(m)
    m = GPTForCausalLM(gpt3_tiny(), device="cpu")
    PQ.quantize_for_inference(m)
    with pytest.raises(ValueError, match="quantize_for_inference"):
        ptq_convert_for_serving(m)
    with pytest.raises(ValueError, match="quantize_for_inference"):
        create_serving_engine(m, max_batch_size=2, max_seq_len=32,
                              serve_w8=True)


def test_min_features_keeps_small_layers_float():
    m = port.nn.Sequential(port.nn.Linear(64, 32), port.nn.Linear(32, 64))
    assert PQ.quantize_for_inference(m, min_features=64) == 0
    assert PQ.quantize_for_inference(m, min_features=32) == 2
    assert m[0].weight is None and m[0].weight_quant.shape == (32, 64)


# --------------------------------------------------------------------------- #
# the new state through convert.load_paddle_tpu_state
# --------------------------------------------------------------------------- #

def test_load_carries_reparameterized_and_prelu_state():
    ref.seed(3)
    rw = RU.weight_norm(ref.nn.Linear(8, 6))
    rs = RU.spectral_norm(ref.nn.Linear(8, 6), n_power_iterations=2)
    rp = ref.nn.PReLU(4, init=0.1)
    rp.weight.set_value(np.arange(4, dtype=np.float32) / 10)
    for r, p in ((rw, PU.weight_norm(port.nn.Linear(8, 6))),
                 (rs, PU.spectral_norm(port.nn.Linear(8, 6),
                                       n_power_iterations=2)),
                 (rp, port.nn.PReLU(4))):
        load_paddle_tpu_state(p, _state(r))
        for k, v in _state(r).items():
            np.testing.assert_array_equal(p.state_dict()[k].numpy(), v,
                                          err_msg=k)
    x = _x(2, 4, 3)
    np.testing.assert_allclose(p(torch.from_numpy(x)).detach().numpy(),
                               rp(ref.to_tensor(x)).numpy(), rtol=1e-6)
