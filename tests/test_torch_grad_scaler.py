"""`amp.GradScaler`, `incubate.optimizer.LookAhead` / `ModelAverage` and the
fp16 state carried by `convert`, held against the JAX package on the CPU.

The scaler runs a scripted sequence beside the reference's (the pattern of
tests/test_nn.py:440-480) on an fp16 Linear decorated O2 with f32 master
weights: a good step, a planted inf (skipped, the scale backed off),
`unscale_` then the optimizer's global-norm clip then `step` (no second
unscale), a double `unscale_` and a double `step` raising, and
`incr_every_n_steps` reached (the scale doubled); scale, good and bad
counts, the skip flag and the parameters are held step for step, and
`state_dict` is the reference's plain dict, whose scale and counts load
in either package. LookAhead
(k = 3) and ModelAverage (a window that restarts) follow the reference's
trajectories under SGD over six steps."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.incubate.optimizer as jinc
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import (load_paddle_tpu_opt_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch.incubate import optimizer as tinc
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt3_tiny)
from paddle_tpu_torch.optimizer import SGD, AdamW

RNG = np.random.default_rng(5)
W = (RNG.standard_normal((4, 3)) * 0.5).astype(np.float32)
B = (RNG.standard_normal(3) * 0.1).astype(np.float32)
XS = [RNG.standard_normal((2, 4)).astype(np.float32) for _ in range(6)]
# an fp16 parameter moved by SGD from its f32 master: both packages round
# the same master to fp16, the masters agree to f32 rounding: one fp16 ulp
F16_TOL = dict(rtol=2 ** -10, atol=1e-6)


def _nets(dtype=None):
    """The JAX and the port Linear(4, 3) holding W and B, each decorated O2
    to `dtype` with its SGD (lr 0.1, a global-norm clip at 0.5) made
    multi-precision."""
    jnet = jnn.Linear(4, 3)
    jnet.weight.set_value(W)
    jnet.bias.set_value(B)
    jo = jopt.SGD(learning_rate=0.1, parameters=jnet.parameters(),
                  grad_clip=jnn.ClipGradByGlobalNorm(0.5))
    tnet = pnn.Linear(4, 3, device="cpu")
    with torch.no_grad():
        tnet.weight.copy_(torch.from_numpy(W))
        tnet.bias.copy_(torch.from_numpy(B))
    to = SGD(learning_rate=0.1, parameters=tnet.parameters(),
             grad_clip=pnn.ClipGradByGlobalNorm(0.5))
    if dtype is not None:
        jamp.decorate(jnet, jo, level="O2", dtype=dtype)
        amp.decorate(tnet, to, level="O2", dtype=dtype)
    return jnet, jo, tnet, to


def _state(scaler):
    return (scaler._scale, scaler._good_steps, scaler._bad_steps,
            bool(scaler._found_inf))


def test_grad_scaler_follows_the_reference_step_for_step():
    jnet, jo, tnet, to = _nets("float16")
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    js, ts = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    assert ts.is_enable() and ts.is_use_dynamic_loss_scaling()
    assert ts.get_init_loss_scaling() == js.get_init_loss_scaling()
    states = []
    for i, action in enumerate(["good", "inf", "unscale_clip", "good"]):
        x = XS[i]
        js.scale((jnet(paddle.to_tensor(x)) ** 2).sum()).backward()
        ts.scale((tnet(torch.from_numpy(x)) ** 2).sum()).backward()
        if action == "inf":
            jnet.weight.grad._value = jnet.weight.grad._value.at[0, 0].set(
                np.inf)
            tnet.weight.grad[0, 0] = float("inf")
        if action == "unscale_clip":
            js.unscale_(jo)
            ts.unscale_(to)
            np.testing.assert_allclose(tnet.weight.grad.float().numpy(),
                                       np.asarray(jnet.weight.grad.numpy(),
                                                  np.float32), **F16_TOL)
            with pytest.raises(RuntimeError):
                ts.unscale_(to)
            with pytest.raises(RuntimeError):
                js.unscale_(jo)
        before = tnet.weight.detach().clone()
        js.step(jo)
        ts.step(to)
        if action == "unscale_clip":
            with pytest.raises(RuntimeError):
                ts.step(to)
            with pytest.raises(RuntimeError):
                js.step(jo)
        js.update()
        ts.update()
        jo.clear_grad()
        to.clear_grad()
        assert _state(ts) == _state(js), (action, _state(ts), _state(js))
        states.append(_state(ts))
        if action == "inf":
            assert torch.equal(tnet.weight.detach(), before)  # skipped
        assert tnet.weight.dtype == torch.float16
        for t, j in ((tnet.weight, jnet.weight), (tnet.bias, jnet.bias)):
            np.testing.assert_allclose(t.detach().float().numpy(),
                                       np.asarray(j.numpy(), np.float32),
                                       **F16_TOL)
    # 1024, backed off to 512 by the inf, doubled after two good steps
    assert [s[0] for s in states] == [1024.0, 512.0, 512.0, 1024.0]
    sd = ts.state_dict()
    assert sd == js.state_dict()
    assert all(isinstance(v, (bool, int, float)) for v in sd.values())
    # load_state_dict restores the scale and the counts (the ratios and
    # periods are the constructor's), in either direction
    moving = ("scale", "incr_count", "decr_count")
    fresh = amp.GradScaler()
    fresh.load_state_dict(js.state_dict())
    back = jamp.GradScaler()
    back.load_state_dict(sd)
    for got in (fresh.state_dict(), back.state_dict()):
        assert {k: got[k] for k in moving} == {k: sd[k] for k in moving}


def test_a_disabled_or_static_scaler_is_the_reference_s():
    """enable=False steps without scaling; use_dynamic_loss_scaling=False
    skips a non-finite step but keeps its scale, as the reference."""
    for kw in (dict(enable=False), dict(use_dynamic_loss_scaling=False)):
        jnet, jo, tnet, to = _nets()
        js, ts = jamp.GradScaler(**kw), amp.GradScaler(**kw)
        for i in range(2):
            js.scale((jnet(paddle.to_tensor(XS[i])) ** 2).sum()).backward()
            ts.scale((tnet(torch.from_numpy(XS[i])) ** 2).sum()).backward()
            if i == 1:
                jnet.bias.grad._value = jnet.bias.grad._value.at[0].set(np.nan)
                tnet.bias.grad[0] = float("nan")
            js.step(jo)
            ts.step(to)
            js.update()
            ts.update()
            jo.clear_grad()
            to.clear_grad()
            assert ts._scale == js._scale
            np.testing.assert_allclose(tnet.weight.detach().numpy(),
                                       jnet.weight.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_support_queries():
    assert amp.is_float16_supported() and amp.is_bfloat16_supported()
    assert jamp.is_float16_supported() and jamp.is_bfloat16_supported()


def test_lookahead_follows_the_reference():
    jnet, jo, tnet, to = _nets()
    jla = jinc.LookAhead(jo, alpha=0.4, k=3)
    tla = tinc.LookAhead(to, alpha=0.4, k=3)
    for i, x in enumerate(XS):
        (jnet(paddle.to_tensor(x)) ** 2).sum().backward()
        jla.step()
        jla.clear_grad()
        (tnet(torch.from_numpy(x)) ** 2).sum().backward()
        tla.step()
        tla.clear_grad()
        np.testing.assert_allclose(tnet.weight.detach().numpy(),
                                   jnet.weight.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"step {i}")
    sd = tla.state_dict()
    assert sd["@lookahead_step"] == 6 and len(sd["@lookahead_slow"]) == 2
    again = tinc.LookAhead(to, alpha=0.4, k=3)
    again.set_state_dict(sd)
    assert again._step_count == 6
    with pytest.raises(ValueError):
        tinc.LookAhead(to, alpha=1.5)


def test_model_average_follows_the_reference():
    """A window of min 2, max 3 steps at rate 0.5: the sum restarts after
    the third step; apply() swaps the average in, restore() (or leaving
    the block) the trained weights back."""
    jnet, jo, tnet, to = _nets()
    kw = dict(min_average_window=2, max_average_window=3)
    jma = jinc.ModelAverage(0.5, parameters=jnet.parameters(), **kw)
    tma = tinc.ModelAverage(0.5, parameters=list(tnet.parameters()), **kw)
    for i, x in enumerate(XS):
        (jnet(paddle.to_tensor(x)) ** 2).sum().backward()
        jo.step()
        jo.clear_grad()
        jma.step()
        (tnet(torch.from_numpy(x)) ** 2).sum().backward()
        to.step()
        to.clear_grad()
        tma.step()
        assert tma._num == jma._num, i
        trained = tnet.weight.detach().clone()
        with tma.apply():
            jma.apply()
            np.testing.assert_allclose(tnet.weight.detach().numpy(),
                                       jnet.weight.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i}")
            jma.restore()
        assert torch.equal(tnet.weight.detach(), trained)


def test_convert_carries_fp16_parameters_and_moments():
    """A JAX O2 fp16 model's state and its TrainStep's AdamW state (fp16
    moments, f32 masters) into the port, then one more step in each
    package: the same losses and parameters."""
    import paddle_tpu.models as jm

    from paddle_tpu.jit import TrainStep as JaxTrainStep

    paddle.seed(0)
    jmodel = jm.GPTForCausalLM(jm.gpt3_tiny())
    jamp.decorate(jmodel, level="O2", dtype="float16")
    jcrit = jm.GPTPretrainingCriterion()
    jopt_ = jopt.AdamW(learning_rate=1e-3, moment_dtype="float16",
                       parameters=jmodel.parameters(), multi_precision=True)
    jstep = JaxTrainStep(jmodel, lambda lg, lb: jcrit(lg, lb), jopt_,
                         amp_level="O2", amp_dtype="float16")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1024, (2, 16))
    jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
    jstep.sync_weights()
    state = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    opt_state = {k: {n: np.asarray(a) for n, a in st.items()}
                 for k, st in jstep.opt_states.items()}
    assert any(a.dtype == np.float16 for a in state.values())
    tmodel = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=3)
    amp.decorate(tmodel, level="O2", dtype="float16")
    load_paddle_tpu_state(tmodel, state)
    topt = AdamW(learning_rate=1e-3, moment_dtype="float16",
                 parameters=tmodel.parameters(), multi_precision=True)
    tcrit = GPTPretrainingCriterion()
    tstep = TrainStep(tmodel, lambda lg, lb: tcrit(lg, lb), topt,
                      amp_level="O2", amp_dtype="float16")
    load_paddle_tpu_opt_state(topt, opt_state, 1)
    for k, v in tmodel.state_dict().items():
        assert v.dtype == getattr(torch, str(state[k].dtype)), k
        np.testing.assert_array_equal(v.numpy(), state[k])
    st = next(iter(tstep.opt_states.values()))
    assert st["m"].dtype == st["v"].dtype == torch.float16
    assert st["master"].dtype == torch.float32
    jl = float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids)))
    tl = tstep(ids, ids).item()
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
