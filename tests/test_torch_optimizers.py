"""The port's optimizers (`optimizer.Adamax`, `Adagrad`, `Adadelta`,
`RMSProp`, `Lamb`, `Lars`, `NAdam`, `RAdam`, `Rprop`, `ASGD` and
`LBFGS`) held to the JAX package's eager `step()` in f32 on a small MLP,
from the same weights (`convert.load_paddle_tpu_state`) and batch; and
AdamW's `apply_decay_param_fun` through the port's `jit.TrainStep`
against the reference's eager `step()`, which honours it, with the
reference's compiled `TrainStep`, which decays every parameter, as the
control that must differ (ROADMAP queue C)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.jit import TrainStep

IN, HID, OUT, B = 8, 16, 4, 12
TOL = dict(rtol=1e-5, atol=1e-6)

# name -> (class name, keyword arguments, steps)
CASES = {
    "Adamax": ("Adamax", dict(learning_rate=0.01, weight_decay=0.01), 3),
    "Adagrad": ("Adagrad", dict(learning_rate=0.1, weight_decay=0.01,
                                initial_accumulator_value=0.1), 3),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0, weight_decay=0.01), 3),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, momentum=0.9,
                                weight_decay=0.01), 3),
    "RMSProp_centered": ("RMSProp", dict(learning_rate=0.01, centered=True),
                         3),
    "Lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01), 3),
    "Lars": ("Lars", dict(learning_rate=0.5, lars_coeff=0.01), 3),
    "NAdam": ("NAdam", dict(learning_rate=0.01, weight_decay=0.01), 3),
    # eight steps: rho_t passes 5 at step 6, so both branches run
    "RAdam": ("RAdam", dict(learning_rate=0.01, beta2=0.99,
                            weight_decay=0.01), 8),
    "Rprop": ("Rprop", dict(learning_rate=0.01), 3),
    "ASGD": ("ASGD", dict(learning_rate=0.05, batch_num=2,
                          weight_decay=0.01), 3),
}


class _JaxMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = jnn.Linear(IN, HID)
        self.l2 = jnn.Linear(HID, OUT)

    def forward(self, x):
        return self.l2(jnn.functional.tanh(self.l1(x)))


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = pnn.Linear(IN, HID, device="cpu")
        self.l2 = pnn.Linear(HID, OUT, device="cpu")

    def forward(self, x):
        return self.l2(torch.tanh(self.l1(x)))


def _data():
    rng = np.random.default_rng(4)
    return (rng.normal(size=(B, IN)).astype(np.float32),
            rng.normal(size=(B, OUT)).astype(np.float32))


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _pair(seed=0):
    paddle.seed(seed)
    jm = _JaxMLP()
    return jm, load_paddle_tpu_state(_MLP(), _state(jm))


def _jax_loss(jm, x, y):
    return ((jm(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()


def _port_loss(tm, x, y):
    return ((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


def _held(tm, jm, what):
    want = _state(jm)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], err_msg=f"{what}: {k}",
                                   **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_steps_match_jax(case):
    cls, kw, steps = CASES[case]
    jm, tm = _pair()
    jo = getattr(jopt, cls)(parameters=jm.parameters(), **kw)
    to = getattr(popt, cls)(parameters=tm.parameters(), **kw)
    x, y = _data()
    for i in range(steps):
        jl = _jax_loss(jm, x, y)
        jl.backward()
        jo.step()
        jo.clear_grad()
        tl = _port_loss(tm, x, y)
        tl.backward()
        to.step()
        to.clear_grad()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5,
                                   err_msg=f"{case} loss {i}")
    _held(tm, jm, case)
    # the parameters moved: a rule that did nothing would pass the hold
    # only if the reference's did nothing too
    paddle.seed(0)
    start = _state(_JaxMLP())
    assert any(np.abs(v.numpy() - start[k]).max() > 1e-4
               for k, v in tm.state_dict().items()), case


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    jm, tm = _pair(1)
    kw = dict(learning_rate=1.0, max_iter=4, history_size=5,
              line_search_fn=line_search)
    jo = jopt.LBFGS(parameters=jm.parameters(), **kw)
    to = popt.LBFGS(parameters=tm.parameters(), **kw)
    x, y = _data()

    def jclosure():
        jo.clear_grad()
        loss = _jax_loss(jm, x, y)
        loss.backward()
        return loss

    def tclosure():
        to.clear_grad()
        loss = _port_loss(tm, x, y)
        loss.backward()
        return loss

    first = _port_loss(tm, x, y).item()
    for i in range(3):
        jl = float(jo.step(jclosure))
        tl = float(to.step(tclosure))
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"step {i}")
    assert tl < 0.8 * first
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), _state(jm)[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _no_bias(name):
    return "bias" not in name


def test_adamw_decay_filter_through_train_step_matches_eager_jax():
    """The port's TrainStep calls the filter with each parameter's
    state_dict name; the reference's eager step with `p.name`, which its
    layers leave None: the test names them. The reference's compiled step
    decays every parameter: it is the control that must differ."""
    kw = dict(learning_rate=0.05, weight_decay=0.5,
              apply_decay_param_fun=_no_bias)
    jm, tm = _pair(2)
    for k, p in jm.named_parameters():
        p.name = k
    jo = jopt.AdamW(parameters=jm.parameters(), **kw)
    step = TrainStep(tm, lambda o, t: ((o - t) ** 2).mean(),
                     popt.AdamW(parameters=tm.parameters(), **kw))
    x, y = _data()
    for _ in range(3):
        _jax_loss(jm, x, y).backward()
        jo.step()
        jo.clear_grad()
        step(x, y)
    _held(tm, jm, "filtered decay")
    # the eager port step, given the parameters with their names
    jm2, tm2 = _pair(2)
    eager = popt.AdamW(parameters=tm2.named_parameters(), **kw)
    for _ in range(3):
        _port_loss(tm2, x, y).backward()
        eager.step()
        eager.clear_grad()
    _held(tm2, jm, "eager filtered decay")

    jm3, _ = _pair(2)
    jstep = JaxTrainStep(jm3, lambda o, t: ((o - t) ** 2).mean(),
                         jopt.AdamW(parameters=jm3.parameters(), **kw))
    for _ in range(3):
        jstep(paddle.to_tensor(x), paddle.to_tensor(y))
    jstep.sync_weights()
    compiled = _state(jm3)
    gap = max(np.abs(v.numpy() - compiled[k]).max()
              for k, v in tm.state_dict().items() if "bias" in k)
    assert gap > 1e-3, gap


def test_options_the_reference_ignores_raise():
    params = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(NotImplementedError, match="queue C"):
        popt.Lamb(parameters=params, exclude_from_weight_decay_fn=_no_bias)
    with pytest.raises(NotImplementedError, match="queue C"):
        popt.Lars(parameters=params, exclude_from_weight_decay=["bias"])
    with pytest.raises(NotImplementedError, match="queue C"):
        popt.AdamW(parameters=params, lr_ratio=lambda p: 0.5)
    with pytest.raises(ValueError, match="grad_clip"):
        popt.LBFGS(parameters=params, grad_clip=pnn.ClipGradByGlobalNorm(1.0))
