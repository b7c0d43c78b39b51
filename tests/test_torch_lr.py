"""The port's learning-rate schedulers (`optimizer.lr`, a copy of the JAX
package's) held to the reference's over 60 steps, one case a class (the
base `LRScheduler` through a subclass that defines only `get_lr`),
`ReduceOnPlateau` fed a fixed sequence of metrics; a `state_dict`
round-trip; and an AdamW on a scheduler through the port's `jit.TrainStep`
against the reference's eager step, each step's rate read anew."""

import math

import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import lr as plr
from test_torch_optimizers import _data, _held, _jax_loss, _pair

STEPS = 60


def _half(epoch):
    return 0.5 ** (epoch // 7)


def _shrink(epoch):
    return 0.97


def _scale(cycle):
    return 1.0 / cycle


# class name -> (keyword arguments, wrapped scheduler's or None)
CASES = {
    "LRScheduler": ({"learning_rate": 0.3}, None),
    "NoamDecay": ({"d_model": 64, "warmup_steps": 10, "learning_rate": 2.0},
                  None),
    "PiecewiseDecay": ({"boundaries": [5, 20, 40],
                        "values": [0.1, 0.05, 0.01, 0.001]}, None),
    "NaturalExpDecay": ({"learning_rate": 0.5, "gamma": 0.1}, None),
    "InverseTimeDecay": ({"learning_rate": 0.5, "gamma": 0.2}, None),
    "PolynomialDecay": ({"learning_rate": 0.1, "decay_steps": 25,
                         "end_lr": 0.001, "power": 2.0, "cycle": True}, None),
    "LinearWarmup": ({"warmup_steps": 10, "start_lr": 0.0, "end_lr": 0.1},
                     ("PolynomialDecay", {"learning_rate": 0.1,
                                          "decay_steps": 30})),
    "ExponentialDecay": ({"learning_rate": 0.5, "gamma": 0.9}, None),
    "MultiStepDecay": ({"learning_rate": 0.5, "milestones": [10, 30, 45],
                        "gamma": 0.3}, None),
    "StepDecay": ({"learning_rate": 0.5, "step_size": 9, "gamma": 0.5}, None),
    "LambdaDecay": ({"learning_rate": 0.5, "lr_lambda": _half}, None),
    "ReduceOnPlateau": ({"learning_rate": 1.0, "factor": 0.5, "patience": 3,
                         "cooldown": 2, "min_lr": 0.01}, None),
    "CosineAnnealingDecay": ({"learning_rate": 0.2, "T_max": 17,
                              "eta_min": 0.01}, None),
    "MultiplicativeDecay": ({"learning_rate": 0.5, "lr_lambda": _shrink},
                            None),
    "OneCycleLR": ({"max_learning_rate": 0.5, "total_steps": 50,
                    "three_phase": False}, None),
    "CyclicLR": ({"base_learning_rate": 0.01, "max_learning_rate": 0.1,
                  "step_size_up": 6, "step_size_down": 4,
                  "scale_fn": _scale}, None),
    "LinearLR": ({"learning_rate": 0.5, "total_steps": 40,
                  "start_factor": 0.1, "end_factor": 1.0}, None),
    "CosineAnnealingWarmRestarts": ({"learning_rate": 0.2, "T_0": 5,
                                     "T_mult": 2, "eta_min": 0.001}, None),
}


def _metrics():
    """Falls, then a plateau with noise, then falls again."""
    rng = np.random.default_rng(5)
    m = np.concatenate([np.linspace(2.0, 1.0, 15), 1.0 + 0.01 *
                        rng.standard_normal(30), np.linspace(0.9, 0.5, 15)])
    return [float(v) for v in m]


def _make(mod, name):
    kw, inner = CASES[name]
    if name == "LRScheduler":
        class Const(mod.LRScheduler):
            def get_lr(self):
                return self.base_lr * (1 + self.last_epoch % 3)
        return Const(**kw)
    kw = dict(kw)
    if inner is not None:
        kw["learning_rate"] = getattr(mod, inner[0])(**inner[1])
    return getattr(mod, name)(**kw)


def _run(sched, name):
    rates = [sched()]
    for i in range(STEPS):
        if name == "ReduceOnPlateau":
            sched.step(_metrics()[i])
        else:
            sched.step()
        rates.append(sched())
    return rates


def test_every_class_is_a_case():
    assert sorted(CASES) == sorted(plr.__all__) == sorted(jlr.__all__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax(name):
    got = _run(_make(plr, name), name)
    want = _run(_make(jlr, name), name)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert len(set(got)) > 1, name   # the schedule moves


def test_state_dict_round_trip():
    a = _make(plr, "LinearWarmup")
    for _ in range(13):
        a.step()
    b = _make(plr, "LinearWarmup")
    b.set_state_dict(a.state_dict())
    assert b.last_epoch == 13 and b() == a()
    p = _make(plr, "ReduceOnPlateau")
    for m in _metrics()[:30]:
        p.step(m)
    q = _make(plr, "ReduceOnPlateau")
    q.set_state_dict(p.state_dict())
    for m in _metrics()[30:]:
        p.step(torch.tensor(m))
        q.step(m)
        assert p() == q()
    assert math.isclose(p(), _run(_make(jlr, "ReduceOnPlateau"),
                                  "ReduceOnPlateau")[-1])


def test_scheduled_adamw_through_train_step_matches_eager_jax():
    def sched(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(0.05, T_max=4),
                                warmup_steps=2, start_lr=0.0, end_lr=0.05)

    jm, tm = _pair(3)
    js, ts = sched(jlr), sched(plr)
    jo = jopt.AdamW(learning_rate=js, parameters=jm.parameters())
    opt = popt.AdamW(learning_rate=ts, parameters=tm.parameters())
    step = TrainStep(tm, lambda o, t: ((o - t) ** 2).mean(), opt)
    x, y = _data()
    used = []
    for _ in range(5):
        _jax_loss(jm, x, y).backward()
        jo.step()
        jo.clear_grad()
        used.append(opt.get_lr())
        step(x, y)
        js.step()
        ts.step()
    assert used == _run(sched(plr), "LinearWarmup")[:5]
    assert used[0] == 0.0 and len(set(used)) == 4
    _held(tm, jm, "scheduled AdamW")
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    opt.set_lr_scheduler(plr.StepDecay(0.2, step_size=1))
    assert opt.get_lr() == 0.2
