"""`nn.initializer` of the port held to `paddle_tpu`'s on the CPU:
`calculate_gain` and `_fans` exactly; the deterministic initializers
(`Constant`, `Assign`, `Dirac`) value for value; the random ones by
distribution (the two packages' generators give different numbers): the
draws' mean and standard deviation within 6 standard errors of the
distribution's, and of the reference's draws at the same shape, the
bounds held, `Orthogonal`'s Q^T Q the identity. Each fills its parameter
in place, on its device, from the generator given (the port's by default,
so `paddle.seed` repeats it), and the layers' defaults are the
reference's."""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.nn.initializer as RI
import paddle_tpu_torch as port
import paddle_tpu_torch.nn.initializer as PI
from paddle_tpu_torch.framework.core import Parameter

SIGMAS = 6.0
SHAPE = (256, 384)


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


GAINS = [("sigmoid", None), ("linear", None), ("conv1d", None),
         ("conv2d", None), ("conv3d", None), ("tanh", None), ("relu", None),
         ("leaky_relu", None), ("leaky_relu", 0.2), ("leaky_relu", 5 ** 0.5),
         ("selu", None)]


@pytest.mark.parametrize("name,param", GAINS)
def test_calculate_gain_exactly(name, param):
    assert PI.calculate_gain(name, param) == RI.calculate_gain(name, param)


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (8, 4, 3), (6, 2, 3, 5),
                                   (4, 4, 2, 2, 2)])
def test_fans_exactly(shape):
    assert PI._fans(shape) == RI._fans(shape)


def _ref_fill(init, shape):
    p = ref.create_parameter(list(shape), "float32")
    init(p)
    return np.asarray(p.numpy(), np.float64)


def _port_fill(init, shape, gen=None):
    p = Parameter(torch.empty(shape))
    ptr = p.data_ptr()
    out = init(p, generator=gen)
    assert out is p and p.data_ptr() == ptr
    return p.detach().double().numpy()


DETERMINISTIC = {
    "Constant": (lambda m: m.Constant(0.37), [SHAPE, (8, 4, 3, 3)]),
    "Assign": (lambda m: m.Assign(np.random.default_rng(0).normal(
        size=SHAPE).astype(np.float32)), [SHAPE]),
    "Dirac": (lambda m: m.Dirac(), [(8, 4, 3, 3), (6, 3, 5)]),
    "Dirac_groups": (lambda m: m.Dirac(groups=2), [(8, 4, 3, 3), (6, 3, 5)]),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_initializer_matches_reference(name):
    mk, shapes = DETERMINISTIC[name]
    for shape in shapes:
        np.testing.assert_array_equal(_port_fill(mk(PI), shape),
                                      _ref_fill(mk(RI), shape))


def test_assign_takes_a_tensor():
    p = Parameter(torch.empty(3, 4))
    PI.Assign(port.to_tensor(np.ones((3, 4), np.float32)))(p)
    assert bool((p == 1).all())


def _moments(x):
    return x.mean(), x.std()


# name: (port init, ref init, mean, std, bounds or None) at SHAPE
n_in, n_out = SHAPE
RANDOM = {
    "Normal": (PI.Normal(0.1, 0.5), RI.Normal(0.1, 0.5), 0.1, 0.5, None),
    "TruncatedNormal": (PI.TruncatedNormal(0.2, 0.3), RI.TruncatedNormal(
        0.2, 0.3), 0.2, 0.3 * 0.8796256610342398, (0.2 - 0.6, 0.2 + 0.6)),
    "Uniform": (PI.Uniform(-0.4, 0.8), RI.Uniform(-0.4, 0.8), 0.2,
                1.2 / math.sqrt(12), (-0.4, 0.8)),
    "XavierNormal": (PI.XavierNormal(), RI.XavierNormal(), 0.0,
                     math.sqrt(2 / (n_in + n_out)), None),
    "XavierNormal_fans": (PI.XavierNormal(10, 30, 2.0), RI.XavierNormal(
        10, 30, 2.0), 0.0, 2 * math.sqrt(2 / 40), None),
    "XavierUniform": (PI.XavierUniform(), RI.XavierUniform(), 0.0,
                      math.sqrt(6 / (n_in + n_out)) / math.sqrt(3),
                      (-math.sqrt(6 / (n_in + n_out)),
                       math.sqrt(6 / (n_in + n_out)))),
    "KaimingNormal": (PI.KaimingNormal(), RI.KaimingNormal(), 0.0,
                      math.sqrt(2) / math.sqrt(n_in), None),
    "KaimingUniform_leaky": (
        PI.KaimingUniform(negative_slope=0.2, nonlinearity="leaky_relu"),
        RI.KaimingUniform(negative_slope=0.2, nonlinearity="leaky_relu"),
        0.0, math.sqrt(2 / 1.04) * math.sqrt(3 / n_in) / math.sqrt(3),
        (-math.sqrt(2 / 1.04) * math.sqrt(3 / n_in),
         math.sqrt(2 / 1.04) * math.sqrt(3 / n_in))),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_initializer_by_distribution(name):
    pinit, rinit, mean, std, bounds = RANDOM[name]
    n = SHAPE[0] * SHAPE[1]
    se_mean, se_std = std / math.sqrt(n), std / math.sqrt(2 * n)
    gen = torch.Generator().manual_seed(3)
    got = _port_fill(pinit, SHAPE, gen)
    ref.seed(3)
    want = _ref_fill(rinit, SHAPE)
    for x in (got, want):
        m, s = _moments(x)
        assert abs(m - mean) <= SIGMAS * se_mean, (name, m, mean)
        assert abs(s - std) <= SIGMAS * se_std, (name, s, std)
    assert abs(got.mean() - want.mean()) <= 2 * SIGMAS * se_mean
    assert abs(got.std() - want.std()) <= 2 * SIGMAS * se_std
    if bounds is not None:
        assert got.min() >= bounds[0] - 1e-6 and got.max() <= bounds[1] + 1e-6
    # the same seed gives the same tensor; the default generator is the
    # port's, which paddle.seed sets
    again = _port_fill(pinit, SHAPE, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(got, again)
    port.seed(11)
    a = _port_fill(pinit, SHAPE)
    port.seed(11)
    np.testing.assert_array_equal(_port_fill(pinit, SHAPE), a)


@pytest.mark.parametrize("shape", [(64, 64), (32, 96), (96, 32), (8, 4, 3)])
def test_orthogonal(shape):
    got = _port_fill(PI.Orthogonal(gain=1.5), shape,
                     torch.Generator().manual_seed(1))
    want = _ref_fill(RI.Orthogonal(gain=1.5), shape)
    for x in (got, want):
        m = x.reshape(shape[0], -1)
        g = m @ m.T if shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(g / 1.5 ** 2, np.eye(len(g)), atol=1e-5)


def test_initializers_fill_low_precision_in_place():
    p = Parameter(torch.empty(64, 64, dtype=torch.bfloat16))
    for init in (PI.Normal(0, 1), PI.TruncatedNormal(), PI.Orthogonal(),
                 PI.XavierUniform()):
        init(p)
        assert p.dtype == torch.bfloat16 and torch.isfinite(p).all()


def test_layer_defaults_match_reference_rules():
    """Linear's weight is Xavier-uniform over [in, out], its bias zero;
    Embedding N(0, 1); a conv's weight Kaiming-uniform at a = sqrt(5)
    (bound 1 / sqrt(fan_in)); norms one and zero; `weight_std` gives
    N(0, std)."""
    port.seed(0)
    lin = port.nn.Linear(300, 500)
    lim = math.sqrt(6 / 800)
    w = lin.weight.detach().numpy()
    assert w.max() <= lim and w.min() >= -lim and w.std() > 0.9 * lim / 3 ** .5
    assert not lin.bias.detach().numpy().any()
    emb = port.nn.Embedding(400, 300).weight.detach().numpy()
    assert abs(emb.std() - 1) < 0.01 and abs(emb.mean()) < 0.01
    conv = port.nn.Conv2D(16, 32, 3).weight.detach().numpy()
    b = 1 / math.sqrt(16 * 9)
    assert conv.max() <= b + 1e-7 and conv.min() >= -b - 1e-7
    ln = port.nn.LayerNorm(8)
    assert bool((ln.weight == 1).all()) and not ln.bias.detach().numpy().any()
    std = port.nn.Linear(300, 500, weight_std=0.02).weight.detach().numpy()
    assert abs(std.std() - 0.02) < 1e-3
    vocab = port.distributed.fleet.layers.mpu.VocabParallelEmbedding(400, 300)
    v = vocab.weight.detach().numpy()
    assert abs(v.std() - math.sqrt(2 / 700)) < 2e-3


def test_create_parameter_takes_an_attribute():
    from paddle_tpu_torch import ParamAttr
    from paddle_tpu_torch.regularizer import L2Decay

    p = port.create_parameter([4, 3], "float32", attr=ParamAttr(
        initializer=PI.Constant(2.0), learning_rate=0.1,
        regularizer=L2Decay(0.5), need_clip=False, trainable=False))
    assert bool((p == 2).all()) and p.optimize_attr["learning_rate"] == 0.1
    assert p.regularizer._coeff == 0.5 and not p.need_clip
    assert p.stop_gradient
    q = port.create_parameter([4, 3], "float32", name="w", attr=PI.Uniform(
        -1e-3, 1e-3))
    assert q.name == "w" and float(q.abs().max()) <= 1e-3
    assert port.create_parameter([2], "float32", attr=False) is None
    b = port.create_parameter([5], "float32", is_bias=True)
    assert not b.detach().numpy().any()
