"""The port's autograd against paddle_tpu's tape: the 33 tests of
tests/test_autograd.py (chains, accumulation, hooks, PyLayer, paddle.grad,
second order, vjp / jvp / jacobian / hessian, save/load and the setitem
cases), each run in both packages on the same inputs (`mirrored`): the
assertions hold in each, and the gradients each returns agree."""

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


def tensor(paddle, a, sg=False):
    t = paddle.to_tensor(np.asarray(a, np.float32))
    t.stop_gradient = sg
    return t


def mirrored(body):
    """A test running `body(paddle)` in both packages; the arrays they
    return must agree."""
    def test(tmp_path):
        got = {}
        for pkg in (ref, port):
            out = body(pkg, tmp_path / pkg.__name__) if \
                body.__code__.co_argcount == 2 else body(pkg)
            got[pkg.__name__] = [np.asarray(a) for a in (out or [])]
        assert len(got["paddle_tpu"]) == len(got["paddle_tpu_torch"])
        for a, b in zip(got["paddle_tpu"], got["paddle_tpu_torch"]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)

    test.__name__ = body.__name__
    return test


# --------------------------------------------------------------------------- #
# backward
# --------------------------------------------------------------------------- #

@mirrored
def test_simple_chain(paddle):
    x = tensor(paddle, [2.0, 3.0])
    (x * x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 6.0], rtol=1e-6)
    return [x.grad.numpy()]


@mirrored
def test_branching_graph(paddle):
    x = tensor(paddle, [1.0, 2.0])
    a = x * 2
    b = x * 3
    (a * b).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [12.0, 24.0], rtol=1e-6)
    return [x.grad.numpy()]


@mirrored
def test_matmul_grad(paddle):
    rng = np.random.RandomState(0)
    a = rng.rand(3, 4).astype(np.float32)
    b = rng.rand(4, 2).astype(np.float32)
    ta, tb = tensor(paddle, a), tensor(paddle, b)
    paddle.matmul(ta, tb).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.ones((3, 2)) @ b.T, rtol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), a.T @ np.ones((3, 2)), rtol=1e-4)
    return [ta.grad.numpy(), tb.grad.numpy()]


@mirrored
def test_grad_accumulation(paddle):
    x = tensor(paddle, [1.0, 1.0])
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0, 5.0])
    g = x.grad.numpy()
    x.clear_grad()
    assert x.grad is None
    return [g]


@mirrored
def test_stop_gradient(paddle):
    x = tensor(paddle, [1.0])
    y = tensor(paddle, [2.0], sg=True)
    (x * y).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0])
    assert y.grad is None
    return [x.grad.numpy()]


@mirrored
def test_detach(paddle):
    x = tensor(paddle, [3.0])
    d = (x * 2).detach()
    assert d.stop_gradient
    (x * d).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0])
    return [x.grad.numpy()]


@mirrored
def test_no_grad(paddle):
    x = tensor(paddle, [1.0])
    with paddle.no_grad():
        y = x * 5
    assert y.stop_gradient
    assert y.is_leaf if paddle is port else y._grad_node is None


@mirrored
def test_multi_output_op(paddle):
    x = tensor(paddle, np.arange(6, dtype=np.float32).reshape(2, 3))
    a, b = paddle.split(x, 2, axis=0)
    (a.sum() * 2 + b.sum() * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [[2, 2, 2], [3, 3, 3]])
    return [x.grad.numpy()]


@mirrored
def test_backward_nonscalar_raises(paddle):
    x = tensor(paddle, [1.0, 2.0])
    with pytest.raises(RuntimeError):
        (x * 2).backward()


@mirrored
def test_backward_with_grad_tensor(paddle):
    x = tensor(paddle, [1.0, 2.0])
    (x * x).backward(paddle.to_tensor([1.0, 0.5]))
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])
    return [x.grad.numpy()]


@mirrored
def test_hook(paddle):
    x = tensor(paddle, [1.0])
    seen = []
    x.register_hook(lambda g: seen.append(g.numpy()[0]))
    (x * 4).sum().backward()
    assert seen == [4.0]


@mirrored
def test_hook_modifies_grad(paddle):
    x = tensor(paddle, [1.0])
    x.register_hook(lambda g: g * 10)
    (x * 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [20.0])
    return [x.grad.numpy()]


@mirrored
def test_nonlinear_vs_fd(paddle):
    a = np.random.RandomState(1).rand(5).astype(np.float32) + 0.5

    def f(v):
        return float(np.sum(np.tanh(v) * np.exp(v * 0.5)))

    x = tensor(paddle, a)
    (paddle.tanh(x) * paddle.exp(x * 0.5)).sum().backward()
    eps = 1e-3
    for i in range(5):
        ap, am = a.copy(), a.copy()
        ap[i] += eps
        am[i] -= eps
        np.testing.assert_allclose(x.grad.numpy()[i],
                                   (f(ap) - f(am)) / (2 * eps), rtol=1e-2)
    return [x.grad.numpy()]


# --------------------------------------------------------------------------- #
# paddle.grad, PyLayer, functional AD
# --------------------------------------------------------------------------- #

@mirrored
def test_paddle_grad(paddle):
    x = tensor(paddle, [2.0])
    (gx,) = paddle.grad(x * x * x, [x])
    np.testing.assert_allclose(gx.numpy(), [12.0], rtol=1e-5)
    assert x.grad is None  # paddle.grad must not touch .grad
    return [gx.numpy()]


@mirrored
def test_grad_unused(paddle):
    x = tensor(paddle, [1.0])
    z = tensor(paddle, [1.0])
    gx, gz = paddle.grad((x * 2).sum(), [x, z], allow_unused=True)
    assert gz is None
    return [gx.numpy()]


def _pylayers(paddle):
    PyLayer = paddle.autograd.PyLayer

    class Double(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    class FakeGrad(PyLayer):
        @staticmethod
        def forward(ctx, x):
            return paddle.exp(x)

        @staticmethod
        def backward(ctx, g):
            return g * 0 + 7

    class MulAdd(PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a * b, a + b

        @staticmethod
        def backward(ctx, ga, gb):
            a, b = ctx.saved_tensor()
            return ga * b + gb, ga * a + gb

    return Double, FakeGrad, MulAdd


@mirrored
def test_custom_forward_backward(paddle):
    Double, _, _ = _pylayers(paddle)
    x = tensor(paddle, [3.0])
    y = Double.apply(x)
    np.testing.assert_allclose(y.numpy(), [6.0])
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0])
    return [y.numpy(), x.grad.numpy()]


@mirrored
def test_custom_grad_override(paddle):
    _, FakeGrad, _ = _pylayers(paddle)
    x = tensor(paddle, [0.0])
    FakeGrad.apply(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [7.0])
    return [x.grad.numpy()]


@mirrored
def test_multi_io(paddle):
    _, _, MulAdd = _pylayers(paddle)
    a, b = tensor(paddle, [2.0]), tensor(paddle, [5.0])
    p, s = MulAdd.apply(a, b)
    (p.sum() + s.sum()).backward()
    np.testing.assert_allclose(a.grad.numpy(), [6.0])
    np.testing.assert_allclose(b.grad.numpy(), [3.0])
    return [a.grad.numpy(), b.grad.numpy()]


@mirrored
def test_vjp(paddle):
    x = tensor(paddle, [1.0, 2.0])
    out, g = paddle.autograd.vjp(lambda v: (v * v).sum(), x)
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0])
    return [out.numpy(), g.numpy()]


@mirrored
def test_jvp(paddle):
    x = tensor(paddle, [1.0, 2.0])
    out, t = paddle.autograd.jvp(lambda v: (v * v).sum(), x)
    np.testing.assert_allclose(t.numpy(), 6.0, rtol=1e-6)
    return [out.numpy(), t.numpy()]


@mirrored
def test_jacobian(paddle):
    x = tensor(paddle, [1.0, 2.0])
    j = paddle.autograd.jacobian(lambda v: v * v, x)
    np.testing.assert_allclose(j.numpy(), np.diag([2.0, 4.0]))
    return [j.numpy()]


@mirrored
def test_hessian(paddle):
    x = tensor(paddle, [1.0, 2.0])
    h = paddle.autograd.hessian(lambda v: (v * v * v).sum(), x)
    np.testing.assert_allclose(h.numpy(), np.diag([6.0, 12.0]), atol=1e-5)
    return [h.numpy()]


@mirrored
def test_save_load_roundtrip(paddle, tmp_path):
    paddle.seed(0)
    obj = {"w": paddle.randn([3, 3]), "step": 7, "nested": {"b": paddle.ones([2])}}
    p = str(tmp_path / "ckpt.pdparams")
    paddle.save(obj, p)
    back = paddle.load(p)
    np.testing.assert_array_equal(back["w"].numpy(), obj["w"].numpy())
    assert back["step"] == 7
    np.testing.assert_array_equal(back["nested"]["b"].numpy(), [1, 1])
    return [back["nested"]["b"].numpy()]


# --------------------------------------------------------------------------- #
# in place, intermediates, second order
# --------------------------------------------------------------------------- #

@mirrored
def test_setitem_on_intermediate_keeps_grad(paddle):
    x = tensor(paddle, [1.0, 2.0, 3.0])
    y = x * 2
    y[0] = 5.0
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 2.0, 2.0])
    return [x.grad.numpy(), y.numpy()]


@mirrored
def test_setitem_on_leaf_requiring_grad_raises(paddle):
    x = tensor(paddle, [1.0, 2.0, 3.0])
    with pytest.raises(RuntimeError):
        x[0] = 5.0


@mirrored
def test_grad_wrt_intermediate(paddle):
    a = tensor(paddle, [2.0])
    h = a * 3
    gh = paddle.grad((h * h).sum(), h)
    np.testing.assert_allclose(gh.numpy(), [12.0])
    return [gh.numpy()]


@mirrored
def test_hook_on_intermediate_fires_and_modifies(paddle):
    a = tensor(paddle, [1.0])
    h = a * 2
    h.register_hook(lambda g: g * 10)
    (h * 3).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [60.0])
    return [a.grad.numpy()]


@mirrored
def test_retain_grads(paddle):
    a = tensor(paddle, [1.0])
    h = a * 2
    h.retain_grads()
    (h * 3).sum().backward()
    np.testing.assert_allclose(h.grad.numpy(), [3.0])
    return [h.grad.numpy()]


@mirrored
def test_second_order_parity(paddle):
    x = tensor(paddle, [1.0, 2.0, 3.0])
    w = np.array([0.5, -1.0, 2.0], np.float32)
    y = (x * x * x * tensor(paddle, w, sg=True)).sum()
    (gx,) = paddle.autograd.grad(y, [x], create_graph=True)
    assert not gx.stop_gradient
    gx.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 6 * w * np.array([1.0, 2.0, 3.0]),
                               rtol=1e-5)
    return [x.grad.numpy()]


@mirrored
def test_gradient_penalty_reaches_weights(paddle):
    paddle.seed(0)
    lin = paddle.nn.Linear(2, 1)
    x = tensor(paddle, [[1.0, 2.0]])
    out = paddle.tanh(lin(x)).sum()
    (g,) = paddle.autograd.grad(out, [x], create_graph=True)
    (g * g).sum().backward()
    assert lin.weight.grad is not None
    assert np.isfinite(np.asarray(lin.weight.grad.numpy())).all()


@mirrored
def test_grad_wrt_intermediate_create_graph(paddle):
    a = tensor(paddle, [2.0])
    b = a * 3.0
    (gb,) = paddle.autograd.grad((b * b).sum(), [b], create_graph=True)
    np.testing.assert_allclose(gb.numpy(), [12.0], rtol=1e-6)
    return [gb.numpy()]


@mirrored
def test_multi_input_second_order(paddle):
    p = tensor(paddle, [1.0])
    q = tensor(paddle, [2.0])
    r = (p * p * q).sum()
    gp, gq = paddle.autograd.grad(r, [p, q], create_graph=True)
    np.testing.assert_allclose(gp.numpy(), [4.0])
    np.testing.assert_allclose(gq.numpy(), [1.0])
    (gp * gq).sum().backward()  # loss = 2 p^3 q
    np.testing.assert_allclose(p.grad.numpy(), [12.0], rtol=1e-5)
    np.testing.assert_allclose(q.grad.numpy(), [2.0], rtol=1e-5)
    return [p.grad.numpy(), q.grad.numpy()]


@mirrored
def test_unused_input_raises_unless_allowed(paddle):
    x = tensor(paddle, [1.0])
    z = tensor(paddle, [1.0])
    y = (x * x).sum()
    with pytest.raises(RuntimeError):
        paddle.autograd.grad(y, [z], create_graph=True)
    gs = paddle.autograd.grad(y, [x, z], create_graph=True, allow_unused=True)
    assert gs[1] is None
    np.testing.assert_allclose(gs[0].numpy(), [2.0])
    return [gs[0].numpy()]
