"""The port's tensor-op tail and in-place variants against paddle_tpu:
the 13 tests of tests/test_tensor_extras.py, each run in both packages
(`mirrored`); every assertion holds in each."""

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


def _maker(paddle):
    return lambda a: paddle.to_tensor(np.asarray(a))


def mirrored(body):
    """A test running `body(paddle)` in both packages."""
    def test():
        for pkg in (ref, port):
            body(pkg)

    test.__name__ = body.__name__
    return test


@mirrored
def test_math_tail(paddle):
    _t = _maker(paddle)
    x = _t(np.array([0.5, 1.5], np.float32))
    np.testing.assert_allclose(paddle.negative(x).numpy(), [-0.5, -1.5])
    np.testing.assert_allclose(paddle.positive(x).numpy(), x.numpy())
    s = paddle.add_n([x, x, x])
    np.testing.assert_allclose(s.numpy(), 3 * x.numpy())
    np.testing.assert_allclose(
        paddle.sgn(_t(np.array([-3.0, 0.0, 2.0], np.float32))).numpy(),
        [-1.0, 0.0, 1.0])


@mirrored
def test_special_functions(paddle):
    _t = _maker(paddle)
    import math

    x = _t(np.array([2.0, 3.0], np.float32))
    # gammaln(n) = log((n-1)!)
    np.testing.assert_allclose(paddle.gammaln(x).numpy(),
                               [0.0, math.log(2.0)], atol=1e-5)
    s = paddle.sinc(_t(np.array([0.0, 0.5], np.float32)))
    np.testing.assert_allclose(s.numpy(), [1.0, 2 / np.pi], rtol=1e-5)
    assert bool(paddle.signbit(_t(np.array([-1.0], np.float32))).numpy()[0])


@mirrored
def test_complex_family(paddle):
    _t = _maker(paddle)
    pairs = _t(np.array([[1.0, 2.0], [3.0, -1.0]], np.float32))
    c = paddle.as_complex(pairs)
    assert paddle.is_complex(c)
    np.testing.assert_allclose(paddle.as_real(c).numpy(), pairs.numpy())
    p = paddle.polar(_t(np.array([1.0], np.float32)),
                     _t(np.array([np.pi / 2], np.float32)))
    np.testing.assert_allclose(np.imag(p.numpy()), [1.0], atol=1e-6)
    assert paddle.is_floating_point(pairs)
    assert paddle.is_integer(_t(np.array([1, 2])))


@mirrored
def test_manipulation_tail(paddle):
    _t = _maker(paddle)
    t = _t(np.arange(12, dtype=np.float32).reshape(3, 4))
    assert paddle.shape(t).numpy().tolist() == [3, 4]
    assert int(paddle.rank(t).numpy()) == 2
    assert paddle.broadcast_shape([3, 1], [1, 4]) == [3, 4]
    np.testing.assert_allclose(
        paddle.matrix_transpose(t).numpy(), t.numpy().T)
    np.testing.assert_allclose(
        paddle.reverse(t, axis=0).numpy(), t.numpy()[::-1])
    parts = paddle.tensor_split(_t(np.arange(10)), [3, 7])
    assert [p.shape[0] for p in parts] == [3, 4, 3]
    un = paddle.unflatten(_t(np.arange(12)), 0, [3, 4])
    assert tuple(un.shape) == (3, 4)
    pieces = paddle.unstack(t, axis=1)
    assert len(pieces) == 4 and tuple(pieces[0].shape) == (3,)


@mirrored
def test_scatter_family(paddle):
    _t = _maker(paddle)
    t = _t(np.zeros((3, 3), np.float32))
    out = paddle.index_fill(t, _t(np.array([0, 2])), 0, 5.0)
    np.testing.assert_allclose(out.numpy()[:, 0], [5, 0, 5])
    sel = paddle.select_scatter(t, _t(np.ones(3, np.float32)), 0, 1)
    np.testing.assert_allclose(sel.numpy()[1], 1.0)
    sl = paddle.slice_scatter(t, _t(np.ones((3, 1), np.float32)),
                              axes=[1], starts=[2], ends=[3], strides=[1])
    np.testing.assert_allclose(sl.numpy()[:, 2], 1.0)
    snd = paddle.scatter_nd(_t(np.array([[0], [2]])),
                            _t(np.array([1.0, 3.0], np.float32)), [4])
    np.testing.assert_allclose(snd.numpy(), [1, 0, 3, 0])
    ms = paddle.masked_scatter(
        t, _t(np.eye(3, dtype=bool)),
        _t(np.array([7.0, 8.0, 9.0], np.float32)))
    np.testing.assert_allclose(np.diag(ms.numpy()), [7, 8, 9])


@mirrored
def test_diag_family(paddle):
    _t = _maker(paddle)
    d = paddle.diag_embed(_t(np.array([1.0, 2.0], np.float32)))
    np.testing.assert_allclose(d.numpy(), np.diag([1.0, 2.0]))
    t = _t(np.arange(9, dtype=np.float32).reshape(3, 3))
    np.testing.assert_allclose(paddle.diagonal(t).numpy(), [0, 4, 8])
    ds = paddle.diagonal_scatter(t, _t(np.zeros(3, np.float32)))
    np.testing.assert_allclose(np.diag(ds.numpy()), 0.0)


@mirrored
def test_linalg_tail(paddle):
    _t = _maker(paddle)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 3)).astype(np.float32)
    spd = a @ a.T + 3 * np.eye(3, dtype=np.float32)
    L = np.linalg.cholesky(spd)
    inv = paddle.cholesky_inverse(_t(L))
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(spd),
                               rtol=1e-3, atol=1e-4)
    ms = [rng.normal(size=(4, 4)).astype(np.float32) for _ in range(3)]
    md = paddle.multi_dot([_t(m) for m in ms])
    np.testing.assert_allclose(md.numpy(), ms[0] @ ms[1] @ ms[2],
                               rtol=1e-4, atol=1e-4)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    y = rng.normal(size=(4, 3)).astype(np.float32)
    cd = paddle.cdist(_t(x), _t(y))
    ref = np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1))
    np.testing.assert_allclose(cd.numpy(), ref, rtol=1e-4, atol=1e-5)
    v = paddle.vander(_t(np.array([1.0, 2.0, 3.0], np.float32)))
    np.testing.assert_allclose(v.numpy(), np.vander([1.0, 2.0, 3.0]))
    bd = paddle.block_diag([_t(np.ones((2, 2), np.float32)),
                            _t(np.full((1, 1), 5.0, np.float32))])
    assert tuple(bd.shape) == (3, 3) and bd.numpy()[2, 2] == 5


@mirrored
def test_trapezoid_and_logcumsumexp(paddle):
    _t = _maker(paddle)
    y = _t(np.array([1.0, 2.0, 3.0], np.float32))
    np.testing.assert_allclose(float(paddle.trapezoid(y).numpy()), 4.0)
    ct = paddle.cumulative_trapezoid(y)
    np.testing.assert_allclose(ct.numpy(), [1.5, 4.0])
    lse = paddle.logcumsumexp(_t(np.zeros(3, np.float32)))
    np.testing.assert_allclose(lse.numpy(), np.log([1, 2, 3]), rtol=1e-5)


@mirrored
def test_isin_and_predicates(paddle):
    _t = _maker(paddle)
    x = _t(np.array([1, 2, 3, 4]))
    np.testing.assert_array_equal(
        paddle.isin(x, _t(np.array([2, 4]))).numpy(),
        [False, True, False, True])
    inf = _t(np.array([np.inf, -np.inf, 1.0], np.float32))
    np.testing.assert_array_equal(paddle.isposinf(inf).numpy(),
                                  [True, False, False])
    np.testing.assert_array_equal(paddle.isneginf(inf).numpy(),
                                  [False, True, False])


@mirrored
def test_inplace_variants(paddle):
    _t = _maker(paddle)
    x = _t(np.ones(3, np.float32))
    y = paddle.exp_(x)
    assert y is x
    np.testing.assert_allclose(x.numpy(), np.e, rtol=1e-6)
    z = _t(np.array([-2.0, 5.0], np.float32))
    paddle.clip_(z, min=0.0, max=1.0)
    np.testing.assert_allclose(z.numpy(), [0.0, 1.0])
    # in-place participates in autograd via the snapshot mechanism
    a = _t(np.ones(2, np.float32))
    a.stop_gradient = False
    b = a * 2.0
    paddle.add_(b, _t(np.ones(2, np.float32)))
    b.sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), 2.0)
    # in-place on a leaf requiring grad is rejected (reference error)
    leaf = _t(np.ones(2, np.float32))
    leaf.stop_gradient = False
    with pytest.raises(RuntimeError, match="leaf"):
        paddle.exp_(leaf)


@mirrored
def test_top_p_sampling(paddle):
    _t = _maker(paddle)
    paddle.seed(0)
    logits = _t(np.array([[0.0, 0.0, 10.0]], np.float32))
    vals, ids = paddle.top_p_sampling(
        logits, _t(np.array([0.5], np.float32)))
    assert int(ids.numpy()[0, 0]) == 2
    assert float(vals.numpy()[0, 0]) > 0.9


@mirrored
def test_take_and_combinations(paddle):
    _t = _maker(paddle)
    t = _t(np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_allclose(
        paddle.take(t, _t(np.array([0, 4]))).numpy(), [0.0, 4.0])
    c = paddle.combinations(_t(np.array([1, 2, 3])), 2)
    assert tuple(c.shape) == (3, 2)
    # mode="raise" bounds-checks eagerly instead of silently wrapping
    with pytest.raises(IndexError):
        paddle.take(t, _t(np.array([0, 99])))


@mirrored
def test_frexp_and_cast(paddle):
    _t = _maker(paddle)
    m, e = paddle.frexp(_t(np.array([4.0], np.float32)))
    np.testing.assert_allclose(m.numpy() * 2.0 ** e.numpy(), 4.0)
    assert paddle.cast(_t(np.ones(2, np.float32)), "int32").dtype == np.int32
