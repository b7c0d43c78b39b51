"""The port's tensor ops against numpy and against paddle_tpu: the 38
tests of tests/test_tensor_ops.py, each run in both packages on the same
seeded inputs (`mirrored`): every assertion against numpy holds in each,
and the values each returns agree between them."""

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


def check(t, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t.numpy(), np.float64), want,
                               rtol=rtol, atol=atol)
    return np.asarray(t.numpy())


def mirrored(body):
    """A test running `body(paddle)` in both packages; the lists of arrays
    they return must agree."""
    def test():
        got = {}
        for pkg in (ref, port):
            got[pkg.__name__] = [np.asarray(a) for a in (body(pkg) or [])]
        for a, b in zip(got["paddle_tpu"], got["paddle_tpu_torch"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), rtol=1e-5,
                                       atol=1e-6)

    test.__name__ = body.__name__
    return test


# --------------------------------------------------------------------------- #
# creation
# --------------------------------------------------------------------------- #

@mirrored
def test_to_tensor(paddle):
    t = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert t.shape == [2, 2]
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t.numpy(), [[1, 2], [3, 4]])
    return [t.numpy()]


@mirrored
def test_zeros_ones_full(paddle):
    assert paddle.zeros([2, 3]).numpy().sum() == 0
    assert paddle.ones([2, 3]).numpy().sum() == 6
    f = paddle.full([2], 7, "int32")
    np.testing.assert_array_equal(f.numpy(), [7, 7])
    return [f.numpy()]


@mirrored
def test_arange_linspace(paddle):
    np.testing.assert_array_equal(paddle.arange(5).numpy(), np.arange(5))
    ls = paddle.linspace(0, 1, 5)
    np.testing.assert_allclose(ls.numpy(), np.linspace(0, 1, 5), rtol=1e-6)
    return [paddle.arange(5).numpy(), ls.numpy()]


@mirrored
def test_eye_tril_triu(paddle):
    np.testing.assert_array_equal(paddle.eye(3).numpy(), np.eye(3, dtype=np.float32))
    x = paddle.ones([3, 3])
    np.testing.assert_array_equal(paddle.tril(x).numpy(), np.tril(np.ones((3, 3))))
    np.testing.assert_array_equal(paddle.triu(x).numpy(), np.triu(np.ones((3, 3))))
    return [paddle.tril(x).numpy()]


@mirrored
def test_like_variants(paddle):
    x = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert paddle.zeros_like(x).shape == [2, 3]
    assert paddle.ones_like(x).numpy().sum() == 6
    assert paddle.full_like(x, 3).numpy().sum() == 18
    return [paddle.full_like(x, 3).numpy()]


# --------------------------------------------------------------------------- #
# math
# --------------------------------------------------------------------------- #

@mirrored
def test_binary_ops(paddle):
    rng = np.random.RandomState(0)
    a = rng.rand(3, 4).astype(np.float32)
    b = rng.rand(3, 4).astype(np.float32) + 0.5
    ta, tb = paddle.to_tensor(a), paddle.to_tensor(b)
    return [check(paddle.add(ta, tb), a + b),
            check(paddle.subtract(ta, tb), a - b),
            check(paddle.multiply(ta, tb), a * b),
            check(paddle.divide(ta, tb), a / b, rtol=1e-5),
            check(paddle.maximum(ta, tb), np.maximum(a, b)),
            check(paddle.pow(ta, 2.0), a**2, rtol=1e-5)]


@mirrored
def test_operators(paddle):
    rng = np.random.RandomState(0)
    a = rng.rand(3, 4).astype(np.float32)
    b = rng.rand(3, 4).astype(np.float32) + 0.5
    ta, tb = paddle.to_tensor(a), paddle.to_tensor(b)
    out = [check(ta + tb, a + b), check(ta - tb, a - b), check(ta * 2, a * 2),
           check(2 / tb, 2 / b, rtol=1e-5), check(-ta, -a)]
    assert bool((ta > tb).numpy()[0, 0]) == bool(a[0, 0] > b[0, 0])
    return out


@mirrored
def test_unary_ops(paddle):
    a = np.random.RandomState(0).rand(4, 5).astype(np.float32) + 0.1
    t = paddle.to_tensor(a)
    return [check(paddle.exp(t), np.exp(a), rtol=1e-4),
            check(paddle.log(t), np.log(a), rtol=1e-3, atol=1e-4),
            check(paddle.sqrt(t), np.sqrt(a), rtol=1e-5),
            check(paddle.tanh(t), np.tanh(a), rtol=1e-4, atol=1e-5),
            check(paddle.sigmoid(t), 1 / (1 + np.exp(-a)), rtol=1e-4),
            check(paddle.abs(paddle.to_tensor(-a)), a),
            check(paddle.rsqrt(t), 1 / np.sqrt(a), rtol=1e-4)]


@mirrored
def test_reductions(paddle):
    a = np.random.RandomState(0).rand(3, 4, 5).astype(np.float32)
    t = paddle.to_tensor(a)
    return [check(paddle.sum(t), a.sum(), rtol=1e-4),
            check(paddle.sum(t, axis=1), a.sum(1), rtol=1e-4),
            check(paddle.mean(t, axis=[0, 2]), a.mean((0, 2)), rtol=1e-4),
            check(paddle.max(t, axis=-1, keepdim=True), a.max(-1, keepdims=True)),
            check(paddle.min(t), a.min()),
            check(paddle.prod(t, axis=0), a.prod(0), rtol=1e-4)]


@mirrored
def test_method_chaining(paddle):
    a = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    t = paddle.to_tensor(a)
    out = [check(t.exp().log(), a, rtol=1e-3, atol=1e-4),
           check(t.sum(axis=0), a.sum(0), rtol=1e-5)]
    assert t.reshape([4, 3]).shape == [4, 3]
    return out


@mirrored
def test_cumsum_clip(paddle):
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    t = paddle.to_tensor(a)
    return [check(paddle.cumsum(t, axis=1), np.cumsum(a, 1), rtol=1e-5),
            check(paddle.clip(t, -0.5, 0.5), np.clip(a, -0.5, 0.5))]


@mirrored
def test_scale(paddle):
    a = np.random.RandomState(0).rand(3).astype(np.float32)
    return [check(paddle.scale(paddle.to_tensor(a), 2.0, 1.0), a * 2 + 1,
                  rtol=1e-6)]


# --------------------------------------------------------------------------- #
# manipulation
# --------------------------------------------------------------------------- #

@mirrored
def test_reshape_transpose(paddle):
    a = np.random.RandomState(1).rand(2, 3, 4).astype(np.float32)
    t = paddle.to_tensor(a)
    return [check(paddle.reshape(t, [6, 4]), a.reshape(6, 4)),
            check(paddle.transpose(t, [2, 0, 1]), a.transpose(2, 0, 1)),
            check(paddle.flatten(t, 1, 2), a.reshape(2, 12))]


@mirrored
def test_squeeze_unsqueeze(paddle):
    t = paddle.to_tensor(np.random.RandomState(1).rand(2, 1, 3).astype(np.float32))
    assert paddle.squeeze(t, 1).shape == [2, 3]
    assert paddle.unsqueeze(t, 0).shape == [1, 2, 1, 3]
    assert paddle.unsqueeze(t, [0, 4]).shape == [1, 2, 1, 3, 1]


@mirrored
def test_concat_stack_split(paddle):
    rng = np.random.RandomState(1)
    a = rng.rand(2, 3).astype(np.float32)
    b = rng.rand(2, 3).astype(np.float32)
    ta, tb = paddle.to_tensor(a), paddle.to_tensor(b)
    out = [check(paddle.concat([ta, tb], axis=0), np.concatenate([a, b], 0)),
           check(paddle.stack([ta, tb], axis=1), np.stack([a, b], 1))]
    parts = paddle.split(paddle.concat([ta, tb], axis=0), 2, axis=0)
    assert len(parts) == 2
    out.append(check(parts[0], a))
    parts = paddle.split(ta, [1, 2], axis=1)
    out.append(check(parts[1], a[:, 1:]))
    return out


@mirrored
def test_gather_scatter(paddle):
    a = np.random.RandomState(1).rand(5, 3).astype(np.float32)
    t = paddle.to_tensor(a)
    idx = paddle.to_tensor([0, 2], dtype="int32")
    out = [check(paddle.gather(t, idx, axis=0), a[[0, 2]])]
    upd = np.ones((2, 3), np.float32)
    ref_ = a.copy()
    ref_[[0, 2]] = 1
    out.append(check(paddle.scatter(t, idx, paddle.to_tensor(upd)), ref_))
    return out


@mirrored
def test_indexing(paddle):
    a = np.random.RandomState(1).rand(4, 5).astype(np.float32)
    t = paddle.to_tensor(a)
    out = [check(t[1], a[1]), check(t[1:3, ::2], a[1:3, ::2]),
           check(t[:, -1], a[:, -1])]
    t2 = paddle.to_tensor(a.copy())
    t2[0] = 0.0
    ref_ = a.copy()
    ref_[0] = 0
    out.append(check(t2, ref_))
    return out


@mirrored
def test_tile_expand_pad(paddle):
    a = np.random.RandomState(1).rand(2, 3).astype(np.float32)
    t = paddle.to_tensor(a)
    return [check(paddle.tile(t, [2, 1]), np.tile(a, (2, 1))),
            check(paddle.expand(paddle.to_tensor(a[:1]), [4, 3]),
                  np.broadcast_to(a[:1], (4, 3))),
            check(paddle.pad(t, [1, 1], value=0.0), np.pad(a, [(0, 0), (1, 1)]))]


@mirrored
def test_take_put_along_axis(paddle):
    a = np.random.RandomState(1).rand(3, 4).astype(np.float32)
    idx = np.argsort(a, axis=1).astype(np.int32)
    t, ti = paddle.to_tensor(a), paddle.to_tensor(idx)
    return [check(paddle.take_along_axis(t, ti, 1), np.take_along_axis(a, idx, 1))]


@mirrored
def test_masked_select_where(paddle):
    a = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    t = paddle.to_tensor(a)
    m = t > 0
    return [check(paddle.masked_select(t, m), a[a > 0]),
            check(paddle.where(m, t, paddle.zeros_like(t)), np.where(a > 0, a, 0))]


@mirrored
def test_flip_roll(paddle):
    a = np.random.RandomState(1).rand(3, 4).astype(np.float32)
    t = paddle.to_tensor(a)
    return [check(paddle.flip(t, [0]), a[::-1]),
            check(paddle.roll(t, 1, axis=0), np.roll(a, 1, 0))]


# --------------------------------------------------------------------------- #
# linalg
# --------------------------------------------------------------------------- #

@mirrored
def test_matmul(paddle):
    rng = np.random.RandomState(2)
    a = rng.rand(3, 4).astype(np.float32)
    b = rng.rand(4, 5).astype(np.float32)
    return [check(paddle.matmul(paddle.to_tensor(a), paddle.to_tensor(b)), a @ b,
                  rtol=1e-4),
            check(paddle.matmul(paddle.to_tensor(a), paddle.to_tensor(b.T),
                                transpose_y=True), a @ b, rtol=1e-4)]


@mirrored
def test_batched_matmul(paddle):
    rng = np.random.RandomState(2)
    a = rng.rand(2, 3, 4).astype(np.float32)
    b = rng.rand(2, 4, 5).astype(np.float32)
    return [check(paddle.bmm(paddle.to_tensor(a), paddle.to_tensor(b)), a @ b,
                  rtol=1e-4)]


@mirrored
def test_norm_det_inv(paddle):
    a = (np.random.RandomState(2).rand(3, 3).astype(np.float32)
         + np.eye(3, dtype=np.float32) * 3)
    t = paddle.to_tensor(a)
    return [check(paddle.linalg.norm(t), np.linalg.norm(a), rtol=1e-4),
            check(paddle.linalg.det(t), np.linalg.det(a), rtol=1e-4),
            check(paddle.linalg.inv(t), np.linalg.inv(a), rtol=1e-3, atol=1e-5)]


@mirrored
def test_einsum(paddle):
    rng = np.random.RandomState(2)
    a = rng.rand(3, 4).astype(np.float32)
    b = rng.rand(4, 5).astype(np.float32)
    return [check(paddle.einsum("ij,jk->ik", paddle.to_tensor(a),
                                paddle.to_tensor(b)), a @ b, rtol=1e-4)]


# --------------------------------------------------------------------------- #
# search, logic, stat, random, cast
# --------------------------------------------------------------------------- #

@mirrored
def test_argmax_topk_sort(paddle):
    a = np.random.RandomState(3).rand(3, 5).astype(np.float32)
    t = paddle.to_tensor(a)
    np.testing.assert_array_equal(paddle.argmax(t, axis=1).numpy(), a.argmax(1))
    vals, idx = paddle.topk(t, 2, axis=1)
    np.testing.assert_allclose(vals.numpy(), np.sort(a, 1)[:, ::-1][:, :2], rtol=1e-6)
    return [vals.numpy(), idx.numpy(), check(paddle.sort(t, axis=1), np.sort(a, 1))]


@mirrored
def test_comparisons(paddle):
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([2.0, 2.0, 2.0], np.float32)
    ta, tb = paddle.to_tensor(a), paddle.to_tensor(b)
    np.testing.assert_array_equal(paddle.equal(ta, tb).numpy(), a == b)
    np.testing.assert_array_equal(paddle.less_than(ta, tb).numpy(), a < b)
    assert bool(paddle.allclose(ta, ta).numpy())
    assert not bool(paddle.equal_all(ta, tb).numpy())


@mirrored
def test_nonzero(paddle):
    a = np.array([[0, 1], [2, 0]], np.float32)
    out = paddle.nonzero(paddle.to_tensor(a))
    np.testing.assert_array_equal(out.numpy(), np.stack(np.nonzero(a), 1))
    return [out.numpy()]


@mirrored
def test_std_var_median(paddle):
    a = np.random.RandomState(4).rand(4, 6).astype(np.float32)
    t = paddle.to_tensor(a)
    return [check(paddle.std(t), a.std(ddof=1), rtol=1e-4),
            check(paddle.var(t, axis=1), a.var(1, ddof=1), rtol=1e-4),
            check(paddle.median(t), np.median(a), rtol=1e-5)]


@mirrored
def test_seed_reproducible(paddle):
    paddle.seed(42)
    a = paddle.randn([4, 4])
    paddle.seed(42)
    b = paddle.randn([4, 4])
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@mirrored
def test_shapes_ranges(paddle):
    u = paddle.uniform([100], min=0.0, max=1.0)
    assert u.numpy().min() >= 0 and u.numpy().max() <= 1
    r = paddle.randint(0, 10, [50])
    assert r.numpy().min() >= 0 and r.numpy().max() < 10
    p = paddle.randperm(10)
    np.testing.assert_array_equal(np.sort(p.numpy()), np.arange(10))


@mirrored
def test_astype(paddle):
    t = paddle.to_tensor([1.7, 2.3])
    assert t.astype("int32").numpy().tolist() == [1, 2]
    assert t.astype("float16").dtype == np.float16
    assert paddle.to_tensor([1, 2]).dtype in (np.int32, np.int64)


@mirrored
def test_split_non_divisible_raises(paddle):
    with pytest.raises(ValueError):
        paddle.split(paddle.arange(7), 3)


@mirrored
def test_chunk_uneven(paddle):
    parts = paddle.chunk(paddle.arange(7), 3)
    assert [p.shape[0] for p in parts] == [3, 3, 1]
    np.testing.assert_array_equal(parts[2].numpy(), [6])


@mirrored
def test_bitwise_operators(paddle):
    a = paddle.to_tensor([3], dtype="int32")
    b = paddle.to_tensor([5], dtype="int32")
    assert (a & b).numpy().tolist() == [1]
    assert (a | b).numpy().tolist() == [7]
    assert (a ^ b).numpy().tolist() == [6]
    assert (~a).numpy().tolist() == [-4]
    t = paddle.to_tensor([True, False])
    np.testing.assert_array_equal((~t).numpy(), [False, True])


@mirrored
def test_cummax_cummin(paddle):
    a = np.array([[1.0, 3.0, 2.0], [4.0, 0.0, 5.0]], np.float32)
    vals, idx = paddle.cummax(paddle.to_tensor(a), axis=1)
    np.testing.assert_array_equal(vals.numpy(), np.maximum.accumulate(a, 1))
    np.testing.assert_array_equal(idx.numpy(), [[0, 1, 1], [0, 0, 2]])
    vals2, _ = paddle.cummin(paddle.to_tensor(a), axis=1)
    np.testing.assert_array_equal(vals2.numpy(), np.minimum.accumulate(a, 1))
    return [vals.numpy(), idx.numpy(), vals2.numpy()]


@mirrored
def test_argmax_dtype_honored(paddle):
    x = paddle.to_tensor([[1.0, 5.0]])
    assert paddle.argmax(x, axis=1, dtype="int32").dtype == np.int32


@mirrored
def test_to_device_dtype_tensor(paddle):
    """Tensor.to takes devices, dtypes and Tensors; anything else raises."""
    t = paddle.to_tensor(np.ones(3, np.float32))
    assert t.to("float16").dtype == np.float16
    assert t.to("cpu").dtype == t.dtype
    assert t.to(paddle.to_tensor(np.ones(1, np.int32))).dtype == np.int32
    with pytest.raises(ValueError, match="cannot interpret"):
        t.to("floaty32")
