"""The port's cross entropy (paddle_tpu_torch.nn.functional.cross_entropy,
`SparseCrossEntropy`), `ParallelCrossEntropy` and `GPTPretrainingCriterion`
held against the JAX package's on the same logits and labels: loss values
and logits gradients, with `ignore_index` rows, every reduction, labels
with a trailing 1, a loss mask, and bf16 logits under O2."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import (
    ParallelCrossEntropy as JaxPCE)
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed.fleet.layers.mpu import ParallelCrossEntropy
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.nn import functional as TF

# f32: log-sum-exp over 50 classes and a mean over 24 rows in other orders,
# a few ulps of values O(1)
TOL = dict(rtol=1e-5, atol=1e-6)
IGNORE = -100


def _case(seed, shape=(3, 8), classes=50, ignored=3):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal(shape + (classes,))).astype(np.float32)
    labels = rng.integers(0, classes, shape).astype(np.int64)
    flat = labels.reshape(-1)
    flat[rng.choice(flat.size, ignored, replace=False)] = IGNORE
    cot = rng.standard_normal(shape).astype(np.float32)
    return logits, labels, cot


def _jax_loss_and_grad(fn, logits, labels, cot=None):
    x = paddle.to_tensor(logits, stop_gradient=False)
    loss = fn(x, paddle.to_tensor(labels))
    total = loss if cot is None else (loss * paddle.to_tensor(cot)).sum()
    total.backward()
    return loss.numpy(), x.grad.numpy()


def _port_loss_and_grad(fn, logits, labels, cot=None):
    x = torch.from_numpy(logits).requires_grad_()
    loss = fn(x, torch.from_numpy(labels))
    total = loss if cot is None else (loss * torch.from_numpy(cot)).sum()
    total.backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    logits, labels, cot = _case(1)
    c = None if reduction != "none" else cot
    want = _jax_loss_and_grad(
        lambda x, y: paddle.nn.functional.cross_entropy(
            x, y, reduction=reduction, ignore_index=IGNORE), logits, labels, c)
    got = _port_loss_and_grad(
        lambda x, y: TF.cross_entropy(x, y, reduction=reduction,
                                      ignore_index=IGNORE), logits, labels, c)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    ignored = labels == IGNORE
    np.testing.assert_array_equal(got[1][ignored], 0.0)
    if reduction == "none":
        np.testing.assert_array_equal(got[0][ignored], 0.0)


def test_labels_with_a_trailing_one_and_all_rows_ignored():
    logits, labels, _ = _case(2)
    a = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels[..., None]))
    b = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert a.item() == b.item()
    none = TF.cross_entropy(torch.from_numpy(logits),
                            torch.full(labels.shape, IGNORE))
    assert none.item() == 0.0  # mean over max(1, 0 valid rows)


def test_parallel_cross_entropy_matches_jax():
    logits, labels, cot = _case(3)
    want = _jax_loss_and_grad(JaxPCE(), logits, labels, cot)
    got = _port_loss_and_grad(ParallelCrossEntropy(), logits, labels, cot)
    assert got[0].shape == labels.shape
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_pretraining_criterion_matches_jax(masked):
    logits, labels, _ = _case(4, ignored=0)
    mask = (np.random.default_rng(5).random(labels.shape) > 0.3).astype(np.float32)
    jcrit, tcrit = JaxCriterion(), GPTPretrainingCriterion()
    if masked:
        want = _jax_loss_and_grad(
            lambda x, y: jcrit(x, y, paddle.to_tensor(mask)), logits, labels)
        got = _port_loss_and_grad(
            lambda x, y: tcrit(x, y, torch.from_numpy(mask)), logits, labels)
    else:
        want = _jax_loss_and_grad(jcrit, logits, labels)
        got = _port_loss_and_grad(tcrit, logits, labels)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)


def test_bf16_logits_under_o2_match_jax():
    """Under O2 cross entropy is on the black list: bf16 logits are cast to
    f32, the loss is f32 and the logits gradient comes back in bf16."""
    logits, labels, _ = _case(6)
    lb = logits.astype(np.float32)
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        x = paddle.to_tensor(lb, stop_gradient=False).astype("bfloat16")
        xj = x.detach()
        xj.stop_gradient = False
        jl = paddle.nn.functional.cross_entropy(xj, paddle.to_tensor(labels))
    jl.backward()
    xt = torch.from_numpy(lb).to(torch.bfloat16).requires_grad_()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        tl = TF.cross_entropy(xt, torch.from_numpy(labels))
    tl.backward()
    assert tl.dtype == torch.float32 and str(jl.dtype).endswith("float32")
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    # the gradient rounds once to bf16 on both sides: two ulps at |g| < 0.1
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(xj.grad.numpy(), np.float32),
                               rtol=0, atol=2 * 2.0 ** -11)
