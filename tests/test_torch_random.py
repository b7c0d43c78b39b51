"""The port's random draws (`framework.random`, the dropout family,
attention dropout, rrelu, gumbel_softmax) and recomputation with them.

The two packages' RNGs differ (threefry keys against `torch.Generator`s),
so a mask is held by the port's own statistics: the keep rate within 5
sigma, the kept values exactly x / (1 - p), the mask's broadcast over
`axis`, the same mask for the same generator state and another for the
next draw. Where nothing is drawn (p = 0, eval mode) the port is held to
the JAX package. Recomputation replays the forward's masks: gradients with
and without `use_recompute` agree to 0 ulp. The rank rule is held over a
2-rank gloo group (`tests/torch_random_cases.py`): at mp 2 the replicated
parameters stay bitwise equal across the mp ranks (a generator that folds
in the mp coordinate for every draw is the control that parts them), and
at dp 2 the ranks draw different masks."""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt3_tiny as jax_gpt3_tiny
import paddle_tpu_torch
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed.fleet.recompute import recompute
from paddle_tpu_torch.framework import random
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt3_tiny)
from paddle_tpu_torch.nn import functional as F
from torch_dist_worker import Ranks, check

N = 1 << 20
SIGMAS = 5.0


@pytest.fixture(autouse=True)
def _fresh_generators():
    random.seed(0)
    yield
    random.seed(0)


def _within(count, n, prob):
    return abs(count - n * prob) <= SIGMAS * math.sqrt(n * prob * (1 - prob))


def test_seed_state_and_guard():
    x = torch.ones(1000)
    paddle_tpu_torch.seed(3)
    a = F.dropout(x, 0.5)
    b = F.dropout(x, 0.5)
    paddle_tpu_torch.seed(3)
    torch.testing.assert_close(F.dropout(x, 0.5), a, rtol=0, atol=0)
    assert not torch.equal(a, b)
    state = paddle_tpu_torch.get_rng_state()
    c = F.dropout(x, 0.5)
    torch.manual_seed(123)   # torch's global generator is not the port's
    paddle_tpu_torch.set_rng_state(state)
    torch.testing.assert_close(F.dropout(x, 0.5), c, rtol=0, atol=0)
    with random.rng_guard(state):
        torch.testing.assert_close(F.dropout(x, 0.5), c, rtol=0, atol=0)
    assert not torch.equal(F.dropout(x, 0.5), c)   # the guard restored
    # a generator made after a snapshot starts afresh when it is restored
    fresh = random.get_rng_state()
    with random.cut_over_mp():
        d = F.dropout(x, 0.5)
        random.set_rng_state(fresh)
        torch.testing.assert_close(F.dropout(x, 0.5), d, rtol=0, atol=0)


def test_rank_rule_seeds():
    x = torch.ones(4096)

    def draws(token, mp):
        random.seed(0)
        with random.rank_scope(token, mp):
            shared = F.dropout(x, 0.5)
            with random.cut_over_mp():
                cut = F.dropout(x, 0.5)
        return shared, cut

    s00, c00 = draws(0, 0)
    s01, c01 = draws(0, 1)
    s10, _ = draws(1, 0)
    assert torch.equal(s00, s01) and not torch.equal(c00, c01)
    assert not torch.equal(s00, s10)
    random.seed(0)
    assert torch.equal(F.dropout(x, 0.5), s00)   # rank (0, 0) is the seed's
    # a scope leaves the rank, and the generators of the rank outside it,
    # as they were; each rank's generator goes on where it stopped
    random.seed(0)
    first = F.dropout(x, 0.5)
    with random.rank_scope(1, 1):
        t1 = F.dropout(x, 0.5)
    second = F.dropout(x, 0.5)
    with random.rank_scope(1, 1):
        t2 = F.dropout(x, 0.5)
    random.seed(0)
    assert torch.equal(F.dropout(x, 0.5), first)
    assert torch.equal(F.dropout(x, 0.5), second)
    assert torch.equal(t1, s10) and not torch.equal(t1, t2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_and_scale(p, dtype):
    x = torch.randn(N, generator=torch.Generator().manual_seed(1)).to(dtype)
    out = F.dropout(x, p)
    assert out.dtype == dtype
    keep = out != 0
    assert _within(int(keep.sum()), N, 1 - p)
    torch.testing.assert_close(out[keep], (x / (1 - p))[keep], rtol=0, atol=0)
    down = F.dropout(x, p, mode="downscale_in_infer")
    assert _within(int((down != 0).sum()), N, 1 - p)
    torch.testing.assert_close(down[down != 0], x[down != 0], rtol=0, atol=0)


def test_axis_broadcast_and_limits():
    x = torch.randn(6, 5, 4, 3, generator=torch.Generator().manual_seed(2)) + 5
    for axis in (1, [0, 2], -1):
        r = F.dropout(x, 0.5, axis=axis) / x
        axes = [a % 4 for a in ([axis] if isinstance(axis, int) else axis)]
        for d in range(4):
            if d not in axes:   # the mask is one value along every other dim
                assert torch.equal(r, r.narrow(d, 0, 1).expand_as(r))
    r = pnn.Dropout2D(0.5)(x) / x
    assert torch.equal(r, r[:, :, :1, :1].expand_as(r))
    r = F.dropout2d(x, 0.5, data_format="NHWC") / x
    assert torch.equal(r, r[:, :1, :1, :].expand_as(r))
    x5 = x[..., None] + 1
    r = pnn.Dropout3D(0.5)(x5) / x5
    assert torch.equal(r, r[:, :, :1, :1, :1].expand_as(r))
    xg = x.clone().requires_grad_()
    zero = F.dropout(xg, 1.0)
    zero.sum().backward()
    assert not zero.any() and not xg.grad.any()
    layer = pnn.Dropout(0.3).eval()
    assert layer(x) is x
    np.testing.assert_allclose(
        F.dropout(x, 0.3, training=False, mode="downscale_in_infer").numpy(),
        JF.dropout(paddle.to_tensor(x.numpy()), 0.3, training=False,
                   mode="downscale_in_infer").numpy(), rtol=1e-6)
    assert F.dropout(x, 0.0) is x and F.alpha_dropout(x, 0.5, False) is x


def test_alpha_dropout_keeps_mean_and_variance():
    """Mean 0 and variance 1 within 5 standard errors, the variance's from
    the sample's fourth central moment."""
    x = torch.randn(N, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    out = pnn.AlphaDropout(0.2)(x)
    c = out - out.mean()
    var, m4 = c.square().mean().item(), c.pow(4).mean().item()
    assert abs(out.mean().item()) < SIGMAS * math.sqrt(var / N)
    assert abs(var - 1) < SIGMAS * math.sqrt((m4 - var * var) / N)


def test_rrelu_and_gumbel_softmax():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(4))
    y = F.rrelu(x, 0.1, 0.3, training=True)
    neg = x < 0
    slopes = y[neg] / x[neg]
    assert torch.equal(y[~neg], x[~neg])
    assert slopes.min() >= 0.1 and slopes.max() <= 0.3 and slopes.std() > 0.03
    np.testing.assert_allclose(
        F.rrelu(x, 0.1, 0.3).numpy(),
        JF.rrelu(paddle.to_tensor(x.numpy()), 0.1, 0.3).numpy(), rtol=1e-6)
    logits = torch.randn(64, 10, generator=torch.Generator().manual_seed(5),
                         requires_grad=True)
    soft = F.gumbel_softmax(logits, temperature=0.5)
    torch.testing.assert_close(soft.sum(-1), torch.ones(64))
    state = random.get_rng_state()
    hard = F.gumbel_softmax(logits, temperature=0.5, hard=True)
    # oh + y - y.detach(): one-hot up to the rounding of y - y
    onehot = torch.nn.functional.one_hot(hard.detach().argmax(-1), 10).float()
    torch.testing.assert_close(hard.detach(), onehot, rtol=0, atol=1e-6)
    random.set_rng_state(state)
    again = F.gumbel_softmax(logits, temperature=0.5)
    (g_hard,) = torch.autograd.grad((hard * torch.arange(10.0)).sum(), logits)
    (g_soft,) = torch.autograd.grad((again * torch.arange(10.0)).sum(), logits)
    torch.testing.assert_close(g_hard, g_soft, rtol=0, atol=0)


def test_attention_dropout_composite():
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 16, 4, 8, generator=g) for _ in range(3))
    plain = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    kept = F.scaled_dot_product_attention(q, k, v, dropout_p=1e-12,
                                          is_causal=True)
    torch.testing.assert_close(kept, plain, rtol=1e-5, atol=1e-6)
    state = random.get_rng_state()
    a = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5, is_causal=True)
    random.set_rng_state(state)
    b = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5, is_causal=True)
    assert torch.equal(a, b) and (a - plain).abs().max() > 1e-2
    evald = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                           is_causal=True, training=False)
    torch.testing.assert_close(evald, plain, rtol=0, atol=0)


def _gpt_grads(recompute_on, **cfg_kw):
    cfg = gpt3_tiny(hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                    use_recompute=recompute_on, **cfg_kw)
    model = GPTForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 1024, (2, 16)))
    random.seed(11)
    loss = GPTPretrainingCriterion()(model(ids), ids)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


def test_recompute_replays_the_masks():
    loss0, g0 = _gpt_grads(False)
    loss1, g1 = _gpt_grads(True)
    assert loss0 == loss1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)
    # without the port's generators in the snapshot the replay draws anew
    lin = torch.nn.Linear(16, 16)
    x = torch.randn(8, 16, requires_grad=True)

    def fn(h):
        return F.dropout(lin(h), 0.5).tanh()

    grads = []
    for kw in (dict(), dict(preserve_rng_state=False)):
        random.seed(2)
        x.grad = None
        recompute(fn, x, **kw).sum().backward()
        grads.append(x.grad.clone())
    random.seed(2)
    x.grad = None
    fn(x).sum().backward()
    torch.testing.assert_close(grads[0], x.grad, rtol=0, atol=0)
    assert not torch.equal(grads[1], x.grad)


def test_eval_mode_matches_jax_with_dropout_configured():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt3_tiny(hidden_dropout_prob=0.1,
                              attention_dropout_prob=0.1))
    jm.eval()
    tm = GPTForCausalLM(gpt3_tiny(hidden_dropout_prob=0.1,
                                  attention_dropout_prob=0.1), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    tm.eval()
    ids = np.random.default_rng(1).integers(0, 1024, (2, 16))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, jm(paddle.to_tensor(ids)).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ids = np.random.default_rng(2).integers(0, 1024, (2, 16))
    return Ranks("random", 2, tmp_path_factory.mktemp("random"),
                 dict(ids=ids)).results(timeout=180)


def test_replicated_parameters_stay_equal_over_mp(ranks):
    a, b = (check(r) for r in ranks["gpt_mp"])
    assert a["losses"] == b["losses"]
    for k in a["replicated"]:
        np.testing.assert_array_equal(a["replicated"][k], b["replicated"][k],
                                      err_msg=k)
    c, d = (check(r) for r in ranks["gpt_mp_fold_everywhere"])
    parted = max(np.abs(c["replicated"][k] - d["replicated"][k]).max()
                 for k in c["replicated"])
    assert parted > 1e-6, parted


def test_token_ranks_draw_different_masks(ranks):
    a, b = (check(r) for r in ranks["dp_masks"])
    assert (a["shared"] != b["shared"]).mean() > 0.3
    c, d = (check(r) for r in ranks["mp_masks"])
    np.testing.assert_array_equal(c["shared"], d["shared"])
    assert (c["cut"] != d["cut"]).mean() > 0.3


def test_step_rank_stays_inside_the_step(ranks):
    for r in ranks["no_leak"]:
        assert check(r) == dict(shared=True, cut=True)
