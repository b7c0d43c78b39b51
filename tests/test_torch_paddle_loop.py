"""The eager Paddle-idiom training loop on gpt3_tiny in f32, written once
and run in both packages from the same weights:

    ids = paddle.to_tensor(...)
    loss = crit(model(ids), labels)
    loss.backward(); opt.step(); opt.clear_grad()

Three AdamW steps; the losses and every parameter agree within 1e-5, but
the k-projection biases: their gradient is analytically zero (q . b_k is
the same for every key of a row, which the softmax cancels), so each
package's is rounding noise that AdamW turns into steps of about lr; they
are held to lr a step, as in tests/test_torch_train.py."""

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port

STEPS, LR, TOL = 3, 1e-3, 1e-5
NOISE_ONLY = "self_attn.k_proj.bias"


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


def _loop(paddle, model, crit, batches):
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters())
    losses = []
    for ids_np, labels_np in batches:
        ids = paddle.to_tensor(ids_np)
        labels = paddle.to_tensor(labels_np)
        loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def test_eager_loop_matches_reference():
    from paddle_tpu.models import GPTForCausalLM as RefGPT
    from paddle_tpu.models import GPTPretrainingCriterion as RefCrit
    from paddle_tpu.models import gpt3_tiny as ref_tiny
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)

    ref.seed(0)
    rm = RefGPT(ref_tiny())
    pm = GPTForCausalLM(gpt3_tiny(), seed=9)
    state = {k: np.asarray(v.numpy()) for k, v in rm.state_dict().items()}
    assert pm.set_state_dict(state) == ([], [])
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 1024, (2, 16)), rng.integers(0, 1024, (2, 16)))
               for _ in range(STEPS)]
    r_losses = _loop(ref, rm, RefCrit(), batches)
    p_losses = _loop(port, pm, GPTPretrainingCriterion(), batches)
    np.testing.assert_allclose(p_losses, r_losses, rtol=TOL, atol=TOL)
    assert p_losses[-1] < p_losses[0]
    r_state = rm.state_dict()
    for k, v in pm.state_dict().items():
        if k.endswith(NOISE_ONLY):
            gap = np.abs(v.numpy() - np.asarray(r_state[k].numpy())).max()
            assert gap <= LR * STEPS, (k, gap)
            continue
        np.testing.assert_allclose(v.numpy(), np.asarray(r_state[k].numpy()),
                                   rtol=TOL, atol=TOL, err_msg=k)
        assert not np.array_equal(v.numpy(), state[k]), f"{k} did not move"
    # clear_grad left every gradient None
    assert all(p.grad is None for p in pm.parameters())
