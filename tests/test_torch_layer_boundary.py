"""The boundary between Paddle `Tensor`s and the port's torch code is
`nn.Layer.__call__`: each model gives the same outputs and gradients from
`to_tensor` inputs as from plain tensors, its inner layers receive plain
torch tensors only, a `TrainStep` takes a `Tensor` by its held tensor (no
trip through numpy), and importing the port adds nothing to torch's
classes."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework.core import Tensor

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield
    paddle.device._default = "cuda"


def _gpt():
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_tiny

    ids = np.random.default_rng(0).integers(0, 1024, (2, 16))
    return GPTForCausalLM(gpt3_tiny(), seed=1), [ids], {}


def _llama():
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    ids = np.random.default_rng(1).integers(0, 1024, (2, 16))
    return LlamaForCausalLM(llama_tiny(), seed=1), [ids], {}


def _bert():
    from paddle_tpu_torch.models import BertForPretraining, bert_tiny

    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1024, (2, 16))
    types = rng.integers(0, 2, (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[1, 12:] = 0
    m = BertForPretraining(bert_tiny(hidden_dropout_prob=0.0,
                                     attention_dropout_prob=0.0), seed=1)
    return m, [ids, types], {"attention_mask": mask}


def _resnet():
    from paddle_tpu_torch.vision.models import resnet18

    x = np.random.default_rng(3).normal(size=(2, 3, 32, 32)).astype(np.float32)
    return resnet18(num_classes=10), [x], {}


def _unet():
    from paddle_tpu_torch.models import UNetModel, unet_tiny

    rng = np.random.default_rng(4)
    cfg = unet_tiny()
    x = rng.normal(size=(2, cfg.in_channels, 8, 8)).astype(np.float32)
    t = rng.integers(0, 1000, (2,))
    ctx = rng.normal(size=(2, 5, cfg.context_dim)).astype(np.float32)
    return UNetModel(cfg), [x, t], {"context": ctx}


def _moe():
    from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertFFN,
                                                                  MoELayer)

    x = np.random.default_rng(5).normal(size=(2, 8, 16)).astype(np.float32)
    layer = MoELayer(16, ExpertFFN(4, 16, 32),
                     gate={"type": "naive", "top_k": 2})
    return layer, [x], {}


MODELS = {"gpt3_tiny": _gpt, "llama_tiny": _llama, "bert_tiny": _bert,
          "resnet18": _resnet, "unet_tiny": _unet, "moe": _moe}


def _first(out):
    while isinstance(out, (list, tuple)):
        out = out[0]
    return out


def _run(model, args, kwargs, wrap):
    conv = paddle.to_tensor if wrap else (lambda a: torch.as_tensor(a))
    for p in model.parameters():
        p.grad = None
    paddle.seed(0)
    out = model(*[conv(a) for a in args],
                **{k: conv(v) for k, v in kwargs.items()})
    first = _first(out)
    if wrap:
        assert isinstance(first, Tensor)
        loss = (first * first).mean()
        loss.backward()
        value = first.numpy()
    else:
        assert isinstance(first, torch.Tensor) and not isinstance(first, Tensor)
        (first * first).mean().backward()
        value = first.detach().numpy()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return value, grads


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tensor_inputs_match_plain_tensors(name):
    """Outputs and gradients from `to_tensor` inputs equal those from plain
    tensors, bit for bit (the same torch ops run in both)."""
    paddle.seed(0)
    model, args, kwargs = MODELS[name]()
    plain, g_plain = _run(model, args, kwargs, wrap=False)
    wrapped, g_wrapped = _run(model, args, kwargs, wrap=True)
    np.testing.assert_array_equal(wrapped, plain)
    assert g_plain and sorted(g_plain) == sorted(g_wrapped)
    for k in g_plain:
        assert torch.equal(g_plain[k], g_wrapped[k]), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_inner_layers_see_plain_tensors(name):
    """A forward pre-hook on every layer below the top one sees no Paddle
    `Tensor` among its arguments; the top layer's outputs are `Tensor`s."""
    paddle.seed(0)
    model, args, kwargs = MODELS[name]()
    seen = []

    def walk(x):
        if isinstance(x, Tensor):
            return True
        if isinstance(x, (list, tuple)):
            return any(walk(i) for i in x)
        if isinstance(x, dict):
            return any(walk(i) for i in x.values())
        return False

    def hook(layer, inputs, kw):
        seen.append(type(layer).__name__)
        assert not walk(inputs) and not walk(kw), type(layer).__name__

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if m is not model]
    try:
        out = model(*[paddle.to_tensor(a) for a in args],
                    **{k: paddle.to_tensor(v) for k, v in kwargs.items()})
    finally:
        for h in handles:
            h.remove()
    # the MoE layer's fast path runs its experts' weights through the
    # grouped GEMM without calling a sublayer
    assert len(seen) > 3 or name == "moe"
    assert isinstance(_first(out), Tensor)


def test_layer_is_the_base_of_every_port_layer():
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_tiny

    m = GPTForCausalLM(gpt3_tiny())
    assert all(isinstance(x, paddle.nn.Layer) for x in m.modules())
    assert all(isinstance(p, paddle.Parameter) for p in m.parameters())
    # Paddle's Layer names beside torch's
    assert m.sublayers() == list(m.modules())[1:]
    assert m.full_name().startswith("gptforcausallm_")
    p = m.parameters().__next__()
    p.stop_gradient = True
    assert not p.requires_grad and not p.trainable


def test_train_step_takes_a_tensor_by_its_held_tensor(monkeypatch):
    """jit.TrainStep._batch never sends a `Tensor` through numpy."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)
    from paddle_tpu_torch.optimizer import AdamW

    m = GPTForCausalLM(gpt3_tiny())
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    step = jit.TrainStep(m, lambda lg, lb: crit(lg, lb), opt)
    ids = paddle.to_tensor(np.random.default_rng(0).integers(0, 1024, (2, 16)))

    def refuse(*a, **k):
        raise AssertionError("np.asarray called on a step input")

    monkeypatch.setattr(jit.np, "asarray", refuse)
    loss = step(ids, ids)
    assert np.isfinite(float(loss))
    batch = step._batch(ids)
    assert batch[0] is ids._value


def test_torch_gains_no_attribute():
    """A fresh interpreter importing every module of the port leaves
    torch.Tensor, torch.nn.Parameter and torch.nn.Module as they were."""
    code = (
        "import torch, pkgutil, importlib\n"
        "cls = (torch.Tensor, torch.nn.Parameter, torch.nn.Module)\n"
        "before = [set(vars(c)) for c in cls]\n"
        "import paddle_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print([sorted(set(vars(c)) ^ b) for c, b in zip(cls, before)])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[[], [], []]", out.stdout


def test_torch_functions_refuse_a_tensor():
    t = paddle.to_tensor([1.0, 2.0])
    with pytest.raises(TypeError, match="paddle_tpu_torch Tensor"):
        torch.exp(t)
    # a binary operator with a torch tensor falls to the Tensor's reflected
    # operator
    out = torch.ones(2) + t
    assert isinstance(out, Tensor)
    np.testing.assert_array_equal(out.numpy(), [2.0, 3.0])
