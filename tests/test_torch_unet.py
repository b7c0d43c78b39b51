"""The port's diffusion UNet (`models.UNetModel`) held to the JAX package's
on the CPU in f32, the weights carried across by `load_paddle_tpu_state`:
`unet_tiny`'s forward with and without a context; a config whose attention
heads are 80 and 160 wide (the unet_sd rung's, through the flash
functions' plain versions here); the step-1 gradients and three AdamW
steps (bf16 moments) of bench.py's unet_sd recipe through
`DistributedTrainStep` with the JAX step on a one-device mesh (losses and
parameters), the state loaded into the port after its step was built; the
same step under O2 (finite, falling losses; GroupNorm parameters in bf16
with f32 outputs); the state_dict names (a level without attention holds
None); `timestep_embedding`.

The JAX references run once for the module, the attention through the
JAX package's composite path, its plain reference (its Pallas kernel in
interpret mode is held to the port's flash functions at D 80 and 160 in
test_torch_flash_attention.py)."""

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import UNetConfig as JaxConfig
from paddle_tpu.models import UNetModel as JaxUNet
from paddle_tpu.models import unet_tiny as jax_tiny
from paddle_tpu.models.unet import timestep_embedding as jax_embedding
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import DistributedTrainStep
from paddle_tpu_torch.models import (UNetConfig, UNetModel,
                                     timestep_embedding, unet_tiny)
from paddle_tpu_torch.optimizer import AdamW

B, HW, CTX, LR, STEPS = 2, 8, 4, 1e-3, 3
# f32 both sides: convs, group norms and attention sum in other orders;
# outputs of O(1) agree to a few 1e-6, losses ~2 to 1e-6 relative
TOL = dict(rtol=1e-4, atol=1e-5)
# The k-projection biases get an analytically zero gradient (q . b_k is
# the same for every key of a row, which the softmax cancels), so both
# packages see rounding noise there: each side's is held under 1e-3 of
# the largest gradient, and the parameters to |diff| <= 2 lr per step:
# AdamW moves each side's by at most about lr a step, in the directions
# of its own noise
NOISE_ONLY = "k_proj.bias"
# After three steps every element is within the same 2 lr a step (an
# element whose gradient sits near the rounding of either side, as a few
# of a 3x3 conv's do, takes AdamW's unit step either way: up to 3e-4
# measured), and each tensor's update, parameters after less before,
# agrees in norm: 7.8e-4 of it at most (measured), held to 2e-3
UPDATE_TOL = 2e-3
# heads of 80 at level 0 (8 x 8 positions) and 160 at level 1 and the
# mid block (4 x 4): the rung's head dims at a few channels' cost
WIDE = dict(in_channels=4, out_channels=4, base_channels=80,
            channel_mult=(1, 2), num_res_blocks=1, attention_levels=(0, 1),
            num_heads=1, context_dim=16, groups=8)


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _inputs(cfg, seed=0, ctx_len=CTX):
    """(noisy latent, int64 timesteps, context, noise target)."""
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(B, cfg.in_channels, HW, HW)).astype(np.float32)
    t = rng.integers(0, 1000, (B,))
    ctx = rng.normal(size=(B, ctx_len, cfg.context_dim)).astype(np.float32)
    noise = rng.normal(size=(B, cfg.out_channels, HW, HW)).astype(np.float32)
    return noisy, t, ctx, noise


def _jt(*xs):
    return [paddle.to_tensor(x) for x in xs]


def _tt(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.fixture(scope="module")
def ref():
    """The JAX unet_tiny and wide model's first weights and forwards, the
    step-1 gradients of an eager backward, and three steps of bench.py's
    recipe (f32) through the JAX DistributedTrainStep."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
        paddle.seed(0)
        jm = JaxUNet(jax_tiny())
        init = _state(jm)
        noisy, t, ctx, noise = _inputs(jax_tiny())
        fwd = jm(*_jt(noisy, t, ctx)).numpy()
        fwd_no_ctx = jm(*_jt(noisy, t)).numpy()
        mse = jnn.MSELoss()
        mse(jm(*_jt(noisy, t, ctx)), *_jt(noise)).backward()
        grads = {k: p.grad.numpy() for k, p in jm.named_parameters()}
        jm.clear_gradients()
        step = jdist.DistributedTrainStep(
            jm, lambda pred, target: mse(pred, target),
            jopt.AdamW(learning_rate=LR, moment_dtype="bfloat16",
                       parameters=jm.parameters()),
            mesh=jdist.build_mesh(devices=jax.devices()[:1]))
        losses = [float(step(_jt(noisy, t, ctx), _jt(noise)))
                  for _ in range(STEPS)]
        step.sync_weights()
        jdist.env.set_global_mesh(None)
        after = _state(jm)

        paddle.seed(1)
        wide = JaxUNet(JaxConfig(**WIDE))
        wnoisy, wt, wctx, _ = _inputs(JaxConfig(**WIDE), seed=1, ctx_len=3)
        wide_out = wide(*_jt(wnoisy, wt, wctx)).numpy()
    return dict(init=init, fwd=fwd, fwd_no_ctx=fwd_no_ctx, grads=grads,
                losses=losses, after=after, wide_init=_state(wide),
                wide_out=wide_out)


def _port(init, cfg=None):
    tm = UNetModel(cfg or unet_tiny(), device="cpu")
    load_paddle_tpu_state(tm, init)
    return tm


def test_state_dict_names_are_the_references(ref):
    tm = UNetModel(unet_tiny(), device="cpu")
    assert sorted(tm.state_dict()) == sorted(ref["init"])
    # level 0 has no attention: its slot holds None, the next is named 1
    assert tm.down_attns[0] is None and tm.upsamples[1] is None
    assert "down_attns.1.self_attn.q_proj.weight" in tm.state_dict()
    assert not any(k.startswith("down_attns.0.") for k in tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(v.shape) == ref["init"][k].shape, k


def test_forward_with_and_without_context_matches_jax(ref):
    tm = _port(ref["init"])
    noisy, t, ctx, _ = _inputs(unet_tiny())
    with torch.no_grad():
        out = tm(*_tt(noisy, t, ctx))
        out_no_ctx = tm(*_tt(noisy, t))
    assert out.shape == (B, 3, HW, HW) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref["fwd"], **TOL)
    np.testing.assert_allclose(out_no_ctx.numpy(), ref["fwd_no_ctx"], **TOL)
    assert np.abs(ref["fwd"] - ref["fwd_no_ctx"]).max() > 1e-3  # the context conditions


def test_heads_of_80_and_160_match_jax(ref):
    """The rung's head dims (80 at 640 channels and 160 at 1280 over 8
    heads) here at 80 and 160 channels over one head, through
    `flash_attention_fwd`'s plain versions on the CPU."""
    tm = _port(ref["wide_init"], UNetConfig(**WIDE))
    assert {m.head_dim for m in tm.modules()
            if isinstance(m, pnn.MultiHeadAttention)} == {80, 160}
    noisy, t, ctx, _ = _inputs(UNetConfig(**WIDE), seed=1, ctx_len=3)
    with torch.no_grad():
        out = tm(*_tt(noisy, t, ctx))
    np.testing.assert_allclose(out.numpy(), ref["wide_out"], **TOL)


def test_gradients_and_three_adamw_steps_match_jax(ref):
    tm = _port(ref["init"])
    noisy, t, ctx, noise = _inputs(unet_tiny())
    mse = pnn.MSELoss()
    mse(tm(*_tt(noisy, t, ctx)), *_tt(noise)).backward()
    gmax = max(float(np.abs(g).max()) for g in ref["grads"].values())
    for k, p in tm.named_parameters():
        want = ref["grads"][k]
        if NOISE_ONLY in k:
            assert max(p.grad.abs().max().item(),
                       float(np.abs(want).max())) <= 1e-3 * gmax, k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                   err_msg=k)

    # bench.py's recipe; the JAX weights loaded once the step is built
    tm = UNetModel(unet_tiny(), device="cpu", seed=5)
    step = DistributedTrainStep(
        tm, lambda pred, target: mse(pred, target),
        AdamW(learning_rate=LR, moment_dtype="bfloat16",
              parameters=tm.parameters()))
    load_paddle_tpu_state(tm, ref["init"])
    losses = [step([noisy, t, ctx], noise).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, v in tm.state_dict().items():
        got, want, init = v.numpy(), ref["after"][k], ref["init"][k]
        assert np.abs(got - want).max() <= 2 * LR * STEPS, k
        if NOISE_ONLY not in k:
            err = np.linalg.norm((got - init) - (want - init))
            assert err <= UPDATE_TOL * np.linalg.norm(want - init), k


def test_o2_step_trains_with_f32_group_norm_outputs(ref):
    """The rung's O2 step (test_amp_conv.py's unet test for the JAX
    package): bf16 parameters but LayerNorm's, the group norms computing
    and returning f32, finite falling losses."""
    tm = _port(ref["init"])
    amp.decorate(tm, level="O2", dtype="bfloat16")
    norms = [m for m in tm.modules() if isinstance(m, pnn.GroupNorm)]
    assert len(norms) == 2 * 8 + 4 + 1  # 8 ResBlocks, 4 AttnBlocks, norm_out
    assert all(n.weight.dtype == torch.bfloat16 for n in norms)
    assert all(m.weight.dtype == torch.float32 for m in tm.modules()
               if isinstance(m, pnn.LayerNorm))
    outs = []
    hooks = [n.register_forward_hook(lambda m, i, o: outs.append(o.dtype))
             for n in norms]
    mse = pnn.MSELoss()
    step = DistributedTrainStep(
        tm, lambda pred, target: mse(pred, target),
        AdamW(learning_rate=LR, moment_dtype="bfloat16",
              parameters=tm.parameters()),
        amp_level="O2", amp_dtype="bfloat16")
    noisy, t, ctx, noise = _inputs(unet_tiny(), seed=1)
    losses = [step([noisy, t, ctx], noise).item() for _ in range(STEPS)]
    for h in hooks:
        h.remove()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert outs and set(outs) == {torch.float32}


def test_timestep_embedding_matches_jax():
    t = np.array([0, 3, 500, 999])
    want = jax_embedding(paddle.to_tensor(t), 32).numpy()
    got = timestep_embedding(torch.from_numpy(t), 32)
    assert got.dtype == torch.float32 and got.shape == (4, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
