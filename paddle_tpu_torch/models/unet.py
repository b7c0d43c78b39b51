"""Diffusion UNet (↔ paddle_tpu/models/unet.py): `UNetConfig`, `unet_tiny`,
`timestep_embedding`, `ResBlock`, `AttnBlock` and `UNetModel`, the
latent-diffusion UNet of bench.py's unet_sd rung.

NCHW at the API. Residual blocks are GroupNorm -> SiLU -> 3x3 conv twice
with the timestep embedding added in between; the convs are `nn.Conv2D`
(cuDNN on the card: the reference's are XLA convolutions) and the group
norms plain torch ops in f32 (the reference's are jnp). An attention block
flattens H x W into a sequence and runs self-attention and, given a
context, cross-attention through `nn.MultiHeadAttention`, so through
`scaled_dot_product_attention` and the flash kernels on the card: heads of
C / num_heads (80 and 160 at the rung's 640 and 1280 channels). The
down path halves by a stride-2 conv; the up path concatenates the skips,
repeats each position twice along H and W (nearest neighbour) and runs a
3x3 conv (:202-207: no transposed conv). A level without attention or
resampling holds None in its `LayerList`, so the state_dict names are the
reference's (`down_attns.2.self_attn.q_proj.weight`).

Each op casts its inputs for AMP under the JAX package's op name
("res_emb_add", "spatial_flatten", "spatial_unflatten", "unet_skip_cat",
"unet_upsample", "add"). Weights come from an explicit `torch.Generator`
seeded by `seed` with Paddle's default initializers; cross-package tests
copy the JAX weights with `convert.load_paddle_tpu_state`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import amp
from ..device import resolve_device
from ..nn import (Conv2D, GroupNorm, LayerList, LayerNorm, Linear,
                  MultiHeadAttention, Silu)
from ..nn.layer.layers import Layer

__all__ = ["AttnBlock", "ResBlock", "UNetConfig", "UNetModel",
           "timestep_embedding", "unet_tiny"]


class UNetConfig:
    def __init__(self, in_channels=4, out_channels=4, base_channels=128,
                 channel_mult=(1, 2, 4), num_res_blocks=2,
                 attention_levels=(1, 2), num_heads=4, context_dim=512,
                 groups=32):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.base_channels = base_channels
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.attention_levels = tuple(attention_levels)
        self.num_heads = num_heads
        self.context_dim = context_dim
        self.groups = groups


def unet_tiny(**kw):
    return UNetConfig(in_channels=3, out_channels=3, base_channels=32,
                      channel_mult=(1, 2), num_res_blocks=1,
                      attention_levels=(1,), num_heads=2, context_dim=64,
                      groups=8, **kw)


def _add(a, b):
    return torch.add(*amp.cast_inputs("add", a, b))


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal embedding [B, dim] in f32 (DDPM convention): cos then sin
    of t * max_period^(-i / half), i < half = dim // 2."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(Layer):
    def __init__(self, in_c, out_c, emb_dim, groups, *, generator, device,
                 dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        nkw = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm(min(groups, in_c), in_c, **nkw)
        self.conv1 = Conv2D(in_c, out_c, 3, padding=1, **kw)
        self.emb_proj = Linear(emb_dim, out_c, **kw)
        self.norm2 = GroupNorm(min(groups, out_c), out_c, **nkw)
        self.conv2 = Conv2D(out_c, out_c, 3, padding=1, **kw)
        self.skip = Conv2D(in_c, out_c, 1, **kw) if in_c != out_c else None
        self.act = Silu()

    def forward(self, x, emb):
        h = self.conv1(self.act(self.norm1(x)))
        e = self.emb_proj(self.act(emb))
        h, e = amp.cast_inputs("res_emb_add", h, e)
        h = self.conv2(self.act(self.norm2(h + e[:, :, None, None])))
        return _add(h, self.skip(x) if self.skip is not None else x)


class AttnBlock(Layer):
    """Self-attention and cross-attention over the flattened positions."""

    def __init__(self, channels, num_heads, context_dim, groups, *, generator,
                 device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.norm = GroupNorm(min(groups, channels), channels, device=device,
                              dtype=dtype)
        self.self_attn = MultiHeadAttention(channels, num_heads, **kw)
        self.cross_attn = MultiHeadAttention(
            channels, num_heads, kdim=context_dim, vdim=context_dim, **kw)
        self.norm2 = LayerNorm(channels, device=device, dtype=dtype)
        self.proj = Linear(channels, channels, **kw)

    def forward(self, x, context=None):
        B, C, H, W = x.shape
        (n,) = amp.cast_inputs("spatial_flatten", self.norm(x))
        seq = n.reshape(B, C, H * W).transpose(1, 2)
        h = _add(seq, self.self_attn(seq, seq, seq))
        if context is not None:
            h = _add(h, self.cross_attn(self.norm2(h), context, context))
        (h,) = amp.cast_inputs("spatial_unflatten", self.proj(h))
        return _add(x, h.transpose(1, 2).reshape(B, C, H, W))


class UNetModel(Layer):
    """forward(x [B, C, H, W], timesteps [B], context [B, L, D]) ->
    [B, C, H, W]."""

    def __init__(self, cfg: UNetConfig, *, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        self.config = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        kw = dict(generator=gen, device=dev, dtype=dtype)
        nkw = dict(device=dev, dtype=dtype)
        ch = cfg.base_channels
        emb_dim = ch * 4
        self.time_mlp1 = Linear(ch, emb_dim, **kw)
        self.time_mlp2 = Linear(emb_dim, emb_dim, **kw)
        self.conv_in = Conv2D(cfg.in_channels, ch, 3, padding=1, **kw)

        def attn(c, lvl):
            return (AttnBlock(c, cfg.num_heads, cfg.context_dim, cfg.groups, **kw)
                    if lvl in cfg.attention_levels else None)

        self.down_blocks = LayerList()
        self.down_attns = LayerList()
        self.downsamples = LayerList()
        chans = [ch]
        cur = ch
        for lvl, mult in enumerate(cfg.channel_mult):
            out_c = ch * mult
            for _ in range(cfg.num_res_blocks):
                self.down_blocks.append(ResBlock(cur, out_c, emb_dim, cfg.groups, **kw))
                self.down_attns.append(attn(out_c, lvl))
                cur = out_c
                chans.append(cur)
            if lvl < len(cfg.channel_mult) - 1:
                self.downsamples.append(Conv2D(cur, cur, 3, stride=2, padding=1, **kw))
                chans.append(cur)
            else:
                self.downsamples.append(None)

        self.mid_block1 = ResBlock(cur, cur, emb_dim, cfg.groups, **kw)
        self.mid_attn = AttnBlock(cur, cfg.num_heads, cfg.context_dim, cfg.groups, **kw)
        self.mid_block2 = ResBlock(cur, cur, emb_dim, cfg.groups, **kw)

        self.up_blocks = LayerList()
        self.up_attns = LayerList()
        self.upsamples = LayerList()
        for lvl, mult in reversed(list(enumerate(cfg.channel_mult))):
            out_c = ch * mult
            for _ in range(cfg.num_res_blocks + 1):
                skip_c = chans.pop()
                self.up_blocks.append(
                    ResBlock(cur + skip_c, out_c, emb_dim, cfg.groups, **kw))
                self.up_attns.append(attn(out_c, lvl))
                cur = out_c
            self.upsamples.append(
                Conv2D(cur, cur, 3, padding=1, **kw) if lvl > 0 else None)

        self.norm_out = GroupNorm(min(cfg.groups, cur), cur, **nkw)
        self.conv_out = Conv2D(cur, cfg.out_channels, 3, padding=1, **kw)
        self.act = Silu()

    def forward(self, x, timesteps, context=None):
        cfg = self.config
        emb = timestep_embedding(timesteps, cfg.base_channels)
        emb = self.time_mlp2(self.act(self.time_mlp1(emb)))

        h = self.conv_in(x)
        skips = [h]
        i = 0
        for lvl in range(len(cfg.channel_mult)):
            for _ in range(cfg.num_res_blocks):
                h = self.down_blocks[i](h, emb)
                if self.down_attns[i] is not None:
                    h = self.down_attns[i](h, context)
                skips.append(h)
                i += 1
            if self.downsamples[lvl] is not None:
                h = self.downsamples[lvl](h)
                skips.append(h)

        h = self.mid_block1(h, emb)
        h = self.mid_attn(h, context)
        h = self.mid_block2(h, emb)

        i = 0
        for uidx in range(len(cfg.channel_mult)):
            for _ in range(cfg.num_res_blocks + 1):
                h = torch.cat(amp.cast_inputs("unet_skip_cat", h, skips.pop()), dim=1)
                h = self.up_blocks[i](h, emb)
                if self.up_attns[i] is not None:
                    h = self.up_attns[i](h, context)
                i += 1
            if self.upsamples[uidx] is not None:
                (h,) = amp.cast_inputs("unet_upsample", h)
                h = self.upsamples[uidx](
                    h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))

        return self.conv_out(self.act(self.norm_out(h)))
