"""Normalization functionals (↔ paddle_tpu/nn/functional/norm.py).

`layer_norm` over one axis and `rms_norm` go through
`paddle_tpu_torch.ops.fused_norm.FusedNorm`: the forward and dx kernels on a
CUDA tensor, their plain versions on a CPU tensor, so a LayerNorm carries a
`grad_fn` like any other op. A LayerNorm over several trailing axes is the
plain composite, as in the JAX package. Both cast their inputs for AMP as
the ops "layer_norm" and "rms_norm" (black list: float32).

`batch_norm` (:120) follows Paddle, not torch, in three ways:

- the running statistics move as r = m * r + (1 - m) * batch with
  `momentum` m = 0.9 (torch's momentum is 1 - m);
- the running variance takes the biased batch variance (`jnp.var`, :159;
  `torch.nn.functional.batch_norm` writes the unbiased one);
- `use_global_stats` normalises with the running statistics in training
  too, and leaves them as they are.

The running statistics are updated IN PLACE on the buffers given (the JAX
package's eager path swaps in fresh arrays, its compiled step threads
them through the program): the forward of a training step updates them
once. In training the batch statistics are f32, the mean first and then
the centred variance, as the reference's. Inside `batch_stats_over(group)`
(which `DistributedTrainStep` opens over its batch ranks, and
`SyncBatchNorm` over its own group) they are those of the batch of every
rank of the group: the per-channel row count, sum and centred sum of
squares are all-reduced over it before the input is normalised, and the
backward all-reduces the per-channel sums of dy and dy * x_hat, so the
output, the gradients and the running statistics equal those of one batch
norm over the global batch, which the reference's global arrays give it.
The group is never skipped for its size: over one rank the all-reduces
are over one rank. Its inputs are cast for AMP as the op "batch_norm"
(black list: float32).

`group_norm` (:217) and `instance_norm` (:190) are jnp in the reference,
with no Pallas kernel, so they are plain torch ops here: statistics in f32
(the biased variance), the output in the dtype of the input as AMP cast
it. Both are on the black list, so under O2 they compute in f32 and return
f32 even where `amp.decorate` left their parameters in bf16 (it keeps only
LayerNorm and the batch norms in f32). `group_norm` takes "NC*" or "N*C";
`instance_norm` normalises over every dim past the first two whatever
`data_format` says, as the reference's does.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ... import amp
from ...framework.core import report_op
from ...ops.fused_norm import layer_norm_fwd, rms_norm_fwd

__all__ = ["batch_norm", "batch_stats_group", "batch_stats_over",
           "group_norm", "instance_norm", "layer_norm", "normalize",
           "rms_norm"]

# the process group whose ranks' batches one batch norm spans, else None
_STATS_GROUP = contextvars.ContextVar("batch_stats_group", default=None)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p along `axis`, epsilon) (↔ :48)."""
    (x,) = amp.cast_inputs("normalize", x)
    nrm = x.abs().pow(p).sum(dim=axis, keepdim=True).pow(1.0 / p)
    out = x / nrm.clamp(min=epsilon)
    return report_op("normalize", out)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(normalized_shape)
    x, weight, bias = amp.cast_inputs("layer_norm", x, weight, bias)
    if n_axes == 1:
        return layer_norm_fwd(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    x32 = x.float()
    mean = x32.mean(axes, keepdim=True)
    var = (x32 - mean).square().mean(axes, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return report_op("layer_norm", out.to(x.dtype))


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis with f32 statistics."""
    x, weight = amp.cast_inputs("rms_norm", x, weight)
    return rms_norm_fwd(x, weight, epsilon)


@contextlib.contextmanager
def batch_stats_over(group):
    """Within the block, `batch_norm` in training takes its batch
    statistics over the batches of every rank of `group` (a process group;
    None: this rank's batch alone)."""
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


def batch_stats_group():
    """The group `batch_stats_over` set for the calling code, or None."""
    return _STATS_GROUP.get()


def _sum_over(t, group):
    """t summed over the ranks of `group` (t itself when None)."""
    if group is None:
        return t
    from ...distributed.collective import all_reduce_sum

    return all_reduce_sum(t, group)


class _BatchNormTrain(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * w + b with the batch's mean and
    biased variance over every dim but `ch` (and over the ranks of
    `group`); returns (y, mean, var), the last two without a gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, ch, eps, group):
        dims = [d for d in range(x.dim()) if d != ch]
        shape = [1] * x.dim()
        shape[ch] = x.shape[ch]
        x32 = x.float()
        head = torch.cat([x32.new_full((1,), float(x.numel() // x.shape[ch])),
                          x32.sum(dims)])
        head = _sum_over(head, group)
        count, mean = head[0], head[1:] / head[0]
        centred = x32 - mean.view(shape)
        var = _sum_over(centred.square().sum(dims), group) / count
        invstd = torch.rsqrt(var + eps)
        scale = invstd if weight is None else invstd * weight.float()
        y = centred.mul_(scale.view(shape))
        if bias is not None:
            y = y.add_(bias.float().view(shape))
        ctx.save_for_backward(x, weight, bias, mean, invstd, count)
        ctx.ch, ctx.group = ch, group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        x, weight, bias, mean, invstd, count = ctx.saved_tensors
        ch = ctx.ch
        dims = [d for d in range(x.dim()) if d != ch]
        shape = [1] * x.dim()
        shape[ch] = x.shape[ch]
        g32 = g.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sums = torch.stack([g32.sum(dims), (g32 * xhat).sum(dims)])
        dweight = None if weight is None else sums[1].to(weight.dtype)
        dbias = None if bias is None else sums[0].to(bias.dtype)
        # dx needs the sums over every rank's rows (every rank's loss
        # reads the shared statistics); dweight and dbias are this rank's,
        # which the step reduces like any gradient
        sums = _sum_over(sums, ctx.group) / count
        scale = invstd if weight is None else invstd * weight.float()
        dx = (g32 - sums[0].view(shape) - xhat * sums[1].view(shape)) \
            * scale.view(shape)
        return dx.to(x.dtype), dweight, dbias, None, None, None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every dim but the channel's (dim 1 for "NC*", the
    last for "N*C"); in training (and not `use_global_stats`) with the
    batch's statistics, which update `running_mean` / `running_var` in
    place (module docstring)."""
    x, weight, bias = amp.cast_inputs("batch_norm", x, weight, bias)
    ch = x.dim() - 1 if not data_format.startswith("NC") else 1
    if training and not use_global_stats:
        out, mean, var = _BatchNormTrain.apply(x, weight, bias, ch, epsilon,
                                               _STATS_GROUP.get())
        with torch.no_grad():   # in place: the buffers are the layer's state
            for r, b in ((running_mean, mean), (running_var, var)):
                r.copy_(momentum * r.float() + (1 - momentum) * b)
        return out
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    out = (x.float() - running_mean.float().view(shape)) * torch.rsqrt(
        running_var.float().view(shape) + epsilon)
    if weight is not None:
        out = out * weight.float().view(shape)
    if bias is not None:
        out = out + bias.float().view(shape)
    return out.to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalise each of `num_groups` groups of channels of each sample
    over its channels and positions (f32 statistics, the biased variance),
    then scale and shift per channel; "NC*" or "N*C"."""
    x, weight, bias = amp.cast_inputs("group_norm", x, weight, bias)
    channels_last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if channels_last else x
    out = torch.nn.functional.group_norm(
        a.float(), int(num_groups), None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon).to(x.dtype)
    return out.movedim(1, -1) if channels_last else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Normalise each (sample, channel) over dims 2.. with f32 statistics
    (the biased variance), then scale and shift per channel along dim 1.
    As in the reference, the running statistics, `use_input_stats`,
    `momentum` and `data_format` are not read."""
    x, weight, bias = amp.cast_inputs("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.dim()))
    x32 = x.float()
    mean = x32.mean(axes, keepdim=True)
    var = (x32 - mean).square().mean(axes, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.float().view(shape)
    if bias is not None:
        out = out + bias.float().view(shape)
    return out.to(x.dtype)
