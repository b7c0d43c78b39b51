"""Move weights and optimizer state from the JAX package into the port.

Both packages use the same parameter and buffer names and layouts
(Paddle's: a Linear weight is [in, out], a conv weight [out, in / groups,
*k]; a batch norm's running statistics are the f32 buffers `_mean` and
`_variance`; after `ptq_convert_for_serving` a projection holds an int8
`weight_quant`, an f32 `weight_scale` [1, out] and its `bias`; after
`nn.quant.quantize_for_inference` an int8 `weight_quant` [out, in] (int4:
two nibbles a byte, [out, in / 2]) and an f32 `weight_scale` [out] or
[out, groups]; `nn.utils.weight_norm` gives `weight_g` / `weight_v`,
`spectral_norm` `weight_orig` and the buffers `weight_u` / `weight_v`; a
`PReLU` holds `weight`), so `load_paddle_tpu_state` copies each array
into the port tensor of the same name, cast to that tensor's dtype (int8
arrays, packed int4 among them, bit for bit) and placed on its device,
and `load_paddle_tpu_opt_state` carries a JAX
`TrainStep`'s optimizer state (m, v and an optional f32 master per
parameter name) and step count into the port's optimizer, so both packages
can resume from one mid-training state. Both raise on a missing or extra
key and on a shape mismatch, never silently skipping one.

Into a model cut for tensor parallelism (`fleet.layers.mpu.shard_model`,
which a `DistributedTrainStep` over a mesh calls) each full array of an
mp-cut parameter is sliced to this rank's part (`p.mp_part`: dim, rank,
ranks), of an expert shard to this rank's E / n experts (`p.ep_part`, the
same triple, set when the step cuts a `MoELayer` over ep), into a pipelined model cut over pp each full [L, ...] stack to
this rank's stage rows (`p.pp_part`: stages, stage, chunks) before that,
and into a stage-3 model to this rank's sharding shard after both, so a
full state loads on every rank as it stands. A layered GPT state goes into
the pipelined model through `models.stack_layered_state_dict`. The arrays
may be torch tensors too. fp16 and bf16 arrays keep their values (an
O2-decorated model's fp16 parameters, fp16 or bf16 moments); a
`GradScaler`'s `state_dict` is a plain dict of Python numbers in both
packages, so `amp.GradScaler.load_state_dict` takes the reference's as it
is.
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.pipeline import stage_rows

__all__ = ["load_paddle_tpu_opt_state", "load_paddle_tpu_state"]


def _to_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach()
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no torch.from_numpy
        a = a.astype(np.float32)
    return torch.tensor(a)  # a copy: the port never aliases the caller's arrays


def _mp_part(t, p):
    """This rank's part of a full tensor `t` of parameter p: its stage's
    rows of a pipelined model's stack, then its mp or ep part."""
    stage = getattr(p, "pp_part", None)
    if stage is not None:
        t = stage_rows(t, *stage)
    for attr in ("mp_part", "ep_part"):
        part = getattr(p, attr, None)
        if part is not None:
            dim, rank, n = part
            k = t.shape[dim] // n
            t = t.narrow(dim, rank * k, k)
    return t


def _local(model, name, t, p):
    """What this rank holds of the full tensor `t` of model's `name`."""
    t = _mp_part(t, p)
    step = getattr(model, "_distributed_step", None)
    if step is not None and step.sharding_stage == 3 and name in step.params:
        lay = step._cut(name)
        if lay is not None:
            t = lay.shard(t)
    return t


def load_paddle_tpu_state(model: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Copy `{name: np.ndarray}` (a `paddle_tpu` model's state_dict as
    numpy arrays: parameters and buffers) into `model` in place; returns
    `model`."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state_dict keys differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, dst in own.items():
            src = _local(model, name, _to_tensor(state[name]), dst)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.detach().copy_(src.to(dst.dtype))
    return model


def load_paddle_tpu_opt_state(optimizer, opt_states: dict, step: int):
    """Set `optimizer`'s state from `{name: {"m", "v"[, "master"]: array}}`
    (a JAX `TrainStep.opt_states` as numpy arrays) and its step count to
    `step`. The optimizer must know its parameters by name, which a
    `jit.TrainStep` built on it records. Moments keep the dtype the
    optimizer would give them; the master copy is f32."""
    params = optimizer._names
    if not params:
        raise ValueError("the optimizer knows no parameter names: build the "
                         "TrainStep (or DistributedTrainStep) on it first")
    missing = sorted(set(params) - set(opt_states))
    extra = sorted(set(opt_states) - set(params))
    if missing or extra:
        raise KeyError(f"optimizer state keys differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            fresh = optimizer.init_state(p)
            src = opt_states[name]
            if set(src) - {"master"} != set(fresh):
                raise KeyError(f"{name}: state holds {sorted(src)}, the "
                               f"optimizer wants {sorted(fresh)}")
            st = {}
            for key, arr in src.items():
                t = _mp_part(_to_tensor(arr), p)
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"{name}.{key}: shape {tuple(t.shape)} "
                                     f"!= {tuple(p.shape)}")
                dt = torch.float32 if key == "master" else fresh[key].dtype
                st[key] = t.to(device=p.device, dtype=dt)
            optimizer._states[id(p)] = st
    optimizer._step_count = int(step)
    return optimizer
