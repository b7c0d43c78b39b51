"""`DataParallel` and the group-sharded (ZeRO) API
(↔ paddle_tpu/distributed/parallel.py).

In the reference the arrays are global, so `DataParallel` passes through
and the step averages gradients. Here each rank holds its own tensors, so
`DataParallel` is how an eager loop (`loss.backward(); opt.step()`) trains
over ranks: it broadcasts the parameters and buffers from the group's first
rank when it wraps the model, and averages each parameter's gradient over
the group as the backward produces it (a hook on the parameter, so
gradients accumulated over several backwards stay averaged).
`group_sharded_parallel` annotates the model and optimizer with the
stage that `DistributedTrainStep` then runs.
"""

from __future__ import annotations

import torch

from . import collective as C
from . import env as _env
from .train_step import full_state_dict, shard_params_for_stage3

__all__ = ["DataParallel", "group_sharded_parallel", "save_group_sharded_model"]


def _dp_group(group):
    if group is not None:
        return group
    mesh = _env.get_global_mesh()
    return (C.Group(_env.mesh_group(mesh, "dp"), axis_names=("dp",))
            if mesh is not None else C.get_group(0))


class DataParallel(torch.nn.Module):
    """paddle.DataParallel (reference parallel.py:23) over `group` (default:
    the global mesh's dp group, else every rank)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        group = _dp_group(group)
        with torch.no_grad():
            for t in list(layers.parameters()) + list(layers.buffers()):
                C.broadcast(t.data, group.ranks[0], group=group)

        def average(g):
            g = g.clone()
            C._all_reduce(g, group.process_group)
            return g.div_(group.nranks)

        for p in layers.parameters():
            if p.requires_grad:
                p.register_hook(average)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """The gradients are averaged in the backward already."""

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict):
        return self._layers.load_state_dict(state_dict)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True, **kw):
        return self._layers.named_parameters(prefix, recurse, **kw)


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None, exclude_layer=None):
    """reference :68 (group_sharded.py:50): level "os" (stage 1, optimizer
    states sharded), "os_g" (stage 2, and gradients) or "p_g_os" (stage 3,
    and parameters). The model and optimizer are annotated; a
    DistributedTrainStep built on them runs that stage."""
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}.get(level)
    if stage is None:
        raise ValueError(f"level must be os|os_g|p_g_os, got {level!r}")
    if stage == 3:
        shard_params_for_stage3(model)
    optimizer._sharding_stage = stage
    optimizer._sharding_offload = bool(offload)
    model._sharding_stage = stage
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Save the full parameters (stage-3 shards gathered) under the
    reference's names to `output + ".pdmodel"`, and with `optimizer` its
    state by parameter name (each rank's shard, gathered) to
    `output + ".pdopt"`; every rank calls it, the global rank 0 writes."""
    state = full_state_dict(model)
    opt = None
    if optimizer is not None:
        step = getattr(model, "_distributed_step", None)
        inner = getattr(optimizer, "_inner_opt", optimizer)
        opt = {name: {k: (step._gather_state(name, v) if step is not None
                          else v.detach().clone())
                      for k, v in inner._states[id(p)].items()}
               for name, p in inner._names.items() if id(p) in inner._states}
    if _env.get_rank() == 0:
        torch.save({k: v.cpu() for k, v in state.items()}, output + ".pdmodel")
        if opt is not None:
            torch.save({n: {k: v.cpu() for k, v in st.items()}
                        for n, st in opt.items()}, output + ".pdopt")
