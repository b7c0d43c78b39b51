"""The tensor-parallel model wrapper `TensorParallel`
(↔ paddle_tpu/distributed/fleet/meta_parallel/__init__.py; reference
fleet/__init__.py:84-85).

`TensorParallel(model, hcg)` cuts the model's tensor-parallel layers over
the topology's mp group (`fleet.layers.mpu.shard_model`), broadcasts every
parameter that is not cut, and every buffer, from the mp group's first
rank, and is then the `DataParallel` of the batch ranks (dp x sharding,
and sep for a `context_parallel` model, whose ranks feed their chunks of
the sequence): the parameters broadcast over them and each gradient
averaged over them in the backward. An eager loop (`loss.backward(); opt.step()`) so trains over
the mesh; a sequence-parallel model's loop also calls
`register_sequence_parallel_allreduce_hooks`.
"""

from __future__ import annotations

import torch

from ... import collective as C
from ... import env as _env
from ...parallel import DataParallel
from ..layers.mpu.mp_layers import is_distributed, shard_model

__all__ = ["TensorParallel"]


def cut_over_mp(layers, hcg):
    """Cut `layers`' tensor-parallel layers over the topology's mp group,
    and broadcast every parameter that is not cut, and every buffer, from
    the group's first rank."""
    group = hcg.get_model_parallel_group()
    shard_model(layers, group)
    with torch.no_grad():
        for t in list(layers.parameters()) + list(layers.buffers()):
            if not is_distributed(t):
                C.broadcast(t.data, group.ranks[0], group=group)


class TensorParallel(DataParallel):
    def __init__(self, layers, hcg, strategy=None):
        cut_over_mp(layers, hcg)
        group = hcg.get_dp_sharding_parallel_group()
        if getattr(getattr(layers, "config", None), "context_parallel", False):
            axes = ("dp", "sharding", "sep")
            group = C.Group(_env.mesh_group(hcg.mesh, axes), axis_names=axes)
        super().__init__(layers, strategy, group=group)
        self._hcg = hcg
