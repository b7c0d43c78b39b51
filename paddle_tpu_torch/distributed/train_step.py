"""Single-device `DistributedTrainStep` (↔ paddle_tpu/distributed/
train_step.py:116).

It takes the reference's signature and runs `jit.TrainStep`. On one device
(no mesh, or a mesh of size 1) `sharding_stage` 1 and 2 are accepted and
run exactly that step: the reference shards optimizer states (stage 1) and
gradients (stage 2) over the `sharding` axis, and over an axis of size 1
both are no-ops (`_opt_state_spec` :170 and `_update_spec` :181 keep the
parameter's own layout). Stage 3, `offload` and a mesh of more than one
device raise NotImplementedError: the sharded forms come with the
distributed slice (ROADMAP A9).
"""

from __future__ import annotations

from ..jit import TrainStep

__all__ = ["DistributedTrainStep"]


class DistributedTrainStep(TrainStep):
    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 input_specs=None, label_specs=None, sharding_stage=None,
                 offload=False, batch_axes=("dp", "sharding"),
                 comm_overlap=None, **kw):
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                "DistributedTrainStep over more than one device is ported "
                "with the distributed slice (ROADMAP A9)")
        if sharding_stage is None:
            sharding_stage = getattr(optimizer, "_sharding_stage", 0)
        if sharding_stage not in (0, 1, 2) or offload:
            raise NotImplementedError(
                "sharding stage 3 and offload are ported with the "
                "distributed slice (ROADMAP A9)")
        self.sharding_stage = sharding_stage
        super().__init__(model, loss_fn, optimizer, **kw)
