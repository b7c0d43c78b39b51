"""Single-device `DistributedTrainStep` (↔ paddle_tpu/distributed/
train_step.py:116).

It takes the reference's signature and runs `jit.TrainStep`. A mesh of
more than one device, `sharding_stage` > 0 and `offload` raise
NotImplementedError: the sharded forms come with the distributed slice
(ROADMAP A9).
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
        if sharding_stage or offload:
            raise NotImplementedError(
                "sharding stages and offload are ported with the "
                "distributed slice (ROADMAP A9)")
        super().__init__(model, loss_fn, optimizer, **kw)
