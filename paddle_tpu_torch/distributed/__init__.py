"""paddle_tpu_torch.distributed: so far the single-device
`DistributedTrainStep` (ROADMAP A9 brings the mesh)."""

from .train_step import DistributedTrainStep

__all__ = ["DistributedTrainStep"]
