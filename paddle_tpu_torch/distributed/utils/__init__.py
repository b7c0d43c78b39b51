"""paddle_tpu_torch.distributed.utils (↔ paddle_tpu/distributed/utils/):
the MoE token exchanges `global_scatter` / `global_gather`."""

from .moe_utils import global_gather, global_scatter

__all__ = ["global_gather", "global_scatter"]
