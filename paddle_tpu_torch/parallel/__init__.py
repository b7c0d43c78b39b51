"""paddle_tpu_torch.parallel (↔ paddle_tpu/parallel/): the pipeline
schedules over a pp process group (`pipeline`)."""

from .pipeline import (microbatch, pack_chunked, pipeline_1f1b,
                       pipeline_interleaved, pipeline_spmd, stack_pytrees,
                       unmicrobatch, unstack_leading)

__all__ = ["microbatch", "pack_chunked", "pipeline_1f1b",
           "pipeline_interleaved", "pipeline_spmd", "stack_pytrees",
           "unmicrobatch", "unstack_leading"]
