"""paddle_tpu_torch.parallel (↔ paddle_tpu/parallel/): the pipeline
schedules over a pp process group (`pipeline`) and ring attention over a
sep process group (`ring`)."""

from .pipeline import (microbatch, pack_chunked, pipeline_1f1b,
                       pipeline_interleaved, pipeline_spmd, stack_pytrees,
                       unmicrobatch, unstack_leading)
from .ring import ring_attention, ring_attention_spmd

__all__ = ["microbatch", "pack_chunked", "pipeline_1f1b",
           "pipeline_interleaved", "pipeline_spmd", "ring_attention",
           "ring_attention_spmd", "stack_pytrees", "unmicrobatch",
           "unstack_leading"]
