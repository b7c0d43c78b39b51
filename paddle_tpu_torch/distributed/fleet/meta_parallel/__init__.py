"""The meta-parallel model wrappers (↔ paddle_tpu/distributed/fleet/meta_parallel/):
`TensorParallel` (`tensor_parallel`), `SegmentParallel`
(`segment_parallel`), and the pipeline's `LayerDesc`, `SharedLayerDesc`
and `PipelineLayer` (`pp_layers`) and `PipelineParallel`
(`pipeline_parallel`)."""

from .pipeline_parallel import PipelineParallel
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .segment_parallel import SegmentParallel
from .tensor_parallel import TensorParallel

__all__ = ["LayerDesc", "PipelineLayer", "PipelineParallel",
           "SegmentParallel", "SharedLayerDesc", "TensorParallel"]
