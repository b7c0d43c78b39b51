"""paddle_tpu_torch.profiler (↔ paddle_tpu/profiler; reference:
python/paddle/profiler/profiler.py:358 Profiler, :89 ProfilerState, :129
make_scheduler, :227 export_chrome_tracing; RecordEvent
python/paddle/profiler/utils.py).

Host events (op dispatch through the op event hook of `framework.core`,
`RecordEvent` annotations, the observability spans, step timing) are
collected here and exported as a chrome trace and summary tables. Device
events come from `torch.profiler`: with `device_trace_dir` given and
`ProfilerTarget.GPU` among the targets (the default), each record window
runs `torch.profiler.profile` and writes Kineto's chrome trace there, and
`summary()` adds a Kernel Summary parsed from it (`statistic.py`).
"""

from .profiler import (
    Profiler,
    ProfilerState,
    ProfilerTarget,
    RecordEvent,
    SummaryView,
    export_chrome_tracing,
    export_protobuf,
    load_profiler_result,
    make_scheduler,
)
from .timer import benchmark

__all__ = [
    "Profiler",
    "ProfilerState",
    "ProfilerTarget",
    "RecordEvent",
    "SummaryView",
    "benchmark",
    "export_chrome_tracing",
    "export_protobuf",
    "load_profiler_result",
    "make_scheduler",
]
