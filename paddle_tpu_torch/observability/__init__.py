"""paddle_tpu_torch.observability (↔ paddle_tpu/observability): the
telemetry layer.

- `metrics` — process-wide counters, gauges and histograms with labels;
  lock-free emission, JSONL and Prometheus text exporters. The port's
  collectives (`collective_calls_total{op=}`,
  `collective_bytes_total{op=}`) and serving engines (`serving_*{engine=}`)
  emit here.
- `spans` — nested `span()` context/decorator feeding the profiler's
  chrome trace and the per-step `StepTimeline`, which stitches host spans,
  `comm_task` intervals and the observed host syncs into one record per
  training step (cross-rank aggregation over a store with
  `fleet_step_summary`).
- `flight` — a bounded ring of recent step records and metric deltas,
  dumped to a post-mortem file on a crash or SIGTERM.
"""

from . import flight, metrics, spans
from .flight import (
    FlightRecorder,
    get_recorder,
    install_crash_handlers,
    reset_recorder,
    uninstall_crash_handlers,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    reset_default_registry,
)
from .spans import (
    StepTimeline,
    active_timeline,
    disable_step_timeline,
    enable_step_timeline,
    fleet_step_summary,
    overlap_stats,
    publish_step_record,
    span,
)

__all__ = [
    "metrics",
    "spans",
    "flight",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "reset_default_registry",
    "span",
    "StepTimeline",
    "active_timeline",
    "enable_step_timeline",
    "disable_step_timeline",
    "publish_step_record",
    "fleet_step_summary",
    "overlap_stats",
    "FlightRecorder",
    "get_recorder",
    "reset_recorder",
    "install_crash_handlers",
    "uninstall_crash_handlers",
]
