"""Serving SLO instrumentation shared by both engines
(↔ paddle_tpu/inference/slo.py).

`serving_metrics()` returns the serving metric families of the
process-wide observability registry (`observability.metrics.
default_registry()`), declared through a `HandleCache` so handles survive
`reset_default_registry()`, under the reference's names, buckets and
`engine` label (`engine="dense"` for `ContinuousBatchingEngine`,
`"paged"` for `PagedServingEngine`). Like the reference's they are
process-wide: engines with one label add to the same series, so a caller
that wants one engine's or one run's numbers reads a
`default_registry().delta(snapshot)` around it. The reference's
`serving_prefill_compiles_total` and `BoundedCompileCache` have no
counterpart: the port compiles no prefill program.
"""

from __future__ import annotations

from ..observability.metrics import DEFAULT_BUCKETS, HandleCache

__all__ = ["serving_metrics"]

# tokens/s per finished request: 0.5 .. 4096, x2 per bucket
_TPS_BUCKETS = tuple(0.5 * 2 ** i for i in range(14))


def _build(reg):
    return {
        "ttft": reg.histogram(
            "serving_ttft_seconds",
            "Time from add_request to the request's first generated token",
            labelnames=("engine",)),
        "request_tps": reg.histogram(
            "serving_request_tokens_per_second",
            "Per finished request: generated tokens / (finish - first token)",
            labelnames=("engine",), buckets=_TPS_BUCKETS),
        "step_seconds": reg.histogram(
            "serving_step_seconds",
            "Wall time of one scheduler tick (admit + decode advance)",
            labelnames=("engine",), buckets=DEFAULT_BUCKETS),
        "tokens": reg.counter(
            "serving_tokens_total", "Generated tokens", ("engine",)),
        "requests": reg.counter(
            "serving_requests_total", "Finished requests", ("engine",)),
        "truncations": reg.counter(
            "serving_truncations_total",
            "Requests retired by KV-cache capacity before max_new_tokens/EOS",
            ("engine",)),
        "queue_depth": reg.gauge(
            "serving_queue_depth",
            "Requests waiting (queue=prefill|resume) or live (queue=decode)",
            ("engine", "queue")),
        "pages_free": reg.gauge(
            "serving_pages_free", "Free physical KV pages in the block pool"),
        "pages_total": reg.gauge(
            "serving_pages_total",
            "Allocatable physical KV pages (excludes the reserved null page)"),
        "kv_bytes_per_token": reg.gauge(
            "serving_kv_bytes_per_token",
            "KV-cache HBM bytes per cached token across all layers and both "
            "K/V sides (int8 payload + amortized per-page scales when the "
            "pool is quantized)"),
        "kv_quant_pages": reg.counter(
            "serving_kv_quant_pages_total",
            "KV pages written through the int8 quantized path (prefill "
            "scatters; decode appends requantize in place)"),
        "prefix_lookups": reg.counter(
            "serving_prefix_lookups_total",
            "Prompt-page hash lookups against the shared-prefix map"),
        "prefix_hits": reg.counter(
            "serving_prefix_hits_total",
            "Prompt pages served by an existing shared page (no new page)"),
        "cow_copies": reg.counter(
            "serving_cow_copies_total",
            "Copy-on-write page copies on first divergent write"),
        "preemptions": reg.counter(
            "serving_preemptions_total",
            "Requests evicted to the host spill buffer when the pool ran dry"),
        "preempted_pages": reg.counter(
            "serving_preempted_pages_total",
            "Pages released by preemption"),
        "resumes": reg.counter(
            "serving_resumes_total",
            "Spilled requests re-admitted from the host buffer"),
    }


_HANDLES = HandleCache(_build)


def serving_metrics() -> dict:
    """Current-registry serving metric handles (rebuilt after registry
    resets; a two-attribute read steady-state)."""
    return _HANDLES.get()
