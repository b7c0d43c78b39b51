"""Serving SLO instrumentation (↔ paddle_tpu/inference/slo.py).

`serving_metrics()` returns a fresh set of counters, gauges and histograms
under the same keys and metric names as the JAX package's
`serving_metrics()` (tokens, requests, truncations, ttft, step_seconds,
queue depth, pages, int8 pages written, preemptions, resumes, prefix hits
and lookups, COW copies). Each engine owns one set and hands it to its pool
and scheduler, so two engines in one process never mix their numbers. The
port has no observability registry yet, and nothing compiles, so there is
no `BoundedCompileCache`.
"""

from __future__ import annotations

__all__ = ["Counter", "Gauge", "Histogram", "serving_metrics"]


class _Family:
    """One metric name with per-label-set series."""

    def __init__(self, name, doc, labelnames=()):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._series = {}

    def _key(self, labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {tuple(labels)}")
        return tuple(labels[k] for k in self.labelnames)


class Counter(_Family):
    def inc(self, amount=1, **labels):
        k = self._key(labels)
        self._series[k] = self._series.get(k, 0) + amount

    def value(self, **labels):
        return self._series.get(self._key(labels), 0)


class Gauge(_Family):
    def set(self, value, **labels):
        self._series[self._key(labels)] = value

    def value(self, **labels):
        return self._series.get(self._key(labels), 0)


class Histogram(_Family):
    """Keeps every observation (a serving run observes a few per tick)."""

    def observe(self, value, **labels):
        self._series.setdefault(self._key(labels), []).append(float(value))

    def values(self, **labels):
        return list(self._series.get(self._key(labels), []))

    def count(self, **labels):
        return len(self._series.get(self._key(labels), []))


def serving_metrics() -> dict:
    """A new, empty set of the serving metric handles."""
    eng = ("engine",)
    return {
        "ttft": Histogram(
            "serving_ttft_seconds",
            "Time from add_request to the request's first generated token", eng),
        "request_tps": Histogram(
            "serving_request_tokens_per_second",
            "Per finished request: generated tokens / (finish - first token)", eng),
        "step_seconds": Histogram(
            "serving_step_seconds",
            "Wall time of one scheduler tick (admit + decode advance)", eng),
        "tokens": Counter("serving_tokens_total", "Generated tokens", eng),
        "requests": Counter("serving_requests_total", "Finished requests", eng),
        "truncations": Counter(
            "serving_truncations_total",
            "Requests retired by KV-cache capacity before max_new_tokens/EOS", eng),
        "queue_depth": Gauge(
            "serving_queue_depth",
            "Requests waiting (queue=prefill|resume) or live (queue=decode)",
            ("engine", "queue")),
        "pages_free": Gauge(
            "serving_pages_free", "Free physical KV pages in the block pool"),
        "pages_total": Gauge(
            "serving_pages_total",
            "Allocatable physical KV pages (excludes the reserved null page)"),
        "kv_bytes_per_token": Gauge(
            "serving_kv_bytes_per_token",
            "KV-cache bytes per cached token across all layers and both K/V sides"),
        "kv_quant_pages": Counter(
            "serving_kv_quant_pages_total",
            "KV pages written through the int8 quantized path (prefill "
            "scatters; decode appends requantize in place)"),
        "prefix_lookups": Counter(
            "serving_prefix_lookups_total",
            "Prompt-page hash lookups against the shared-prefix map"),
        "prefix_hits": Counter(
            "serving_prefix_hits_total",
            "Prompt pages served by an existing shared page (no new page)"),
        "cow_copies": Counter(
            "serving_cow_copies_total",
            "Copy-on-write page copies on first divergent write"),
        "preemptions": Counter(
            "serving_preemptions_total",
            "Requests evicted to the host spill buffer when the pool ran dry"),
        "preempted_pages": Counter(
            "serving_preempted_pages_total", "Pages released by preemption"),
        "resumes": Counter(
            "serving_resumes_total",
            "Spilled requests re-admitted from the host buffer"),
    }
