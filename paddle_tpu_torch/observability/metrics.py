"""Process-wide metrics registry: counters, gauges and histograms with
labels (↔ paddle_tpu/observability/metrics.py, the same code: the
reference module is plain Python, and the port keeps its own copy).

- **No locks on the emit path.** A metric cell is a one-slot mutable box;
  `inc` / `set` / `observe` mutate it under the GIL. The registry lock is
  taken only when a new (metric, label set) cell is made.
- **Deferred aggregation.** `collect()`, the exporters and `snapshot()` /
  `delta()` walk the cells on demand. Cells are only added, never removed.
- **Stdlib only,** so that any module of the port (the collectives, the
  serving engines, the profiler's timer) can emit without an import cycle.

Exporters: `prometheus_text()` writes the Prometheus text exposition
format and `jsonl_events()` one JSON object per sample, byte for byte as
the reference's do for the same sequence of calls.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Iterable, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "HandleCache",
    "MetricsRegistry",
    "default_registry",
    "reset_default_registry",
    "DEFAULT_BUCKETS",
]

# latency-oriented default: 1ms .. ~2min, roughly x4 per bucket
DEFAULT_BUCKETS = (0.001, 0.004, 0.016, 0.064, 0.25, 1.0, 4.0, 16.0, 64.0, 128.0)


def _label_key(labelnames: Sequence[str], labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"metric labels {sorted(labels)} do not match declared "
            f"labelnames {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """Base: a named family of cells, one per label-value combination."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._cells: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def _new_cell(self) -> list:
        raise NotImplementedError

    def _cell(self, labels: dict) -> list:
        key = _label_key(self.labelnames, labels)
        cell = self._cells.get(key)
        if cell is None:
            with self._lock:
                cell = self._cells.setdefault(key, self._new_cell())
        return cell

    def samples(self) -> Iterable[tuple[dict, object]]:
        """(labels dict, cell value view) per label combination."""
        for key, cell in list(self._cells.items()):
            yield dict(zip(self.labelnames, key)), cell


class Counter(_Metric):
    """Monotonic counter. `inc(amount, **labels)`."""

    kind = "counter"

    def _new_cell(self) -> list:
        return [0.0]

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self._cell(labels)[0] += amount

    def value(self, **labels) -> float:
        return self._cell(labels)[0]


class Gauge(_Metric):
    """Point-in-time value. `set(v)`, `inc()`, `dec()`."""

    kind = "gauge"

    def _new_cell(self) -> list:
        return [0.0]

    def set(self, value: float, **labels):
        self._cell(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        self._cell(labels)[0] += amount

    def dec(self, amount: float = 1.0, **labels):
        self._cell(labels)[0] -= amount

    def value(self, **labels) -> float:
        return self._cell(labels)[0]


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics): cell is
    [bucket_counts..., sum, count]; `le` boundaries are upper-inclusive."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _new_cell(self) -> list:
        # one count slot per finite bucket, then sum, then total count
        return [0] * len(self.buckets) + [0.0, 0]

    def observe(self, value: float, **labels):
        cell = self._cell(labels)
        i = bisect.bisect_left(self.buckets, value)
        if i < len(self.buckets):
            cell[i] += 1
        cell[-2] += value
        cell[-1] += 1

    def sum(self, **labels) -> float:
        return self._cell(labels)[-2]

    def count(self, **labels) -> int:
        return self._cell(labels)[-1]

    def mean(self, **labels) -> float:
        cell = self._cell(labels)
        return cell[-2] / cell[-1] if cell[-1] else 0.0


class MetricsRegistry:
    """Named metric families. Re-declaring a name returns the existing
    family (so call sites don't need import-order coordination) but a kind
    or labelname mismatch is an error, never a silent second family."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    # -- declaration ----------------------------------------------------- #

    def _declare(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with labels "
                f"{m.labelnames}; cannot re-declare as {cls.kind} with "
                f"{tuple(labelnames)}")
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        m = self._declare(Histogram, name, help, labelnames, buckets=buckets)
        want = tuple(sorted(float(b) for b in buckets))
        if m.buckets != want:
            # same contract as kind/label mismatches: observations landing
            # in another caller's bucket layout must fail loudly
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{m.buckets}; cannot re-declare with {want}")
        return m

    def get(self, name) -> _Metric | None:
        return self._metrics.get(name)

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    # -- reading --------------------------------------------------------- #

    def collect(self) -> list[dict]:
        """Flat sample list: one dict per (metric, label-set); histograms
        carry their bucket counts inline."""
        out = []
        for m in list(self._metrics.values()):
            for labels, cell in m.samples():
                s = {"metric": m.name, "type": m.kind, "labels": labels}
                if m.kind == "histogram":
                    s["sum"] = cell[-2]
                    s["count"] = cell[-1]
                    s["buckets"] = {
                        str(b): c for b, c in zip(m.buckets, cell[:-2])}
                else:
                    s["value"] = cell[0]
                out.append(s)
        return out

    def snapshot(self) -> dict:
        """Scalar view keyed "name{k=v,...}" — the input to `delta()` (the
        flight recorder stores one of these per dump window)."""
        snap = {}
        for s in self.collect():
            key = _format_series(s["metric"], s["labels"])
            snap[key] = s["count"] if s["type"] == "histogram" else s["value"]
        return snap

    def delta(self, since: dict) -> dict:
        """Per-series change vs an earlier `snapshot()`. Gauges report their
        current value, not a difference (a delta of a point-in-time reading
        is meaningless) — and are ALWAYS included, zero or not: a crash-dump
        reader must be able to tell "heartbeat age 0 (fresh)" from "gauge
        never set". Unchanged counters/histograms are elided."""
        out = {}
        for s in self.collect():
            key = _format_series(s["metric"], s["labels"])
            if s["type"] == "gauge":
                out[key] = s["value"]
                continue
            cur = s["count"] if s["type"] == "histogram" else s["value"]
            d = cur - since.get(key, 0)
            if d:
                out[key] = d
        return out

    # -- exporters ------------------------------------------------------- #

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one HELP/TYPE header per
        family, `_bucket`/`_sum`/`_count` expansion for histograms)."""
        lines = []
        for m in list(self._metrics.values()):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for labels, cell in m.samples():
                if m.kind == "histogram":
                    acc = 0
                    for b, c in zip(m.buckets, cell[:-2]):
                        acc += c
                        lines.append(_prom_line(
                            f"{m.name}_bucket", {**labels, "le": _fmt_num(b)},
                            acc))
                    lines.append(_prom_line(
                        f"{m.name}_bucket", {**labels, "le": "+Inf"},
                        cell[-1]))
                    lines.append(_prom_line(f"{m.name}_sum", labels, cell[-2]))
                    lines.append(_prom_line(f"{m.name}_count", labels, cell[-1]))
                else:
                    lines.append(_prom_line(m.name, labels, cell[0]))
        return "\n".join(lines) + ("\n" if lines else "")

    def jsonl_events(self, ts: float | None = None) -> list[str]:
        """One JSON line per sample. `ts` pins the timestamp (tests use 0);
        default is the current wall clock."""
        if ts is None:
            ts = time.time()
        return [json.dumps({"ts": round(ts, 6), **s}, sort_keys=True)
                for s in self.collect()]

    def export_jsonl(self, path: str, ts: float | None = None):
        lines = self.jsonl_events(ts)
        if lines:
            with open(path, "a") as f:
                f.write("\n".join(lines) + "\n")


def _fmt_num(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _format_series(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _prom_line(name: str, labels: dict, value) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {_fmt_num(value)}"
    return f"{name} {_fmt_num(value)}"


def _escape(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


class HandleCache:
    """Registry-identity-keyed cache of metric handles for hot-path
    emitters: re-declaring through the registry lock on every emission is
    avoidable overhead, but a plain cached handle goes stale when
    `reset_default_registry()` swaps the registry (tests) — emissions would
    land in a dead registry. `build(reg)` runs once per registry instance;
    `get()` is a two-attribute read steady-state.

    The one shared implementation for the collectives, the serving
    metrics, the overlap gauges and profiler/timer.py — keep them on it so
    the invalidation rule can't diverge."""

    __slots__ = ("_build", "_cache")

    def __init__(self, build):
        self._build = build
        self._cache = None  # (registry, handles)

    def get(self):
        reg = default_registry()
        cache = self._cache
        if cache is None or cache[0] is not reg:
            cache = (reg, self._build(reg))
            self._cache = cache
        return cache[1]


_default: MetricsRegistry | None = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every built-in emitter uses."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MetricsRegistry()
    return _default


def reset_default_registry():
    """Drop every registered family (tests)."""
    global _default
    with _default_lock:
        _default = MetricsRegistry()
    return _default
