"""Throughput benchmark timer (↔ paddle_tpu/profiler/timer.py; reference:
python/paddle/profiler/timer.py — Benchmark with reader_cost / batch_cost /
ips). Each window sample is mirrored into the observability registry as
`benchmark_cost_seconds{phase=reader|batch}`."""

from __future__ import annotations

import time

__all__ = ["benchmark", "Benchmark"]


class _Window:
    def __init__(self, cap=50):
        self.cap = cap
        self.vals = []

    def add(self, v):
        self.vals.append(v)
        if len(self.vals) > self.cap:
            self.vals.pop(0)

    @property
    def avg(self):
        return sum(self.vals) / len(self.vals) if self.vals else 0.0


class Benchmark:
    """Collects reader/batch costs; `ips` = samples (or steps) per second.
    reference timer.py Benchmark; enabled via benchmark().begin()."""

    def __init__(self):
        self.reader = _Window()
        self.batch = _Window()
        self._batch_start = None
        self._reader_done = None
        self.num_samples = None
        self._enabled = False

    # hooks -------------------------------------------------------------- #

    def begin(self):
        self._enabled = True
        self._batch_start = time.perf_counter()

    def before_reader(self):
        pass

    def after_reader(self):
        if not self._enabled or self._batch_start is None:
            return
        dt = time.perf_counter() - self._batch_start
        self.reader.add(dt)
        self._metric().observe(dt, phase="reader")

    def after_step(self, num_samples=None):
        if not self._enabled or self._batch_start is None:
            return
        now = time.perf_counter()
        dt = now - self._batch_start
        self.batch.add(dt)
        self._metric().observe(dt, phase="batch")
        self.num_samples = num_samples
        self._batch_start = now

    def _metric(self):
        """Mirror every window sample into the observability registry so the
        timer's step_info and telemetry exports read the same data (handle
        cached per registry instance — see metrics.HandleCache)."""
        cache = getattr(self, "_metric_cache", None)
        if cache is None:
            from ..observability.metrics import HandleCache

            cache = self._metric_cache = HandleCache(
                lambda reg: reg.histogram(
                    "benchmark_cost_seconds",
                    "timer.Benchmark reader/batch costs", ("phase",)))
        return cache.get()

    def end(self):
        self._enabled = False

    # reporting ---------------------------------------------------------- #

    @property
    def ips(self):
        b = self.batch.avg
        if b <= 0:
            return 0.0
        return (self.num_samples or 1) / b

    def step_info(self, unit="samples"):
        return (f"reader_cost: {self.reader.avg:.5f} s, "
                f"batch_cost: {self.batch.avg:.5f} s, "
                f"ips: {self.ips:.3f} {unit}/s")


_bench = Benchmark()


def benchmark() -> Benchmark:
    """Global Benchmark singleton (reference timer.py benchmark())."""
    return _bench
