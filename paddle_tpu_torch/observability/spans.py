"""Nested host spans and the per-step StepTimeline
(↔ paddle_tpu/observability/spans.py).

`span("fwd")` is both a context manager and a decorator. Every span is
reported to two sinks:

- the active `profiler.Profiler` record window (cat ``observability``), so
  spans land on the same chrome trace as the op dispatch events and the
  `RecordEvent` annotations;
- the installed `StepTimeline` (if any), which stitches spans together with
  the other per-step signals: the host syncs that `framework.core`'s sync
  observer chain sees (`Tensor.item()`, `numpy()`, `bool()`, `int()`,
  `float()`) and the `comm_watchdog.comm_task` intervals.

A record carries every key of the reference's record but two that have no
counterpart here: `dispatch` (the port has no dispatch cache: PyTorch runs
each op eagerly) and `autotune` (the port has no tile autotuner yet).

The times are host times. CUDA kernels and NCCL collectives run
asynchronously, as XLA's dispatch does in the reference, so a span or a
`comm_task` interval measures what the host spent enqueueing the work, and
nothing here synchronizes the device; device time comes from the
profiler's trace (`profiler.Profiler` with `ProfilerTarget.GPU`).
"""

from __future__ import annotations

import functools
import json
import threading
import time
from collections import deque

from ..profiler import profiler as _prof_mod

__all__ = [
    "span",
    "StepTimeline",
    "active_timeline",
    "enable_step_timeline",
    "disable_step_timeline",
    "publish_step_record",
    "fleet_step_summary",
    "overlap_stats",
    "record_span",
]

_tls = threading.local()


def _span_stack() -> list:
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    return stack


class span:
    """`with span("fwd"): ...` or `@span("fwd")`. Nesting is tracked per
    thread; the reported name is the slash-joined path ("step/fwd/attn")."""

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._t0 = None
        self._path = None
        self._range = None

    def __enter__(self):
        stack = _span_stack()
        self._path = "/".join([s._path for s in stack[-1:]] + [self.name]) \
            if stack else self.name
        stack.append(self)
        # on the device trace too, while the profiler runs one
        self._range = _prof_mod._device_range(self._path)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        stack = _span_stack()
        depth = len(stack) - 1
        if stack and stack[-1] is self:
            stack.pop()
        _emit_span(self._path or self.name, self._t0, t1, depth, self.attrs)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(self.name, **self.attrs):
                return fn(*args, **kwargs)

        return wrapped


def record_span(name, t0_ns, t1_ns, **attrs):
    """Report an externally measured interval to the span sinks (profiler +
    StepTimeline) after the fact — for windows whose qualification is only
    known at their end."""
    _emit_span(name, t0_ns, t1_ns, len(_span_stack()), attrs)


def _emit_span(path, t0_ns, t1_ns, depth, attrs):
    # profiler sink: only while a record window is open
    prof = _prof_mod._active_profiler
    if prof is not None and prof._recording:
        prof._add_event(path, t0_ns, t1_ns, cat="observability")
    tl = _active_timeline
    if tl is not None:
        tl._on_span(path, t0_ns, t1_ns, depth, attrs)


# --------------------------------------------------------------------------- #
# comm/compute overlap (interval-union math)
# --------------------------------------------------------------------------- #


def _merge_intervals(intervals):
    """[(start, end), ...] -> sorted disjoint union (zero/negative-length
    input intervals are dropped)."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    merged = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _union_len(merged):
    return sum(e - s for s, e in merged)


def _intersect_len(a, b):
    """Total length of the intersection of two DISJOINT-SORTED interval
    lists (two-pointer sweep — O(n+m), not pairwise)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


# comm_task kinds whose intervals join the comm union of the overlap
# accounting; any other kind ("step", ...) is deadline tracking only
COMM_KINDS = ("comm", "a2a")


def overlap_stats(comm_tasks, spans) -> dict:
    """Per-step comm/compute overlap from a step record's interval lists.

    comm intervals: `comm_tasks` entries with a communication kind —
    "comm", or "a2a" (the MoE layer's dispatch and combine all-to-alls,
    measured around the eager calls in distributed/moe_comm.py).
    Deadline-only regions like the trainer's whole-step watchdog tag
    ("step") stay excluded.
    compute intervals: spans explicitly tagged `kind="compute"` — driver
    wrappers span the whole step including its comm, so compute
    attribution is opt-in, not inferred.

    `fraction` is the share of the comm interval UNION covered by the
    compute union (host-observed); a zero-comm
    step reports 1.0 — nothing was exposed. `exposed_s` is the remainder,
    the direct target of the overlap scheduling work.
    """
    comm = _merge_intervals(
        (t.get("start_ns", 0) / 1e9,
         t.get("start_ns", 0) / 1e9 + t.get("dur_s", 0.0))
        for t in comm_tasks if t.get("kind", "comm") in COMM_KINDS)
    compute = _merge_intervals(
        (s.get("start_ns", 0) / 1e9,
         s.get("start_ns", 0) / 1e9 + s.get("dur_s", 0.0))
        for s in spans
        if (s.get("attrs") or {}).get("kind") == "compute")
    comm_s = _union_len(comm)
    covered = _intersect_len(comm, compute) if comm_s else 0.0
    fraction = covered / comm_s if comm_s > 0 else 1.0
    return {
        "fraction": round(min(fraction, 1.0), 6),
        "comm_s": round(comm_s, 6),
        "covered_s": round(covered, 6),
        "exposed_s": round(max(comm_s - covered, 0.0), 6),
    }


def aggregate_overlap(overlaps) -> dict:
    """Roll per-step `overlap` dicts into one: fraction = total covered /
    total comm, 1.0 when there was no comm at all. The one definition of
    the roll-up convention: `fleet_step_summary` and chip_smoke.py's phase
    30 aggregate through here."""
    overlaps = list(overlaps)
    comm = sum(o.get("comm_s", 0.0) for o in overlaps)
    covered = sum(o.get("covered_s", 0.0) for o in overlaps)
    return {
        "fraction": round(covered / comm, 6) if comm > 0 else 1.0,
        "comm_s": round(comm, 6),
        "covered_s": round(covered, 6),
        "exposed_s": round(max(comm - covered, 0.0), 6),
    }


# registry handles for the per-step overlap emission (HandleCache: survives
# reset_default_registry in tests)
_overlap_metrics = None


def _emit_overlap_metrics(ov):
    global _overlap_metrics
    if _overlap_metrics is None:
        from .metrics import HandleCache

        _overlap_metrics = HandleCache(lambda reg: (
            reg.gauge("step_overlap_fraction",
                      "comm interval time covered by concurrent compute "
                      "spans, last step"),
            reg.counter("comm_exposed_seconds_total",
                        "comm interval time NOT covered by compute spans"),
            reg.counter("comm_overlapped_seconds_total",
                        "comm interval time covered by compute spans"),
        ))
    frac, exposed, covered = _overlap_metrics.get()
    frac.set(ov["fraction"])
    if ov["exposed_s"]:
        exposed.inc(ov["exposed_s"])
    if ov["covered_s"]:
        covered.inc(ov["covered_s"])


# --------------------------------------------------------------------------- #
# StepTimeline
# --------------------------------------------------------------------------- #

_active_timeline: "StepTimeline | None" = None


def active_timeline() -> "StepTimeline | None":
    return _active_timeline


class StepTimeline:
    """Stitch one structured record per training step.

    Install it (`enable_step_timeline()` or `.install()`), then have the
    step driver (a training loop, `bench.py --emit-metrics`' recipe in
    chip_smoke.py's phase 30) call `step_begin(i)` / `step_end()`. Everything else
    is collected passively through chained hooks:

    - host syncs via `framework.core.add_sync_observer` (a chain: other
      observers keep working beside it);
    - `comm_task` intervals via `comm_watchdog.add_task_observer`;
    - spans via the module-level `span` sink.

    Records land in a bounded deque (the flight recorder's source), and
    optionally as one JSON line per step in `jsonl_path`.
    """

    def __init__(self, jsonl_path: str | None = None, keep: int = 512,
                 max_spans_per_step: int = 256):
        self.jsonl_path = jsonl_path
        self.records: deque = deque(maxlen=keep)
        self.max_spans_per_step = max_spans_per_step
        self.interstep_syncs = 0
        self._installed = False
        self._cur = None  # in-progress step dict
        self._dropped_spans = 0
        # running total over CLOSED steps — the bounded ring evicts old
        # records, so summing it would undercount on runs longer than `keep`
        self._closed_step_syncs = 0

    # -- hook plumbing --------------------------------------------------- #

    def install(self) -> "StepTimeline":
        global _active_timeline
        if self._installed:
            return self
        from ..distributed import comm_watchdog
        from ..framework import core

        if _active_timeline is not None:
            _active_timeline.uninstall()
        core.add_sync_observer(self._on_sync)
        comm_watchdog.add_task_observer(self._on_comm_task)
        self._installed = True
        _active_timeline = self
        return self

    def uninstall(self):
        global _active_timeline
        if not self._installed:
            return
        from ..distributed import comm_watchdog
        from ..framework import core

        core.remove_sync_observer(self._on_sync)
        comm_watchdog.remove_task_observer(self._on_comm_task)
        self._installed = False
        if _active_timeline is self:
            _active_timeline = None

    # -- passive collectors ---------------------------------------------- #

    def _on_sync(self, kind, tensor):
        cur = self._cur
        if cur is None:
            self.interstep_syncs += 1
        else:
            cur["host_syncs"] += 1
            kinds = cur["sync_kinds"]
            kinds[kind] = kinds.get(kind, 0) + 1
        return None  # never replace the synced value

    def _on_comm_task(self, desc, t0_ns, t1_ns, kind="comm"):
        cur = self._cur
        if cur is not None:
            cur["comm_tasks"].append(
                {"desc": desc, "kind": kind,
                 "start_ns": t0_ns - cur["_t0_ns"],
                 "dur_s": round((t1_ns - t0_ns) / 1e9, 6)})

    def _on_span(self, path, t0_ns, t1_ns, depth, attrs):
        cur = self._cur
        if cur is None:
            return
        if len(cur["spans"]) >= self.max_spans_per_step:
            self._dropped_spans += 1
            return
        rec = {"name": path, "depth": depth,
               "start_ns": t0_ns - cur["_t0_ns"],
               "dur_s": round((t1_ns - t0_ns) / 1e9, 6)}
        if attrs:
            rec["attrs"] = dict(attrs)
        cur["spans"].append(rec)

    # -- step boundaries -------------------------------------------------- #

    def step_begin(self, step: int):
        if self._cur is not None:
            # driver skipped an end (exception path): close what we have
            self.step_end()
        self._cur = {
            "step": int(step),
            "t_wall": time.time(),
            "_t0_ns": time.perf_counter_ns(),
            "host_syncs": 0,
            "sync_kinds": {},
            "comm_tasks": [],
            "spans": [],
        }

    def step_end(self, extra: dict | None = None) -> dict | None:
        cur, self._cur = self._cur, None
        if cur is None:
            return None
        t1 = time.perf_counter_ns()
        overlap = overlap_stats(cur["comm_tasks"], cur["spans"])
        record = {
            "step": cur["step"],
            "t_wall": round(cur["t_wall"], 6),
            "dur_s": round((t1 - cur.pop("_t0_ns")) / 1e9, 6),
            "host_syncs": cur["host_syncs"],
            "sync_kinds": cur["sync_kinds"],
            "comm_tasks": cur["comm_tasks"],
            "spans": cur["spans"],
            "overlap": overlap,
            "overlap_fraction": overlap["fraction"],
        }
        if extra:
            record.update(extra)
        _emit_overlap_metrics(overlap)
        self._closed_step_syncs += record["host_syncs"]
        self.records.append(record)
        if self.jsonl_path:
            # default=repr: span attrs / extra are user-fed (numpy scalars
            # included) and must never abort the training step over a
            # serialization TypeError
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record, sort_keys=True, default=repr)
                        + "\n")
        from . import flight

        flight.feed_step(record)
        return record

    # -- reading ---------------------------------------------------------- #

    def total_host_syncs(self) -> int:
        """Every sync observed since install: closed steps + between-step +
        the in-progress step (right even after the ring has evicted early
        records)."""
        n = self.interstep_syncs + self._closed_step_syncs
        if self._cur is not None:
            n += self._cur["host_syncs"]
        return n


def enable_step_timeline(jsonl_path: str | None = None, keep: int = 512
                         ) -> StepTimeline:
    """Create + install a StepTimeline (replacing any active one)."""
    return StepTimeline(jsonl_path=jsonl_path, keep=keep).install()


def disable_step_timeline():
    if _active_timeline is not None:
        _active_timeline.uninstall()


# --------------------------------------------------------------------------- #
# cross-rank aggregation over the rendezvous store
# --------------------------------------------------------------------------- #


def publish_step_record(store, rank: int, record: dict,
                        prefix: str = "telemetry"):
    """Every rank publishes its step record; any TCPStore-shaped object
    (set/get/tryget) works, including the fleet's rendezvous store."""
    store.set(f"{prefix}/step{record['step']}/rank{rank}",
              json.dumps(record, sort_keys=True, default=repr))


def fleet_step_summary(store, world_size: int, step: int,
                       prefix: str = "telemetry", timeout: float = 30.0
                       ) -> dict:
    """Rank 0 gathers every rank's record for `step` and reduces it to one
    fleet line: step-time spread (the straggler signal), total host
    syncs, total comm time. The reference's line also sums `dispatch`,
    which the port's records lack."""
    recs = []
    deadline = time.monotonic() + timeout
    for r in range(world_size):
        key = f"{prefix}/step{step}/rank{r}"
        raw = None
        tryget = getattr(store, "tryget", None)
        while raw is None:
            if tryget is not None:
                raw = tryget(key)
            else:
                # get-only stores: poll through absent-key errors so the
                # deadline still applies. (A get() that BLOCKS internally
                # is outside this contract — TCPStore exposes tryget for
                # exactly this reason.)
                try:
                    raw = store.get(key)
                except (KeyError, RuntimeError):
                    raw = None  # absent key: retry until the deadline
            if raw is None:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet_step_summary: rank {r} never published "
                        f"{key} within {timeout}s")
                time.sleep(0.02)
        recs.append(json.loads(raw))
    durs = [rec["dur_s"] for rec in recs]
    slowest = max(range(world_size), key=lambda i: durs[i])
    # overlap aggregate over ranks (records predating the overlap field
    # contribute zeros)
    fleet_overlap = aggregate_overlap(rec.get("overlap") or {}
                                      for rec in recs)
    return {
        "step": step,
        "ranks": world_size,
        "step_time_s": {
            "min": min(durs),
            "max": max(durs),
            "mean": sum(durs) / len(durs),
        },
        "straggler_rank": slowest,
        "host_syncs": sum(rec["host_syncs"] for rec in recs),
        "comm_task_s": round(sum(t["dur_s"] for rec in recs
                                 for t in rec["comm_tasks"]), 6),
        "overlap": fleet_overlap,
    }
