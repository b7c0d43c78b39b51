"""Profiler core (↔ paddle_tpu/profiler/profiler.py; reference:
python/paddle/profiler/profiler.py — state machine :89-225, Profiler
:358-900, chrome-trace export :227; host event recording
python/paddle/profiler/utils.py RecordEvent).

Host events (op dispatch through `framework.core`'s op event hook,
`RecordEvent` annotations, the observability spans) are recorded here.
Device events come from `torch.profiler`: where the reference runs
`jax.profiler.start_trace(device_trace_dir)`, each record window with a
`device_trace_dir` and `ProfilerTarget.GPU` among the targets runs
`torch.profiler.profile` (CUDA and CPU activities, CPU alone without a
card) and writes its chrome trace (Kineto's layout) into
`device_trace_dir`, the analog of the reference's CUPTI tracer. The
READY state prepares it (torch.profiler's warm-up: CUPTI's collection is
on before the window opens, so the window's first kernels are not lost to
the start-up). While it runs, `RecordEvent`s and spans are mirrored as
`torch.profiler.record_function` ranges, so they sit on the device
timeline beside the kernels.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from enum import Enum
from typing import Callable, Iterable, Optional

import torch

__all__ = [
    "Profiler",
    "ProfilerState",
    "ProfilerTarget",
    "RecordEvent",
    "SummaryView",
    "export_chrome_tracing",
    "export_protobuf",
    "load_profiler_result",
    "make_scheduler",
]


class ProfilerState(Enum):
    """reference profiler.py:89 — CLOSED/READY/RECORD/RECORD_AND_RETURN."""

    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    """reference profiler.py:110 (CPU/GPU/XPU/CUSTOM_DEVICE); the port's
    device target is GPU, through torch.profiler (TPU keeps its value for
    the reference's callers and traces nothing here)."""

    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class SummaryView(Enum):
    """reference profiler.py:55."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """State scheduler: skip_first CLOSED steps, then cycles of
    closed→ready→record (last record step RECORD_AND_RETURN), `repeat` times
    (0 = forever). reference profiler.py:129."""
    assert (closed >= 0 and ready >= 0 and record > 0 and repeat >= 0
            and skip_first >= 0), "Invalid profiler scheduler arguments"

    def schedule(step: int) -> ProfilerState:
        assert step >= 0
        if step < skip_first:
            return ProfilerState.CLOSED
        step = step - skip_first
        period = closed + ready + record
        if repeat > 0 and step // period >= repeat:
            return ProfilerState.CLOSED
        mod = step % period
        if mod < closed:
            return ProfilerState.CLOSED
        if mod < closed + ready:
            return ProfilerState.READY
        if mod < period - 1:
            return ProfilerState.RECORD
        return ProfilerState.RECORD_AND_RETURN

    return schedule


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None
                          ) -> Callable[["Profiler"], None]:
    """on_trace_ready factory writing chrome-trace JSON per profiling window
    (reference profiler.py:227)."""
    os.makedirs(dir_name, exist_ok=True)

    def handle(prof: "Profiler") -> None:
        name = worker_name or f"{socket.gethostname()}_pid{os.getpid()}"
        path = os.path.join(
            dir_name, f"{name}_time_{int(time.time() * 1000)}.paddle_trace.json")
        prof.export(path, format="json")

    return handle


def export_protobuf(dir_name: str, worker_name: Optional[str] = None
                    ) -> Callable[["Profiler"], None]:
    """reference profiler.py:280 — an alias of the JSON exporter (the
    chrome-trace JSON is the interchange format; the device trace is
    Kineto's JSON in device_trace_dir)."""
    return export_chrome_tracing(dir_name, worker_name)


def load_profiler_result(filename: str) -> dict:
    """Load an exported chrome-trace JSON (reference load_profiler_result)."""
    with open(filename) as f:
        return json.load(f)


class _HostEvent:
    __slots__ = ("name", "start_ns", "end_ns", "tid", "cat")

    def __init__(self, name, start_ns, end_ns, tid, cat):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.tid = tid
        self.cat = cat


_active_profiler: Optional["Profiler"] = None


def _device_range(name):
    """A `torch.profiler.record_function` range entered for `name` while
    the active Profiler runs a device trace, else None."""
    prof = _active_profiler
    if prof is None or not prof._device_tracing:
        return None
    rng = torch.profiler.record_function(name)
    rng.__enter__()
    return rng


class RecordEvent:
    """Host annotation context manager (reference python/paddle/profiler/
    utils.py RecordEvent). Recorded into the active Profiler's host stream
    and, while a device trace runs, mirrored as a
    torch.profiler.record_function range, so it shows up on the device
    timeline (the reference mirrors it as a jax TraceAnnotation)."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._t0 = None
        self._ann = None

    def begin(self):
        self._t0 = time.perf_counter_ns()
        self._ann = _device_range(self.name)

    def end(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        prof = _active_profiler
        if prof is not None and self._t0 is not None and prof._recording:
            prof._add_event(self.name, self._t0, time.perf_counter_ns(),
                            cat="user_defined")
        self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Profiler:
    """reference profiler.py:358.

    Usage:
        with Profiler(scheduler=(2, 5),
                      on_trace_ready=export_chrome_tracing('./log')) as p:
            for batch in loader:
                train_step(batch)
                p.step()
        print(p.summary())
    """

    def __init__(self, *, targets: Optional[Iterable[ProfilerTarget]] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 record_op_events: bool = True, timer_only: bool = False,
                 device_trace_dir: Optional[str] = None,
                 emit_nvtx: bool = False):
        self.targets = list(targets) if targets is not None else [
            ProfilerTarget.CPU, ProfilerTarget.GPU]
        if scheduler is None:
            self.scheduler = _default_scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            self.scheduler = make_scheduler(
                closed=max(start - 1, 0), ready=min(start, 1),
                record=end - start, repeat=1)
        else:
            self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.record_op_events = record_op_events
        self.timer_only = timer_only
        self.device_trace_dir = device_trace_dir
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._events: list[_HostEvent] = []
        self._recording = False
        self._device_tracing = False
        self._torch_prof = None
        self.device_trace_path = None   # the last window's device trace
        self._step_times: list[float] = []
        self._last_step_t = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #

    def _add_event(self, name, t0, t1, cat):
        with self._lock:
            self._events.append(_HostEvent(
                name, t0, t1, threading.get_ident(), cat))

    def _op_hook(self, name, t0, t1):
        self._add_event(name, t0, t1, cat="operator")

    def _device_prepare(self):
        """Create and prepare the window's torch.profiler (CUDA and CPU
        activities; CPU alone without a card) if a device trace is wanted
        and none is prepared."""
        if (self._torch_prof is not None or self.timer_only
                or self.device_trace_dir is None
                or ProfilerTarget.GPU not in self.targets):
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._torch_prof = torch.profiler.profile(activities=acts)
        self._torch_prof.prepare_trace()

    def _device_discard(self):
        """Close a prepared torch.profiler that recorded no window."""
        prof, self._torch_prof = self._torch_prof, None
        if prof is not None:
            prof.start_trace()
            prof.stop_trace()

    def _begin_record(self):
        if self._recording:
            return
        self._recording = True
        self._events = []  # each record window exports only its own events
        if self.timer_only:
            return
        if self.record_op_events:
            from ..framework.core import set_op_event_hook

            set_op_event_hook(self._op_hook)
        self._device_prepare()
        if self._torch_prof is not None:
            self._torch_prof.start_trace()
            self._device_tracing = True

    def _end_record(self):
        if not self._recording:
            return
        self._recording = False
        if self.record_op_events and not self.timer_only:
            from ..framework.core import set_op_event_hook

            set_op_event_hook(None)
        if self._device_tracing:
            self._device_tracing = False
            prof, self._torch_prof = self._torch_prof, None
            prof.stop_trace()
            os.makedirs(self.device_trace_dir, exist_ok=True)
            self.device_trace_path = os.path.join(
                self.device_trace_dir,
                f"{socket.gethostname()}_pid{os.getpid()}_"
                f"{int(time.time() * 1000)}.pt.trace.json")
            prof.export_chrome_trace(self.device_trace_path)

    def _transition(self, new_state):
        old = self.current_state
        self.current_state = new_state
        recording = new_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN)
        was = old in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if new_state == ProfilerState.READY:
            self._device_prepare()
        if recording and not was:
            self._begin_record()
        if old == ProfilerState.RECORD_AND_RETURN:
            # window complete: flush to the handler, then resume/close
            self._end_record()
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
            if recording:
                self._begin_record()
        elif was and not recording:
            self._end_record()

    # ------------------------------------------------------------------ #

    def start(self) -> None:
        global _active_profiler
        _active_profiler = self
        self.step_num = 0
        self._last_step_t = time.perf_counter()
        self._transition(self.scheduler(0))

    def stop(self) -> None:
        """Flush any in-flight record window (the reference invokes the
        trace handler on stop whenever the profiler is recording)."""
        global _active_profiler
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._end_record()
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
            self.current_state = ProfilerState.CLOSED
        else:
            self._end_record()
        self._device_discard()
        if _active_profiler is self:
            _active_profiler = None

    def step(self, num_samples: Optional[int] = None) -> None:
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
        self._last_step_t = now
        self.step_num += 1
        self._transition(self.scheduler(self.step_num))

    def step_info(self, unit: Optional[str] = None) -> str:
        """Throughput line for the recent steps (reference :735)."""
        if not self._step_times:
            return "no steps recorded"
        import numpy as np

        ts = np.asarray(self._step_times[-20:])
        ips = 1.0 / ts.mean() if ts.mean() > 0 else float("inf")
        return (f"batch_cost: {ts.mean():.5f} s, ips: {ips:.3f} "
                f"{unit or 'steps'}/s")

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------------ #

    def export(self, path: str = "", format: str = "json") -> None:
        """Write the host event stream as chrome-trace JSON (reference :853;
        chrometracing_logger.cc format)."""
        events = []
        pid = os.getpid()
        for e in self._events:
            events.append({
                "name": e.name, "ph": "X", "cat": e.cat,
                "ts": e.start_ns / 1000.0,
                "dur": (e.end_ns - e.start_ns) / 1000.0,
                "pid": pid, "tid": e.tid,
            })
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"producer": "paddle_tpu_torch.profiler",
                         "host": socket.gethostname()},
        }
        with open(path, "w") as f:
            json.dump(doc, f)

    def events(self):
        return list(self._events)

    def summary(self, sorted_by=None, op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = "ms",
                views=None) -> str:
        """Overview + per-op host tables + device Kernel Summary parsed from
        the captured device trace (reference :883 backed by
        profiler_statistic.py's overview/operator/kernel tables)."""
        from .statistic import build_summary

        return build_summary(self._events, time_unit=time_unit,
                             device_trace_dir=self.device_trace_dir)
