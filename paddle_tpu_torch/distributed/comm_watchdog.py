"""Collective hang watchdog: a native monitor thread that flags stuck
regions (↔ paddle_tpu/distributed/comm_watchdog.py).

Reference: CommTaskManager (paddle/phi/core/distributed/comm_task_manager.h:37)
with per-collective timeout tracking (comm_task.h:127 IsTimeout).

The tracked unit is a blocking host region: an eager collective, the
training step's input copy, its gathers, reduce-scatters and all-reduces,
the MoE layer's all-to-alls. Wrap a region in `comm_task(...)`; the
native thread (`csrc/host/watchdog.cc`, built by `framework.native`) flags
any region past its deadline, and the report surfaces on the next poll or
in the spill file. On the card a region times what the host spent
enqueueing the work (NCCL runs asynchronously), as the reference's regions
time XLA's dispatch.

The task observers (`add_task_observer`) see every region's interval
whether or not the watchdog is enabled: the `StepTimeline` stitches them
into its step records.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import threading
import time

from ..framework import native

__all__ = ["enable", "disable", "comm_task", "record_task", "drain_report",
           "peek_report",
           "report_events", "timeout_count", "inflight", "add_task_observer",
           "remove_task_observer"]

_wd = None
_lock = threading.Lock()
_spill = None  # (thread, stop_event)

# Report plumbing: the native buffer is drain-only (watchdog_drain_report
# clears it), but two consumers need the text — the destructive spill/trainer
# path AND the flight recorder's non-destructive peek. Every native drain is
# pumped into a bounded Python-side history; drain_report() consumes from a
# cursor (each caller sees fresh text exactly once, preserving the old
# append-to-file semantics), peek_report()/report_events() read the whole
# retained history without advancing anything.
_report_history: list[str] = []
_report_cursor = 0  # history entries already handed out by drain_report
_REPORT_HISTORY_CAP = 1 << 20  # bytes retained for peek

# comm_task interval observers: fn(desc, start_ns, end_ns, kind), fired on
# region exit whether or not the native watchdog is enabled — the
# StepTimeline's source for per-step collective/blocking intervals. `kind`
# classifies the region for the overlap accounting (spans.overlap_stats):
# "comm" regions are communication whose exposure matters; other kinds
# ("step" for the trainer's whole-step watchdog region) are deadline
# tracking only and stay out of the comm interval union.
_task_observers: list = []


def add_task_observer(fn):
    _task_observers.append(fn)
    return fn


def record_task(desc: str, t0_ns: int, t1_ns: int, kind: str = "comm"):
    """Feed one already-timed interval to the task observers without
    entering a tracked region: the timeline-stitching side of comm_task
    for callers whose interval boundaries the host cannot wrap."""
    for fn in list(_task_observers):
        try:
            fn(desc, int(t0_ns), int(t1_ns), kind)
        except Exception as e:  # noqa: BLE001
            import sys

            print(f"[comm_watchdog] task observer failed: {e!r}",
                  file=sys.stderr)


def remove_task_observer(fn):
    try:
        _task_observers.remove(fn)
    except ValueError:
        pass


def _pump_locked():
    """Drain the native buffer into the history (caller holds _lock)."""
    global _report_cursor
    if _wd is None:
        return
    lib, h = _wd
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib.watchdog_drain_report(h, buf, len(buf))
    if n > 0:
        _report_history.append(buf.raw[:n].decode(errors="replace"))
        # bound retained memory: trim oldest entries past the cap. Entries
        # not yet handed out by drain_report are trimmed too (a peek-only
        # consumer must not grow the history without bound on a long job
        # with many timeouts) — under cap pressure the oldest text is gone
        # for both channels, newest-first retention being the useful half.
        total = sum(len(s) for s in _report_history)
        while total > _REPORT_HISTORY_CAP and len(_report_history) > 1:
            total -= len(_report_history.pop(0))
            _report_cursor = max(0, _report_cursor - 1)


def _spill_once(path, fatal):
    report = drain_report()
    if not report:
        return
    try:
        with open(path, "a") as f:
            f.write(report)
            f.flush()
            os.fsync(f.fileno())
    except OSError as e:
        # the drain already emptied the native buffer — losing the report
        # here would erase the only record of the hang; stderr (→ worker
        # log) is the fallback channel
        import sys

        print(f"[comm_watchdog] report file {path} unwritable ({e}); "
              f"report follows:\n{report}", file=sys.stderr, flush=True)
    if fatal:
        # a hung step can't log its own death — this line, written by the
        # spill thread, is what a supervisor watching the log matches on to
        # tear the wedged worker down
        import sys

        print("FatalError: comm watchdog deadline exceeded\n" + report,
              file=sys.stderr, flush=True)


def _spill_loop(stop, path, fatal, interval=0.5):
    while not stop.wait(interval):
        if _wd is None:
            return
        _spill_once(path, fatal)


def enable(timeout_seconds=None, report_file=None):
    """Start the watchdog (idempotent); returns True. Default timeout from
    FLAGS_pg_timeout-equivalent env PADDLE_PG_TIMEOUT (seconds, default 1800).
    The host runtime is built at first use; a failed build raises
    (`framework.native`), where the reference returns False.

    When `report_file` (or env PADDLE_WD_REPORT_FILE, one per worker) is
    given, a spill thread appends every timeout report to that file as it
    happens, so a worker that hangs and is later killed still leaves its
    post-mortem on disk. With PADDLE_WD_FATAL=1 the spill also prints a
    FatalError line to stderr."""
    global _wd, _spill
    with _lock:
        if _wd is None:
            lib = native.load()
            if timeout_seconds is None:
                timeout_seconds = float(
                    os.environ.get("PADDLE_PG_TIMEOUT", "1800"))
            _wd = (lib, lib.watchdog_create(int(timeout_seconds * 1000)))
        # the spill thread starts whenever a report file is configured and
        # none is running yet — including on a repeat enable() after an
        # earlier caller enabled the watchdog without one
        report_file = report_file or os.environ.get("PADDLE_WD_REPORT_FILE")
        if report_file and _spill is None:
            fatal = os.environ.get("PADDLE_WD_FATAL") == "1"
            stop = threading.Event()
            t = threading.Thread(target=_spill_loop,
                                 args=(stop, report_file, fatal),
                                 daemon=True, name="wd-spill")
            t.start()
            _spill = (t, stop)
        return True


def disable():
    global _wd, _spill
    with _lock:
        spill, _spill = _spill, None
        if spill is not None:
            spill[1].set()
    # join OUTSIDE the lock: the spill thread's drain_report needs the lock
    if spill is not None:
        spill[0].join(timeout=2)
    with _lock:
        if _wd is not None:
            _pump_locked()  # keep unread report text peekable post-disable
            lib, h = _wd
            _wd = None
            if spill is None or not spill[0].is_alive():
                lib.watchdog_destroy(h)
            # else: the spill thread is wedged (e.g. fsync on a hung mount);
            # leak the native handle rather than free it under the thread


@contextlib.contextmanager
def comm_task(desc: str, timeout_seconds=None, kind: str = "comm"):
    """Track a blocking region; near-free when the watchdog is off and no
    task observer is registered. Observers see every region's (desc, start,
    end, kind) interval regardless of whether the native watchdog is
    enabled — deadline enforcement needs the native thread, timeline
    stitching does not. `kind="comm"` (default) marks communication whose
    exposed time the overlap accounting charges; pass `kind="step"` (or any
    other tag) for deadline-only regions like a whole train step."""
    with _lock:
        wd = _wd
        if wd is None:
            tid = None
        else:
            lib, h = wd
            tid = lib.watchdog_register(h, desc.encode(),
                                        int((timeout_seconds or 0) * 1000))
    t0 = time.perf_counter_ns() if _task_observers else None
    try:
        yield
    finally:
        if tid is not None:
            with _lock:
                # a concurrent disable() may have destroyed the handle while
                # this region ran — completing on it would be a use-after-free
                if _wd is wd:
                    lib.watchdog_complete(h, tid)
        # t0 None: no observer was registered at entry — an observer added
        # mid-region must not receive a garbage interval. record_task's
        # per-observer error isolation also keeps an observer failure from
        # masking the region's own exception (we are in a finally block).
        if _task_observers and t0 is not None:
            record_task(desc, t0, time.perf_counter_ns(), kind)


def drain_report() -> str:
    """Return report text not yet consumed by a previous drain (destructive
    with respect to other drain callers, like the native buffer was — the
    spill thread's append-to-file contract depends on it — but the text is
    retained for peek_report()/report_events())."""
    global _report_cursor
    # under _lock: disable() must not watchdog_destroy the handle while a
    # reader (the spill thread in particular) is inside the native call
    with _lock:
        _pump_locked()
        fresh = "".join(_report_history[_report_cursor:])
        _report_cursor = len(_report_history)
    return fresh


def peek_report() -> str:
    """Non-destructive view of every retained report line (flight recorder's
    channel — reading here never steals text from the spill path)."""
    with _lock:
        _pump_locked()
        return "".join(_report_history)


# csrc/host/watchdog.cc line shape:
#   [watchdog] task 3 'train_step/7' exceeded 500ms (1234ms elapsed)
_REPORT_LINE_RE = re.compile(
    r"\[watchdog\] task (\d+) '(.*)' exceeded (\d+)ms \((\d+)ms")


def report_events() -> list[dict]:
    """peek_report() parsed into structured events: one dict per timed-out
    task with task id, description, deadline and observed elapsed time."""
    events = []
    for line in peek_report().splitlines():
        m = _REPORT_LINE_RE.search(line)
        if m:
            events.append({
                "task_id": int(m.group(1)),
                "desc": m.group(2),
                "timeout_ms": int(m.group(3)),
                "elapsed_ms": int(m.group(4)),
            })
    return events


def timeout_count() -> int:
    with _lock:
        if _wd is None:
            return 0
        lib, h = _wd
        return int(lib.watchdog_timeout_count(h))


def inflight() -> int:
    with _lock:
        if _wd is None:
            return 0
        lib, h = _wd
        return int(lib.watchdog_inflight(h))
