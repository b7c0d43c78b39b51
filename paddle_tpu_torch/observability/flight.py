"""Crash flight recorder: the last N step timelines and recent metric
deltas, dumped to a post-mortem file when the process dies
(↔ paddle_tpu/observability/flight.py).

A hung or crashing job cannot be run again with more logging, so the
evidence has to be in memory when it dies. The recorder keeps a bounded
ring of `StepTimeline` records (fed while a timeline is installed), a ring
of annotated events (checkpoint commits, watchdog overruns) and a metrics
snapshot to diff against.

`dump()` writes one JSON document with those, the non-destructive
`comm_watchdog.peek_report()` and its timeout count. The SIGTERM and
`sys.excepthook` handlers that `install_crash_handlers()` chains in call
it; ``PADDLE_FLIGHT_FILE`` names the file. The reference's document also
holds `dispatch_cache`, which the port has no counterpart for.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque

from . import metrics as metrics_mod

__all__ = [
    "FlightRecorder",
    "get_recorder",
    "reset_recorder",
    "feed_step",
    "install_crash_handlers",
    "uninstall_crash_handlers",
    "default_path",
]


def default_path() -> str:
    """PADDLE_FLIGHT_FILE (one file per worker) or a file in the cwd."""
    return os.environ.get("PADDLE_FLIGHT_FILE", "flight_recorder.json")


class FlightRecorder:
    def __init__(self, capacity: int = 64, event_capacity: int = 256,
                 registry: metrics_mod.MetricsRegistry | None = None):
        self.steps: deque = deque(maxlen=capacity)
        self.events: deque = deque(maxlen=event_capacity)
        self._registry = registry
        # reentrant: the SIGTERM handler runs on the main thread and may
        # interrupt a dump() already holding this lock (e.g. the watchdog-
        # overrun dump blocked in fsync) — a plain Lock would self-deadlock
        self._lock = threading.RLock()
        self._metrics_base: dict = {}
        self._dump_count = 0

    @property
    def registry(self) -> metrics_mod.MetricsRegistry:
        return self._registry or metrics_mod.default_registry()

    # -- feeding ---------------------------------------------------------- #

    def record_step(self, record: dict):
        self.steps.append(record)

    def note(self, kind: str, **fields):
        """Annotate the timeline (checkpoint save, watchdog overrun, hold)."""
        self.events.append({"t_wall": round(time.time(), 6),
                            "kind": kind, **fields})

    def snapshot_metrics(self):
        """Start a fresh delta window (dump() reports changes since here)."""
        self._metrics_base = self.registry.snapshot()

    # -- dumping ---------------------------------------------------------- #

    def postmortem(self, reason: str = "", lockfree: bool = False) -> dict:
        """`lockfree=True` is the SIGNAL-HANDLER mode: the handler runs on
        the main thread and may have interrupted code holding the watchdog
        lock (not reentrant) — calling its collectors from the handler
        would self-deadlock, so they are skipped. The metrics registry and
        the rings are lock-free reads."""
        doc = {
            "reason": reason,
            "t_wall": round(time.time(), 6),
            "pid": os.getpid(),
            "rank": os.environ.get("PADDLE_TRAINER_ID"),
            "restart_count": os.environ.get("PADDLE_RESTART_COUNT"),
            "dump_count": self._dump_count,
            "steps": list(self.steps),
            "events": list(self.events),
            "metric_deltas": self.registry.delta(self._metrics_base),
            "metrics": self.registry.collect(),
        }
        if lockfree:
            doc["lockfree"] = True
            return doc
        from ..distributed import comm_watchdog

        doc["watchdog_report"] = comm_watchdog.peek_report()
        doc["watchdog_timeouts"] = comm_watchdog.timeout_count()
        return doc

    def dump(self, path: str | None = None, reason: str = "",
             lockfree: bool = False) -> str:
        """Write the post-mortem JSON; returns the path. Append-safe: each
        dump is one JSON document per line, so a crash that follows a
        watchdog overrun keeps both records."""
        path = path or default_path()
        with self._lock:
            self._dump_count += 1
            doc = self.postmortem(reason, lockfree=lockfree)
            # default=repr: span attrs and note() fields are user-fed
            # (numpy scalars are the natural values) — a serialization
            # TypeError here would kill the dump at exactly the moment it
            # exists for, and mask the original crash
            text = json.dumps(doc, sort_keys=True, default=repr)
            try:
                with open(path, "a") as f:
                    f.write(text + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError as e:
                # the ring buffer is the only copy — stderr (→ worker log)
                # is the fallback channel, same stance as the watchdog spill
                print(f"[flight] post-mortem file {path} unwritable ({e}); "
                      f"dump follows:\n{text}",
                      file=sys.stderr, flush=True)
        return path


_default_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _default_recorder
    if _default_recorder is None:
        with _recorder_lock:
            if _default_recorder is None:
                _default_recorder = FlightRecorder()
    return _default_recorder


def reset_recorder() -> FlightRecorder:
    global _default_recorder
    with _recorder_lock:
        _default_recorder = FlightRecorder()
    return _default_recorder


def feed_step(record: dict):
    """StepTimeline sink: only an already-created recorder buffers steps
    (importing the timeline must not silently spin up crash machinery)."""
    rec = _default_recorder
    if rec is not None:
        rec.record_step(record)


# --------------------------------------------------------------------------- #
# crash handlers
# --------------------------------------------------------------------------- #

_handlers_installed = False
_prev_sigterm = None
_prev_excepthook = None


def install_crash_handlers(path: str | None = None):
    """Chain a SIGTERM handler and sys.excepthook that dump the default
    recorder before the previous behavior runs. Idempotent; main thread
    only for the signal part (a worker thread caller still gets the
    excepthook)."""
    global _handlers_installed, _prev_sigterm, _prev_excepthook
    if _handlers_installed:
        return
    dump_path = path

    def _on_sigterm(signum, frame):
        # lockfree: the interrupted main thread may hold the watchdog
        # lock; its collectors are skipped in the signal path
        get_recorder().dump(dump_path, reason="SIGTERM", lockfree=True)
        prev = _prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev != signal.SIG_IGN:
            # default disposition: restore and re-raise so the exit code
            # still reads as signal death to the launcher. An explicitly
            # IGNORED SIGTERM stays ignored — dumping must not turn a
            # deliberate SIG_IGN into process death.
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    def _on_except(exc_type, exc, tb):
        get_recorder().dump(
            dump_path, reason=f"uncaught {exc_type.__name__}: {exc}")
        (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    _prev_excepthook = sys.excepthook
    sys.excepthook = _on_except
    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        # not the main thread: excepthook-only installation
        _prev_sigterm = None
    _handlers_installed = True


def uninstall_crash_handlers():
    global _handlers_installed, _prev_sigterm, _prev_excepthook
    if not _handlers_installed:
        return
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    if _prev_sigterm is not None:
        try:
            signal.signal(signal.SIGTERM, _prev_sigterm)
        except ValueError:
            pass
        _prev_sigterm = None
    _handlers_installed = False
