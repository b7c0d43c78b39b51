"""Fault-injection points for the crash tests
(↔ paddle_tpu/distributed/faults.py, the same code).

Code calls ``fault_point("name")`` at the instants a real failure would
land (mid checkpoint save, before its commit). With no configuration the
call is a near-free no-op; tests arm points through the env var

    PADDLE_FAULT_INJECT="point:action[:arg][@n][,point2:action2...]"

Actions:
    kill      os._exit(FAULT_EXIT_CODE) — simulates SIGKILL/preemption (no
              atexit, no cleanup)
    exc       raise FaultInjected (an in-process crash the caller may catch)
    sleep:S   block S seconds — simulates a hang for the comm watchdog

``@n`` trips the point only on its n-th hit (1-based, counted per process),
so e.g. ``ckpt.before_commit:kill@2`` lets the first checkpoint commit and
kills the second mid-save. It is a test harness, not a switch of the
program's behaviour.
"""

from __future__ import annotations

import os
import time

__all__ = ["FaultInjected", "fault_point", "reset", "FAULT_EXIT_CODE"]

# distinct from any exit code the trainers use, so tests can assert the death
# really came from the injected fault
FAULT_EXIT_CODE = 43

_parsed_env = None  # (env string, {point: (action, arg, nth)})
_hit_counts: dict = {}


class FaultInjected(RuntimeError):
    """Raised by an armed ``exc`` fault point."""


def reset():
    """Clear hit counters and the parsed-spec cache. Test fixtures call this
    on arm/disarm: the env-string cache can't see unset→re-set of the SAME
    spec (no fault_point call in between re-parses), so a @n counter from an
    earlier arm would otherwise survive and suppress the new one."""
    global _parsed_env
    _parsed_env = None
    _hit_counts.clear()


def _spec():
    global _parsed_env
    raw = os.environ.get("PADDLE_FAULT_INJECT", "")
    if _parsed_env is not None and _parsed_env[0] == raw:
        return _parsed_env[1]
    _hit_counts.clear()  # re-arming starts a fresh @n count
    spec = {}
    for entry in filter(None, (e.strip() for e in raw.split(","))):
        nth = 1
        if "@" in entry:
            entry, n = entry.rsplit("@", 1)
            nth = int(n)
        parts = entry.split(":")
        if len(parts) < 2:
            continue
        point, action = parts[0], parts[1]
        arg = parts[2] if len(parts) > 2 else None
        spec[point] = (action, arg, nth)
    _parsed_env = (raw, spec)
    return spec


def fault_point(name: str):
    """Trip the named injection point if armed; no-op otherwise."""
    spec = _spec()
    if name not in spec:
        return
    action, arg, nth = spec[name]
    _hit_counts[name] = _hit_counts.get(name, 0) + 1
    if _hit_counts[name] != nth:
        return
    if action == "kill":
        os._exit(FAULT_EXIT_CODE)
    if action == "exc":
        raise FaultInjected(f"fault point '{name}' tripped")
    if action == "sleep":
        time.sleep(float(arg or "1"))
