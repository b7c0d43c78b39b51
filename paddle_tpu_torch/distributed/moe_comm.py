"""The MoE all-to-alls and their record (↔ paddle_tpu/distributed/moe_comm.py).

The reference's MoE fast path runs its all-to-alls inside a compiled step,
where the host sees no collective, so it registers an analytic volume per
trace (`note_a2a` :43) and the step replays it each step as counters and
estimated `comm_task` intervals (`emit_step` :84). The port's all-to-alls
are eager: each goes through `all_to_all` here, which counts it in the
registry's `collective_calls_total` / `collective_bytes_total{op=
"all_to_all"}` (the backward's too) and runs it under a
`comm_watchdog.comm_task` of kind "a2a", so the `StepTimeline`'s overlap
accounting sees its (host) interval, measured rather than estimated.
What stays of the reference's record is the volume by exchange: each
expert-parallel forward of a `MoELayer` notes its dispatch and combine
here, under the reference's desc `moe/a2a/<axis>x<n>`, with the bytes this
rank sent and the calls it made (2 x chunks). `A2A` holds the sums by
desc, `a2a_totals()` reads them and `reset()` clears them.
"""

from __future__ import annotations

from . import collective as C
from .comm_watchdog import comm_task

__all__ = ["A2A", "a2a_totals", "all_to_all", "note_a2a", "reset"]

A2A: dict = {}   # desc -> {"bytes", "calls", "forwards"}


def all_to_all(out, inp, pg):
    """out [n * k] <- block r of every rank r's inp [n * k] (equal splits),
    counted and under `comm_task("moe/a2a", kind="a2a")`."""
    with comm_task("moe/a2a", kind="a2a"):
        return C._all_to_all(out, inp, pg)


def note_a2a(desc: str, nbytes: int, calls: int = 1):
    """Add one forward's all-to-all volume under `desc`."""
    rec = A2A.setdefault(str(desc), {"bytes": 0, "calls": 0, "forwards": 0})
    rec["bytes"] += int(nbytes)
    rec["calls"] += int(calls)
    rec["forwards"] += 1


def a2a_totals() -> dict:
    """{desc: {"bytes", "calls", "forwards"}} since the last `reset()`."""
    return {k: dict(v) for k, v in A2A.items()}


def reset():
    A2A.clear()
