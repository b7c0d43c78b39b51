"""The MoE all-to-all record (↔ paddle_tpu/distributed/moe_comm.py).

The reference's MoE fast path runs its all-to-alls inside a compiled step,
where the host sees no collective, so it registers an analytic volume per
trace (`note_a2a` :43) and the step replays it each step as counters and
estimated `comm_task` intervals (`emit_step` :84). The port's all-to-alls
are eager and count themselves in `distributed.collective.CALLS` /
`BYTES["all_to_all"]` (the backward's too); what stays of the reference is
the record by exchange: each expert-parallel forward of a `MoELayer` notes
its dispatch and combine here, under the reference's desc
`moe/a2a/<axis>x<n>`, with the bytes this rank sent and the calls it made
(2 x chunks). `A2A` holds the sums by desc, `a2a_totals()` reads them and
`reset()` clears them. The reference's `comm_task` intervals wait for the
observability module (ROADMAP queue A item 7).
"""

from __future__ import annotations

__all__ = ["A2A", "a2a_totals", "note_a2a", "reset"]

A2A: dict = {}   # desc -> {"bytes", "calls", "forwards"}


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
