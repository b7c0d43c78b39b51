"""Activation recomputation (↔ paddle_tpu/distributed/fleet/recompute.py).

`recompute(fn, *args, **kw)` runs `fn` keeping none of its intermediate
activations and runs it again in the backward to rebuild them, through
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`. The replay must
draw what the forward drew and cast as it cast, so with
`preserve_rng_state` the port's generators (`framework.random`, which
torch's own RNG preservation does not see) are snapshotted when the
forward runs and restored around the replay (`rng_guard`, as the
reference's `:45`, `:58`), beside torch's default generators; and the
port's AMP state is restored too: the replay happens in the backward,
outside any `auto_cast`.
"""

from __future__ import annotations

import contextlib

from torch.utils.checkpoint import checkpoint

from ... import amp
from ...framework import random

__all__ = ["recompute"]


def recompute(function, *args, preserve_rng_state=True, **kwargs):
    """paddle.distributed.fleet.utils.recompute in its non-reentrant form
    (it handles keyword arguments and inputs that need no gradient); the
    reference's `use_reentrant` has no counterpart here."""
    state = amp.amp_state()
    rng = random.get_rng_state() if preserve_rng_state else None
    calls = [0]

    def run(*a, **kw):
        # the first call is the forward, any later one a replay
        replay = rng is not None and calls[0] > 0
        calls[0] += 1
        guard = random.rng_guard(rng) if replay else contextlib.nullcontext()
        with amp.auto_cast.restore(state), guard:
            return function(*a, **kw)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)
