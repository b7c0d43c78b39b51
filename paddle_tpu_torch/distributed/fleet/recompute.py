"""Activation recomputation (↔ paddle_tpu/distributed/fleet/recompute.py).

`recompute(fn, *args, **kw)` runs `fn` keeping none of its intermediate
activations and runs it again in the backward to rebuild them, through
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`. The RNG state is
restored for the replay (`preserve_rng_state`), and so is the port's AMP
state: the replay happens in the backward, outside any `auto_cast`, and
must cast as the forward did.
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from ... import amp

__all__ = ["recompute"]


def recompute(function, *args, preserve_rng_state=True, **kwargs):
    """paddle.distributed.fleet.utils.recompute in its non-reentrant form
    (it handles keyword arguments and inputs that need no gradient); the
    reference's `use_reentrant` has no counterpart here."""
    state = amp.amp_state()

    def run(*a, **kw):
        with amp.auto_cast.restore(state):
            return function(*a, **kw)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)
