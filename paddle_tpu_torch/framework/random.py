"""The RNG state (↔ paddle_tpu/framework/random.py).

The JAX package keeps one global threefry key and splits it per draw. The
port keeps explicit `torch.Generator`s, one per device, made on first use
and seeded from `seed(n)` (0 until it is called). Every random draw of
the port (dropout, attention dropout, rrelu, gumbel_softmax) takes its
generator from `generator(device)`; none uses torch's global generator,
so `torch.manual_seed` does not touch them.

`get_rng_state()` snapshots the seed and every generator, and
`set_rng_state(state)` brings all of it back: a generator made after the
snapshot is reset to its fresh state. `rng_guard(state)` does both around
a block, which is how `fleet.recompute` replays a block's masks in the
backward.

**The rank rule.** A `DistributedTrainStep` built over a mesh runs its
forward and backward inside `rank_scope(token, mp)`: `token` is the rank's
index over the token axes (the batch axes, and sep when the sequence is
cut), `mp` its mp coordinate. A draw takes the generator of its rank,
seeded from (seed, token): ranks that hold the same tokens (the mp and pp
ranks of one token index) draw the same masks, so an activation they all
hold, such as the residual dropout after a row-parallel all-reduce, keeps
one value on each of them, and ranks that hold different tokens draw
different masks. A draw on a tensor that is cut over mp (attention dropout
on this rank's heads, a dropout on this rank's sequence rows under
sequence parallelism) runs inside `cut_over_mp()`, which takes a second
generator seeded from (seed, token, mp): each mp rank draws its own piece.
The two generators advance apart, so the shared one stays in step on every
mp rank. The rank holds only inside the scope: outside it (eager code, or
no step) the rank is (0, 0), whose shared generator is seeded with the seed
itself. Entering or leaving a scope reseeds nothing; each rank's
generators go on from where its last draw left them.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ["cut_over_mp", "generator", "get_rng_state", "rank_scope",
           "rng_guard", "seed", "set_rng_state"]

_MASK = (1 << 63) - 1
_TOKEN_STRIDE = 0x9E3779B97F4A7C15
_MP_STRIDE = 0xBF58476D1CE4E5B9

_seed = 0
_rank = (0, 0)       # (token index, mp coordinate), set by rank_scope
_gens: dict = {}     # (device, token, mp coordinate or None) -> Generator
_CUT = contextvars.ContextVar("rng_cut_over_mp", default=False)


def _seed_of(token, mp):
    """The seed of a token rank's shared generator (mp None) or of its
    mp-cut one."""
    s = _seed + _TOKEN_STRIDE * token
    if mp is not None:
        s += _MP_STRIDE * (mp + 1)
    return s & _MASK


def _device(device):
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _reseed():
    for (_, token, mp), g in _gens.items():
        g.manual_seed(_seed_of(token, mp))


def seed(value):
    """paddle.seed: every generator starts again from `value`."""
    global _seed
    _seed = int(value)
    _reseed()


@contextlib.contextmanager
def rank_scope(token, mp=0):
    """The rank rule (module docstring): draws inside the block take the
    generators of token index `token` and mp coordinate `mp`."""
    global _rank
    saved, _rank = _rank, (int(token), int(mp))
    try:
        yield
    finally:
        _rank = saved


def generator(device):
    """The generator a draw on `device` takes: the shared one, or the
    mp-cut one inside `cut_over_mp()`."""
    token, mp = _rank
    key = (_device(device), token, mp if _CUT.get() else None)
    g = _gens.get(key)
    if g is None:
        g = torch.Generator(device=key[0])
        g.manual_seed(_seed_of(*key[1:]))
        _gens[key] = g
    return g


@contextlib.contextmanager
def cut_over_mp():
    """Draws inside the block are of a tensor cut over mp (module
    docstring)."""
    token = _CUT.set(True)
    try:
        yield
    finally:
        _CUT.reset(token)


def get_rng_state():
    """(seed, rank, {generator key: state}): a snapshot."""
    return (_seed, _rank, {k: g.get_state() for k, g in _gens.items()})


def set_rng_state(state):
    """Bring back a snapshot of `get_rng_state`; a generator that the
    snapshot does not hold (made after it) starts afresh."""
    global _seed, _rank
    _seed, _rank, states = state
    for key, g in _gens.items():
        if key in states:
            g.set_state(states[key])
        else:
            g.manual_seed(_seed_of(*key[1:]))


class rng_guard:
    """Snapshot the RNG state on entry, set `state` (a `get_rng_state()`
    snapshot) if one is given, and restore the snapshot on exit."""

    def __init__(self, state=None):
        self._state = state
        self._saved = None

    def __enter__(self):
        self._saved = get_rng_state()
        if self._state is not None:
            set_rng_state(self._state)
        return self

    def __exit__(self, *exc):
        set_rng_state(self._saved)
        return False
