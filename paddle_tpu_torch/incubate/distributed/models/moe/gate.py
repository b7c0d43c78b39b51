"""MoE gates (↔ paddle_tpu/incubate/distributed/models/moe/gate.py).

A linear router gives each token its expert probabilities; the gate picks
the top-k experts, enforces a capacity and computes the GShard
load-balancing loss from the pre-drop router statistics (stored on the gate
as `l_aux`, like the reference's `set_loss`/`get_loss`). Two forms share
one router (`_probs_and_keep`, one per gate): `_route` gives the raw
(expert ids, weights, kept choices, l_aux) of the MoE layer's sorted fast
path, `_routing` the dense [S, E, C] combine and dispatch tensors of its
einsum path.

Differences from the JAX package, none of them in the numbers:

- Ties: `jax.lax.top_k` puts the lower index first; `torch.topk` promises
  no order on CUDA, so the port takes the top k of a stable descending
  sort, which keeps the lower expert id first.
- Randomness: GShard's random routing (the second choice kept when
  2 w2 > u, u ~ U(0, 1)) and Switch's jitter draw from a `torch.Generator`
  the gate owns, made from its `seed`, on the gate's device, where the JAX
  package draws from its global key stream. The two give different
  numbers, so a comparison of routes turns these off (`random_routing=
  False`, `switch_eps=0`).
- Each gate casts its inputs for AMP under the JAX package's op name (the
  gate class's lower-case name) in its dense form; the fast path casts
  once for the whole layer ("moe_fast").

**Routing over ranks.** The reference routes the global token set: its
arrays hold every batch rank's tokens, so the capacity is the gate's
capacity of the global count S_g, a (choice, token) pair's slot in its
expert follows the flat order j S_g + s over global token indices, and
the aux loss averages over all of them. A `DistributedTrainStep` that cuts
the batch gives the gate its token ranks (`Tokens`: a process group and
this rank's index in the token order, rank after rank; every rank holds as
many tokens), and then:

- the aux loss's sums over tokens are all-reduced (`Tokens.total`, whose
  backward all-reduces the gradient: every rank's loss holds the sum);
- each rank counts its valid pairs by (choice, expert) and one all-gather
  of those [k, E] counts gives every rank the global counts and the counts
  of the ranks before it, whence `global_offsets`: what to add to a pair's
  slot among this rank's pairs of its expert to get its global slot.

The capacity drops then fall as the reference's, whatever rank a token is
on.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..... import amp
from .....device import resolve_device
from .....distributed import collective as C
from .....nn.layer.common import Linear
from .....nn.layer.layers import Layer

__all__ = ["BaseGate", "GShardGate", "NaiveGate", "SwitchGate", "Tokens",
           "global_offsets"]


class _Total(torch.autograd.Function):
    """Sum over the ranks of pg; the backward sums the gradient over them
    too (each rank's loss holds the sum)."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return C.all_reduce_sum(x, pg)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce_sum(g, ctx.pg), None


class Tokens:
    """The ranks whose tokens one routing covers: process group `pg`, this
    rank's `index` in the token order, and `active()`, whether the tokens
    are cut over them right now (when a step takes a batch whole on every
    rank, or outside a step's call, every rank holds the same tokens and
    routes them alone)."""

    def __init__(self, pg, index, active=lambda: True):
        self.pg, self.index, self.active = pg, int(index), active
        self.n = torch.distributed.get_world_size(pg)

    def total(self, x):
        return _Total.apply(x, self.pg)

    def counts(self, cnt):
        """(the sum over the ranks of cnt, the sum over the ranks before
        this one), from one all-gather of (index, cnt) rows."""
        row = torch.cat([torch.full((1,), self.index, dtype=torch.long,
                                    device=cnt.device),
                         cnt.reshape(-1).long()])
        flat = torch.empty(self.n * row.numel(), dtype=torch.long,
                           device=cnt.device)
        C._all_gather_flat(flat, row, self.pg)
        rows = flat.view(self.n, -1)
        rows = rows[rows[:, 0].argsort()][:, 1:].view(self.n, *cnt.shape)
        return rows.sum(0), rows[:self.index].sum(0)


def global_offsets(tokens, cnt):
    """(offsets [k, E], global counts [k, E]) for this rank's valid-pair
    counts cnt [k, E] by (choice, expert): a pair (j, e) whose slot among
    this rank's pairs of expert e (in the flat order j S + s) is p has the
    global slot p + offsets[j, e], i.e. the pairs of e of the earlier
    choices on the other ranks and of choice j on the earlier ranks."""
    total, before = tokens.counts(cnt)
    other = total - cnt
    return other.cumsum(0) - other + before, total


def _topk(probs, k):
    """(values, indices) of the k largest probabilities of each row, the
    lower expert id first on ties (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _topk_route(probs, k, normalize_topk, choice_keep=None, tokens=None):
    """Raw top-k routing of probs [S, E] (↔ `_topk_route` :29): (topi [S, k]
    expert ids, topv [S, k] combine weights, zeroed for dropped choices,
    keep [S, k] bool, l_aux). The aux loss, E * sum_e mean_prob_e *
    frac_top1_e, comes from the raw probabilities and first choices, before
    any drop, over every rank of `tokens` (module docstring)."""
    S, E = probs.shape
    topv, topi = _topk(probs, k)
    if normalize_topk:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    first = nn.functional.one_hot(topi[:, 0], E).to(probs.dtype)
    if tokens is None:
        me, ce = probs.mean(0), first.mean(0)
    else:
        sums = tokens.total(torch.cat([probs.sum(0), first.sum(0)]))
        me, ce = (sums / (S * tokens.n)).split(E)
    l_aux = (me * ce).sum() * E
    if choice_keep is not None:
        keep = choice_keep
        topv = topv * keep.to(topv.dtype)
    else:
        keep = torch.ones(topi.shape, dtype=torch.bool, device=probs.device)
    return topi, topv, keep, l_aux


def _topk_dispatch(probs, k, capacity, normalize_topk, choice_keep=None,
                   tokens=None):
    """Dense top-k routing with capacity(token count) slots an expert (↔
    `_topk_dispatch` :65): (combine [S, E, C], dispatch [S, E, C] 0/1,
    l_aux). All first choices rank before any second choice; a (token,
    choice) past its expert's capacity is dropped (a zero row). Over the
    ranks of `tokens` the count, the slots and the aux loss are global."""
    S, E = probs.shape
    topi, topv, keepc, l_aux = _topk_route(probs, k, normalize_topk,
                                           choice_keep, tokens)
    onehot = (nn.functional.one_hot(topi, E).to(probs.dtype)
              * keepc.to(probs.dtype)[..., None])             # [S, k, E]
    m = onehot.transpose(0, 1).reshape(k * S, E)
    pos = ((m.cumsum(0) - m) * m).sum(-1)                     # slot per (choice, token)
    if tokens is None:
        capacity = capacity(S)
    else:
        capacity = capacity(S * tokens.n)
        off, _ = global_offsets(tokens, onehot.sum(0).round().long())
        pos = pos + (m * off.to(m.dtype).repeat_interleave(S, 0)).sum(-1)
    keep = (pos < capacity) & (m.sum(-1) > 0)
    slot = (nn.functional.one_hot(pos.long().clamp(max=capacity - 1),
                                  capacity).to(probs.dtype)
            * keep[:, None].to(probs.dtype))
    disp = torch.einsum("xe,xc->xec", m, slot).reshape(k, S, E, capacity)
    combine = torch.einsum("ks,ksec->sec", topv.transpose(0, 1), disp)
    return combine, disp.sum(0), l_aux


class BaseGate(Layer):
    """↔ gate.py:104 (reference gate/base_gate.py): the expert counts, the
    aux loss, and the routing generator made from `seed` on `device`."""

    #: combine weights renormalised over the selected top-k (GShard style)
    _normalize_topk = True

    def __init__(self, num_expert, world_size=1, *, seed=0, device=None):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None
        self.tokens = None   # the ranks it routes over (module docstring)
        self.generator = torch.Generator(device=resolve_device(device))
        self.generator.manual_seed(seed)

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss

    @property
    def l_aux(self):
        return self.loss

    def capacity(self, num_tokens):
        raise NotImplementedError

    def live_tokens(self):
        """The token ranks when the tokens are cut over them now, else
        None."""
        t = self.tokens
        return t if t is not None and t.active() else None

    def _probs_and_keep(self, x, w, b):
        """(probs [S, E] f32, choice_keep [S, k] bool or None): the one place
        each gate's router math lives."""
        raise NotImplementedError

    def _route(self, x, w, b):
        """Raw routing for the sorted fast path: (topi [S, k], topv [S, k]
        in x's dtype, keep [S, k] bool, l_aux)."""
        probs, keep = self._probs_and_keep(x, w, b)
        topi, topv, keepc, l_aux = _topk_route(probs, self.top_k,
                                               self._normalize_topk, keep,
                                               self.live_tokens())
        return topi, topv.to(x.dtype), keepc, l_aux

    def _routing(self, x, w, b):
        """(combine, dispatch, l_aux) of the dense path."""
        probs, keep = self._probs_and_keep(x, w, b)
        c, d, l_aux = _topk_dispatch(probs, self.top_k, self.capacity,
                                     self._normalize_topk, choice_keep=keep,
                                     tokens=self.live_tokens())
        return c.to(x.dtype), d.to(x.dtype), l_aux

    def forward(self, x):
        x, w, b = amp.cast_inputs(type(self).__name__.lower(), x,
                                  self.gate.weight, self.gate.bias)
        out = self._routing(x, w, b)
        self.set_loss(out[2])
        return out  # (combine [S, E, C], dispatch [S, E, C], l_aux)


class NaiveGate(BaseGate):
    """Linear router and plain top-k, no capacity drop (↔ gate.py:164):
    the capacity is the token count."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2, *,
                 seed=0, generator=None, device=None, dtype=torch.float32):
        super().__init__(num_expert, world_size, seed=seed, device=device)
        self.top_k = topk
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           device=device, dtype=dtype)

    def capacity(self, num_tokens):
        return int(num_tokens)

    def _probs_and_keep(self, x, w, b):
        return torch.softmax((x @ w + b).float(), dim=-1), None


class GShardGate(BaseGate):
    """Top-2 gate with a capacity, the load-balance loss and random routing
    of the second choice (↔ gate.py:181): capacity ceil(f S / E), f = 1.2
    in training and 2.4 in eval."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None, *,
                 seed=0, generator=None, device=None, dtype=torch.float32):
        super().__init__(num_expert, world_size, seed=seed, device=device)
        if topk != 2:
            raise ValueError("the gshard gate is top-2")
        self.top_k = 2
        self.capacity_factor = capacity  # (train, eval) multipliers
        self.random_routing = random_routing
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           device=device, dtype=dtype)

    def capacity(self, num_tokens):
        f = self.capacity_factor[0] if self.training else self.capacity_factor[1]
        return max(1, int(math.ceil(f * num_tokens / self.tot_expert)))

    def _probs_and_keep(self, x, w, b):
        probs = torch.softmax((x @ w + b).float(), dim=-1)
        if not (self.random_routing and self.training):
            return probs, None
        # GShard section 3.2: the second expert fires with probability
        # proportional to its weight, kept when 2 w2 > u ~ U(0, 1)
        w2 = _topk(probs, 2)[0][:, 1]
        u = torch.rand(x.shape[0], generator=self.generator,
                       device=x.device, dtype=torch.float32)
        keep2 = 2.0 * w2 > u
        return probs, torch.stack([torch.ones_like(keep2), keep2], dim=-1)


class SwitchGate(BaseGate):
    """Top-1 switch routing with multiplicative jitter U(1 - eps, 1 + eps)
    on the logits in training (↔ gate.py:199); no renormalisation."""

    _normalize_topk = False

    def __init__(self, d_model, num_expert, world_size=1, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None, *, seed=0,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__(num_expert, world_size, seed=seed, device=device)
        if topk != 1:
            raise ValueError("the switch gate is top-1")
        self.top_k = 1
        self.switch_eps = switch_eps
        self.capacity_factor = capacity
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           device=device, dtype=dtype)

    def capacity(self, num_tokens):
        f = self.capacity_factor[0] if self.training else self.capacity_factor[1]
        return max(1, int(math.ceil(f * num_tokens / self.tot_expert)))

    def _probs_and_keep(self, x, w, b):
        logits = x @ w + b
        if self.training and self.switch_eps > 0:
            u = torch.rand(logits.shape, generator=self.generator,
                           device=x.device, dtype=torch.float32)
            noise = (1.0 - self.switch_eps) + 2.0 * self.switch_eps * u
            logits = logits * noise.to(logits.dtype)
        return torch.softmax(logits.float(), dim=-1), None
