"""Mixture-of-experts layer (↔ paddle_tpu/incubate/distributed/models/moe/
moe_layer.py).

`MoELayer(d_model, experts, gate)` routes each token to its gate's top-k
experts and sums their outputs weighted by the gate. Two forms, both as in
the JAX package:

- **The sorted fast path** (`_forward_fast`, ↔ `_fast_fn` :170), taken for
  a stacked `ExpertFFN` and a gate with the shared router. Routing keeps
  only (expert id, weight) per (token, choice); the (choice, token) pairs
  sort stably by expert (all first choices before any second choice, the
  dense path's capacity priority), each gets its rank within its expert,
  and the pairs under the capacity are scattered into a uniform-stride
  [E * R, M] buffer (R = `row_stride(capacity)`); the experts run as two
  grouped GEMMs over it (`ops.grouped_gemm`: the hand-written kernel on
  CUDA tensors), and the outputs gather back through the same slots.
  Nothing leaves the device: the group sizes stay a tensor.
- **The dense einsum path** (`_forward_dense`, ↔ :324): dense [S, E, C]
  dispatch and combine tensors and three einsums. It serves list experts
  and is the fast path's oracle in the tests.

Where JAX writes a scatter with `mode="drop"` and a gather with
`mode="fill"`, the port writes into a buffer with one sentinel row (the
dropped pairs land there, and it is cut off) and gathers from the expert
outputs with one zero row appended.

**Over ranks.** A `DistributedTrainStep` that cuts the batch gives each
layer its token ranks (`_token_shard`), and the gate routes them as the
reference routes its global token set (gate.py, "Routing over ranks"):
the capacity of the global token count, global slots, a global aux loss.
A rank fills the slots of its own tokens in the [E, R, M] buffer; the
rest stay zero.

**Expert parallelism** (↔ :104-107, :247-279). A fast-path layer whose
`ep_axis` names one of the step's token axes is cut over that axis's
group of n ranks (`_ep_shard`): its `ExpertFFN` keeps experts
[r E / n, (r + 1) E / n) on rank r (E must divide by n), and the buffer
travels in `a2a_chunks` row chunks of Rc = row_stride(ceil(capacity /
chunks)) rows an expert (R = chunks * Rc): for each chunk, an all-to-all
over the ep group (`_Dispatch`) gives each rank its experts' rows from
every rank, summed (each slot is one rank's), the grouped GEMMs run on the
rank's E / n experts, and a second all-to-all (`_Combine`) sends the
outputs back to every rank, which gathers its own slots. Each exchange is
an autograd Function whose backward is the reverse exchange, so the
grouped GEMM's dlhs kernel runs in the backward as on one device. The
same code runs on a group of one. Where every rank holds the same
tokens (a step that takes a batch whole on every rank, as it does when
the batch does not divide, or a call outside a step's), each rank's
experts take their rows from its own buffer and only the combine runs.
Each forward notes its exchange in
`distributed.moe_comm` (desc `moe/a2a/<axis>x<n>`, 2 x chunks calls, the
bytes this rank sent); every all-to-all, the backward's too, goes through
`moe_comm.all_to_all` (counted in the registry's
`collective_calls_total` / `collective_bytes_total{op="all_to_all"}`,
under a `comm_task` of kind "a2a"). The exchange
moves the whole capacity buffer (E x R rows each way, as the reference's
dense oracle leg does), not only the live rows. A layer on the dense path
keeps its experts whole on every rank (the values are the same).

`moe_group` and `mp_group` are accepted and unused, as in the reference
(:133): `ep_axis` decides. The `PADDLE_TPU_MOE_FAST` switch is not ported
(the form follows the experts and the gate), and
`PADDLE_TPU_MOE_A2A_CHUNKS` is the constructor's `a2a_chunks` (default
2, clamped to [1, 8]).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from ..... import amp
from .....device import resolve_device
from .....distributed import moe_comm
from .....nn import initializer as I
from .....nn.layer.container import LayerList
from .....ops.grouped_gemm import grouped_matmul, row_stride
from .gate import (BaseGate, GShardGate, NaiveGate, SwitchGate, Tokens,
                   global_offsets)
from .....nn.layer.layers import Layer
from .....framework.core import report_op
from .....framework.core import Parameter

__all__ = ["ExpertFFN", "MoELayer"]

# the experts' activations by jax.nn name (jax.nn.gelu is the tanh form)
_ACTIVATIONS = {"gelu": lambda t: nn.functional.gelu(t, approximate="tanh")}


def _activation(name):
    if name not in _ACTIVATIONS:
        raise NotImplementedError(f"expert activation {name!r}: the port "
                                  f"has {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


class ExpertFFN(Layer):
    """Stacked expert FFN (↔ moe_layer.py:89): every expert's weights in one
    [E, ...] tensor, w1 [E, M, H], b1 [E, 1, H], w2 [E, H, M], b2 [E, 1, M];
    weights Xavier-uniform from `generator`, biases zero (the reference's
    `create_parameter` defaults). The `MoELayer` that holds it cuts it
    over the layer's `ep_axis` (`_ep_shard`); its own `ep_axis` is taken
    for the reference's signature."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu",
                 ep_axis=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.num_experts = num_experts
        self.activation = activation
        _activation(activation)

        def weight(*shape):
            return I.XavierUniform()(Parameter(
                torch.empty(*shape, device=dev, dtype=dtype)),
                generator=generator)

        def bias(*shape):
            return Parameter(torch.zeros(*shape, device=dev, dtype=dtype))

        self.w1 = weight(num_experts, d_model, d_hidden)
        self.b1 = bias(num_experts, 1, d_hidden)
        self.w2 = weight(num_experts, d_hidden, d_model)
        self.b2 = bias(num_experts, 1, d_model)
        self.local_experts = num_experts   # E / n once cut over n ranks

    def _ep_shard(self, pg, axis):
        """Keep this rank's E / n experts of each stacked weight, marked
        with `ep_axis`, `ep_part` (dim 0, rank, n) and `ep_group`."""
        n, r = dist.get_world_size(pg), dist.get_rank(pg)
        if self.num_experts % n:
            raise ValueError(f"expert count {self.num_experts} not divisible "
                             f"by the {axis!r} mesh axis size {n}")
        k = self.num_experts // n
        with torch.no_grad():
            for p in (self.w1, self.b1, self.w2, self.b2):
                p.data = p.data.narrow(0, r * k, k).contiguous()
                p.ep_axis, p.ep_part, p.ep_group = axis, (0, r, n), pg
                p.dist_attr = (axis,) + (None,) * (p.dim() - 1)
        self.local_experts = k

    def forward(self, xe):
        """xe [E, C, M] -> [E, C, M] (the dense path's batched GEMMs)."""
        x, w1, b1, w2, b2 = amp.cast_inputs("expert_ffn", xe, self.w1,
                                            self.b1, self.w2, self.b2)
        h = _activation(self.activation)(torch.einsum("ecm,emh->ech", x, w1)
                                         + b1)
        return torch.einsum("ech,ehm->ecm", h, w2) + b2


_GATES = {"gshard": GShardGate, "switch": SwitchGate, "naive": NaiveGate}


def _exchange(x, pg, n):
    """x [n * k, ...]: block r goes to rank r of pg; returns what every
    rank sent this one, [n, k, ...] in group order."""
    x = x.contiguous()
    out = torch.empty_like(x)
    moe_comm.all_to_all(out, x, pg)
    return out.view(n, -1, *x.shape[1:])


class _Dispatch(torch.autograd.Function):
    """[E, Rc, M], this rank's slots filled -> [E / n, Rc, M], this rank's
    experts' slots from every rank (summed: a slot is one rank's)."""

    @staticmethod
    def forward(ctx, x, pg, n):
        ctx.pg, ctx.n = pg, n
        return _exchange(x, pg, n).sum(0)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        back = g.unsqueeze(0).expand(n, *g.shape).reshape(-1, *g.shape[1:])
        return _exchange(back, ctx.pg, n).flatten(0, 1), None, None


class _Combine(torch.autograd.Function):
    """[E / n, Rc, M], this rank's experts' outputs -> [E, Rc, M], every
    expert's, sent to every rank."""

    @staticmethod
    def forward(ctx, y, pg, n):
        ctx.pg, ctx.n = pg, n
        out = y.unsqueeze(0).expand(n, *y.shape).reshape(-1, *y.shape[1:])
        return _exchange(out, pg, n).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.pg, ctx.n).sum(0), None, None


class MoELayer(Layer):
    """↔ moe_layer.py:130 — MoELayer(d_model, experts, gate, ...).

    `experts` is an `ExpertFFN` (the sorted fast path) or a list of modules,
    each applied to its expert's [C, M] slice (the dense path). `gate` is a
    `BaseGate` or a config dict {"type": "gshard" | "switch" | "naive",
    "top_k": k, ...} as in the reference; a gate built from a config is
    made on `device` with weights from `generator` and its routing
    generator seeded with `seed`."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, ep_axis=None, name=None,
                 a2a_chunks=2, *, seed=0, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.ep_axis = ep_axis
        self.a2a_chunks = max(1, min(int(a2a_chunks), 8))
        self._ep_group = None   # set by _ep_shard
        if isinstance(experts, ExpertFFN):
            self.experts = experts
            self.num_expert = experts.num_experts
            self._stacked = True
        else:
            self.experts = LayerList(experts)
            self.num_expert = len(experts)
            self._stacked = False
        if isinstance(gate, BaseGate):
            self.gate = gate
        else:
            cfg = dict(gate or {})
            cls = _GATES[cfg.pop("type", "gshard")]
            topk = cfg.pop("top_k", 2)
            self.gate = cls(d_model, self.num_expert, topk=topk, seed=seed,
                            generator=generator, device=device, dtype=dtype,
                            **cfg)

    @property
    def l_aux(self):
        return self.gate.l_aux

    def _fast(self):
        """Whether the layer takes the sorted fast path: a gate that only
        defines the dense routing, or overrides it, stays on the dense
        path (moe_layer.py:303-310)."""
        gate_cls = type(self.gate)
        return (self._stacked
                and gate_cls._probs_and_keep is not BaseGate._probs_and_keep
                and gate_cls._routing is BaseGate._routing
                and getattr(self.gate, "gate", None) is not None)

    def _token_shard(self, pg, index, active=lambda: True):
        """Route over the token ranks of pg, this rank's tokens `index`-th
        in the token order (module docstring)."""
        self.gate.tokens = Tokens(pg, index, active)

    def _ep_shard(self, pg):
        """Cut the experts over the ep group pg (module docstring)."""
        self.experts._ep_shard(pg, self.ep_axis)
        self._ep_group = pg

    def forward(self, inp):
        shape = inp.shape
        x = inp.reshape(-1, self.d_model)
        out = self._forward_fast(x) if self._fast() else self._forward_dense(x)
        return out.reshape(*shape[:-1], self.d_model)

    def _forward_fast(self, x):
        gate, e = self.gate, self.experts
        S, M = x.shape
        E, k = self.num_expert, gate.top_k
        tokens = gate.live_tokens()
        cap = gate.capacity(S if tokens is None else S * tokens.n)
        pg = self._ep_group
        chunks = 1 if pg is None else self.a2a_chunks
        Rc = row_stride(math.ceil(cap / chunks))
        R = Rc * chunks
        act = _activation(e.activation)
        x, gw, gb, w1, b1, w2, b2 = amp.cast_inputs(
            "moe_fast", x, gate.gate.weight, gate.gate.bias, e.w1, e.b1,
            e.w2, e.b2)
        topi, topv, keep, l_aux = gate._route(x, gw, gb)

        # flat (choice, token) pairs in choice-major order j * S + s
        eid = topi.transpose(0, 1).reshape(-1)
        wts = topv.transpose(0, 1).reshape(-1)
        valid = keep.transpose(0, 1).reshape(-1)
        tok = torch.arange(S, device=x.device).repeat(k)

        # rank within its expert among the valid pairs: a stable sort by
        # expert (invalid pairs sort to the sentinel E), then index - the
        # start of the expert's run
        key = torch.where(valid, eid, torch.full_like(eid, E))
        srt, order = torch.sort(key, stable=True)
        counts = torch.bincount(key, minlength=E + 1)[:E]
        start = counts.cumsum(0) - counts
        pos_sorted = (torch.arange(k * S, device=x.device)
                      - start[srt.clamp(max=E - 1)])
        pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
        if tokens is not None:
            # this rank's slots among every rank's pairs (gate.py)
            choice = torch.arange(k * S, device=x.device) // S
            per = torch.bincount((choice * (E + 1) + key),
                                 minlength=k * (E + 1)).view(k, E + 1)[:, :E]
            off, per = global_offsets(tokens, per)
            pos = pos + off[choice, eid]
            counts = per.sum(0)

        # capacity overflow drops the pair into the sentinel row E * R
        kept = valid & (pos < cap)
        slot = torch.where(kept, eid * R + pos, torch.full_like(eid, E * R))
        xs = x.new_zeros(E * R + 1, M).index_copy(0, slot, x[tok])[:E * R]
        sizes = torch.clamp(counts, max=cap).to(torch.int32)  # live rows a group

        if pg is None:
            h = act(grouped_matmul(xs, w1, sizes).reshape(E, R, -1) + b1)
            y = report_op("expert_ffn", grouped_matmul(
                h.reshape(E * R, -1), w2, sizes).reshape(E, R, M) + b2)
        else:
            y = self._experts_over_ranks(xs.view(E, R, M), sizes, Rc, w1, b1,
                                         w2, b2, act, tokens is None)
        y = torch.cat([y.reshape(E * R, M), y.new_zeros(1, M)])
        g = y.index_select(0, slot)
        out = (wts[:, None].to(x.dtype) * g).reshape(k, S, M).sum(0)
        gate.set_loss(l_aux)
        return out

    def _experts_over_ranks(self, xs, sizes, Rc, w1, b1, w2, b2, act,
                            same_tokens):
        """xs [E, R, M] through the experts cut over the ep group, chunk
        by chunk (module docstring); returns [E, R, M]. With `same_tokens`
        (the tokens not cut over the ranks: every rank holds them all) a
        rank's experts take their rows from its own buffer, no dispatch."""
        pg = self._ep_group
        n, r = dist.get_world_size(pg), dist.get_rank(pg)
        El = self.experts.local_experts
        mine = sizes[r * El:(r + 1) * El]
        chunks = xs.shape[1] // Rc
        ys = []
        for c in range(chunks):
            xc = xs[:, c * Rc:(c + 1) * Rc]
            xl = (xc[r * El:(r + 1) * El] if same_tokens
                  else _Dispatch.apply(xc, pg, n))
            sc = torch.clamp(mine - c * Rc, 0, Rc).to(torch.int32)
            h = act(grouped_matmul(xl.reshape(El * Rc, -1), w1, sc).reshape(
                El, Rc, -1) + b1)
            yl = report_op("expert_ffn", grouped_matmul(
                h.reshape(El * Rc, -1), w2, sc).reshape(El, Rc, -1) + b2)
            ys.append(_Combine.apply(yl, pg, n))
        ways = 1 if same_tokens else 2
        moe_comm.note_a2a(f"moe/a2a/{self.ep_axis}x{n}",
                          ways * xs.numel() * xs.element_size(),
                          calls=ways * chunks)
        return torch.cat(ys, dim=1)

    def _forward_dense(self, x):
        combine, dispatch, _ = self.gate(x)
        d, xv = amp.cast_inputs("moe_dispatch", dispatch, x)
        xe = torch.einsum("tec,tm->ecm", d, xv)
        if self._stacked:
            ye = self.experts(xe)
        else:
            ye = torch.stack([self.experts[i](xe[i])
                              for i in range(self.num_expert)])
        c, yv = amp.cast_inputs("moe_combine", combine, ye)
        return torch.einsum("tec,ecm->tm", c, yv)
