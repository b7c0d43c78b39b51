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

Not ported: expert parallelism. The port has no device mesh yet (ROADMAP
A9): on one device `ep` is 1, the JAX package runs exactly this path and
`ep_axis` changes nothing; a process group (`moe_group`, `mp_group`)
raises NotImplementedError, and the all-to-all accounting of
`distributed/moe_comm.py` comes with A9. The `PADDLE_TPU_MOE_FAST` and
`PADDLE_TPU_MOE_A2A_CHUNKS` switches are not ported: the form follows the
experts and the gate.
"""

from __future__ import annotations

import torch
from torch import nn

from ..... import amp
from .....device import resolve_device
from .....nn.layer.common import init_weight
from .....nn.layer.container import LayerList
from .....ops.grouped_gemm import grouped_matmul, row_stride
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["ExpertFFN", "MoELayer"]

# the experts' activations by jax.nn name (jax.nn.gelu is the tanh form)
_ACTIVATIONS = {"gelu": lambda t: nn.functional.gelu(t, approximate="tanh")}


def _activation(name):
    if name not in _ACTIVATIONS:
        raise NotImplementedError(f"expert activation {name!r}: the port "
                                  f"has {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


class ExpertFFN(nn.Module):
    """Stacked expert FFN (↔ moe_layer.py:89): every expert's weights in one
    [E, ...] tensor, w1 [E, M, H], b1 [E, 1, H], w2 [E, H, M], b2 [E, 1, M];
    weights Xavier-uniform from `generator`, biases zero (the reference's
    `create_parameter` defaults)."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu",
                 ep_axis=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.num_experts = num_experts
        self.activation = activation
        _activation(activation)

        def weight(*shape):
            return nn.Parameter(init_weight(
                torch.empty(*shape, device=dev, dtype=dtype), None,
                "xavier_uniform", generator))

        def bias(*shape):
            return nn.Parameter(torch.zeros(*shape, device=dev, dtype=dtype))

        self.w1 = weight(num_experts, d_model, d_hidden)
        self.b1 = bias(num_experts, 1, d_hidden)
        self.w2 = weight(num_experts, d_hidden, d_model)
        self.b2 = bias(num_experts, 1, d_model)

    def forward(self, xe):
        """xe [E, C, M] -> [E, C, M] (the dense path's batched GEMMs)."""
        x, w1, b1, w2, b2 = amp.cast_inputs("expert_ffn", xe, self.w1,
                                            self.b1, self.w2, self.b2)
        h = _activation(self.activation)(torch.einsum("ecm,emh->ech", x, w1)
                                         + b1)
        return torch.einsum("ech,ehm->ecm", h, w2) + b2


_GATES = {"gshard": GShardGate, "switch": SwitchGate, "naive": NaiveGate}


class MoELayer(nn.Module):
    """↔ moe_layer.py:130 — MoELayer(d_model, experts, gate, ...).

    `experts` is an `ExpertFFN` (the sorted fast path) or a list of modules,
    each applied to its expert's [C, M] slice (the dense path). `gate` is a
    `BaseGate` or a config dict {"type": "gshard" | "switch" | "naive",
    "top_k": k, ...} as in the reference; a gate built from a config is
    made on `device` with weights from `generator` and its routing
    generator seeded with `seed`."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, ep_axis=None, name=None,
                 *, seed=0, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        if moe_group is not None or mp_group is not None:
            raise NotImplementedError(
                "MoE over process groups (expert parallelism) is ported with "
                "the distributed slice (ROADMAP A9)")
        self.d_model = d_model
        self.ep_axis = ep_axis
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

    def forward(self, inp):
        shape = inp.shape
        x = inp.reshape(-1, self.d_model)
        gate_cls = type(self.gate)
        # a gate that only defines the dense routing, or overrides it,
        # stays on the dense path (moe_layer.py:303-310)
        fast = (self._stacked
                and gate_cls._probs_and_keep is not BaseGate._probs_and_keep
                and gate_cls._routing is BaseGate._routing
                and getattr(self.gate, "gate", None) is not None)
        out = self._forward_fast(x) if fast else self._forward_dense(x)
        return out.reshape(*shape[:-1], self.d_model)

    def _forward_fast(self, x):
        gate, e = self.gate, self.experts
        S, M = x.shape
        E, k = self.num_expert, gate.top_k
        cap = gate.capacity(S)
        R = row_stride(cap)
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

        # capacity overflow drops the pair into the sentinel row E * R
        kept = valid & (pos < cap)
        slot = torch.where(kept, eid * R + pos, torch.full_like(eid, E * R))
        xs = x.new_zeros(E * R + 1, M).index_copy(0, slot, x[tok])[:E * R]
        sizes = torch.clamp(counts, max=cap).to(torch.int32)  # live rows a group

        h = act(grouped_matmul(xs, w1, sizes).reshape(E, R, -1) + b1)
        y = grouped_matmul(h.reshape(E * R, -1), w2, sizes).reshape(E, R, M) + b2
        y = torch.cat([y.reshape(E * R, M), y.new_zeros(1, M)])
        g = y.index_select(0, slot)
        out = (wts[:, None].to(x.dtype) * g).reshape(k, S, M).sum(0)
        gate.set_loss(l_aux)
        return out

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
