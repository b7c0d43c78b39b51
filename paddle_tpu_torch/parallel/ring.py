"""Ring attention: context parallelism over a sep process group
(↔ paddle_tpu/parallel/ring.py).

The reference is a `shard_map` body over global [B, S, H, D] arrays whose
sequence the `sep` mesh axis cuts: K/V blocks rotate around the ring by
`ppermute` while each device keeps a running online-softmax accumulator.
Here each process is one rank of the sep group and `ring_attention` works
on its own chunk: q [B, L, H, D] and k/v [B, L, Hkv, D], chunk index = the
rank's index r in the group, n = the group's size, global sequence n * L.

Forward (the reference's `_local_ring_attention` :29-79): q in f32, viewed
as [B, L, Hkv, G, D] (G = H / Hkv query heads a kv head; the GQA group
broadcast in the products, so K/V travel unexpanded, Hkv heads a hop).
The local block first, then n - 1 hops: each hop sends the K/V block this
rank holds to rank r + 1 and receives rank r - 1's, paired in one
`batch_isend_irecv`. Block s (from chunk (r - s) mod n) updates

    m' = max(m, rowmax(S)),  acc = acc e^{m - m'} + e^{S - m'} V,
    l = l e^{m - m'} + rowsum(e^{S - m'}),  out = acc / max(l, 1e-30),

in f32 with S = scale q k^T, an entry masked by causality at -1e30. The
causal mask is by global position: query row r L + i sees key column
src L + j when src L + j <= r L + i. A block from a later chunk (src > r)
lies wholly above the diagonal, and the reference's -1e30 makes it add
exactly nothing once the diagonal block has set every row's maximum, so
it is skipped (it still travels on around the ring).

Backward (an autograd Function): the reference gets O(L) memory from
`jax.checkpoint` on each block; here the forward saves q, k, v, out and
the rows' log-sum-exp, m + log(max(l, 1e-30)), and the backward runs the
ring again, recomputing each block's probabilities P = exp(S - lse):
dV += P^T dO, dS = P (dO V^T - rowsum(dO O)), dQ += scale dS K,
dK += scale dS^T Q. dQ accumulates where it is; the f32 dK/dV
accumulators travel with their K/V block (one batch of four tensors a
hop) and after n - 1 hops a last hop of the two carries them to the
block's owner, which then holds its chunk's dK and dV.

At n = 1 the ring makes no hop in the forward and the backward's last
hop is to the rank itself: a local hand-off, since NCCL has no send to
oneself. The same code runs at every n.

`RING_CALLS` counts what went around a ring: "hops" (one
`batch_isend_irecv` each) and "bytes" (what this rank sent); the sends
and receives are counted in the registry's `collective_calls_total` /
`collective_bytes_total` too.
`ring_attention_spmd` is the reference's spelling over a mesh's sep group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed import collective as C
from ..distributed import env as _env

__all__ = ["RING_CALLS", "ring_attention", "ring_attention_spmd"]

RING_CALLS: dict = {}   # "hops" / "bytes": what went around a ring

_NEG = -1e30
_warmed: set = set()    # process groups whose first collective ran


def _count(op, n=1):
    RING_CALLS[op] = RING_CALLS.get(op, 0) + n


class _Ring:
    """This rank's place on the ring of process group `pg` (None: a ring
    of one)."""

    def __init__(self, pg):
        pg = getattr(pg, "process_group", pg)
        self.pg = pg
        self.n, self.r = 1, 0
        if pg is not None:
            ranks = dist.get_process_group_ranks(pg)
            self.n, self.r = len(ranks), dist.get_rank(pg)
            self.me = ranks[self.r]
            self.next = ranks[(self.r + 1) % self.n]
            self.prev = ranks[(self.r - 1) % self.n]

    def hop(self, tensors):
        """Send `tensors` to the next rank and receive the previous rank's
        tensors of the same shapes, one batch; a hop to this rank itself
        (a ring of one) hands them over as they are."""
        if self.pg is None or self.next == self.me:
            return list(tensors)
        if self.pg not in _warmed:
            # NCCL wants every rank of a group in its first collective
            _warmed.add(self.pg)
            C._all_reduce(torch.zeros(1, device=tensors[0].device), self.pg)
        got = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, g in zip(tensors, got):
            t = t.contiguous()
            ops.append(dist.P2POp(dist.isend, t, self.next, group=self.pg))
            ops.append(dist.P2POp(dist.irecv, g, self.prev, group=self.pg))
            nbytes = t.numel() * t.element_size()
            C.record_collective_traffic("send", nbytes)
            C.record_collective_traffic("recv", nbytes)
            _count("bytes", nbytes)
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        _count("hops")
        return got


def _logits(qf, kf, scale, causal, r, src, L):
    """[B, Hkv, G, L, L] f32 block logits of query chunk r against key
    chunk src, masked by global position."""
    s = torch.einsum("bhgid,bjhd->bhgij", qf, kf) * scale
    if causal:
        rows = torch.arange(L, device=qf.device)
        keep = (src * L + rows)[None, :] <= (r * L + rows)[:, None]
        s = s.masked_fill(~keep, _NEG)
    return s


def _skipped(causal, r, src):
    return causal and src > r


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        ring = _Ring(group)
        n, r = ring.n, ring.r
        B, L, H, D = q.shape
        Hkv = k.shape[2]
        G = H // Hkv
        qf = q.float().reshape(B, L, Hkv, G, D).permute(0, 2, 3, 1, 4)
        m = torch.full((B, Hkv, G, L), _NEG, device=q.device)
        l = torch.zeros((B, Hkv, G, L), device=q.device)
        acc = torch.zeros((B, Hkv, G, L, D), device=q.device)
        ks, vs = k, v
        for s in range(n):
            if s:
                ks, vs = ring.hop([ks, vs])
            src = (r - s) % n
            if _skipped(causal, r, src):
                continue
            logits = _logits(qf, ks.float(), scale, causal, r, src, L)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            del logits
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgij,bjhd->bhgid", p, vs.float())
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, L, H, D)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring = _Ring(ctx.group)
        n, r = ring.n, ring.r
        causal, scale = ctx.causal, ctx.scale
        B, L, H, D = q.shape
        Hkv = k.shape[2]
        G = H // Hkv

        def heads(t):   # [B, L, H, D] -> [B, Hkv, G, L, D] in f32
            return t.float().reshape(B, L, Hkv, G, D).permute(0, 2, 3, 1, 4)

        qf, do = heads(q), heads(dout)
        delta = (do * heads(out)).sum(-1)               # rowsum(dO O)
        dq = torch.zeros_like(qf)
        ks, vs = k, v
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        for s in range(n):
            if s:
                ks, vs, dk, dv = ring.hop([ks, vs, dk, dv])
            src = (r - s) % n
            if _skipped(causal, r, src):
                continue
            kf, vf = ks.float(), vs.float()
            p = torch.exp(_logits(qf, kf, scale, causal, r, src, L)
                          - lse[..., None])
            dv += torch.einsum("bhgij,bhgid->bjhd", p, do)
            ds = p * (torch.einsum("bhgid,bjhd->bhgij", do, vf)
                      - delta[..., None])
            del p
            dq += torch.einsum("bhgij,bjhd->bhgid", ds, kf) * scale
            dk += torch.einsum("bhgij,bhgid->bjhd", ds, qf) * scale
        # the accumulators of block r + 1 go to their owner (to this rank
        # itself in a ring of one)
        dk, dv = ring.hop([dk, dv])
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, L, H, D)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, group, causal=True, scale=None):
    """Exact attention of this rank's query chunk q [B, L, H, D] over the
    whole sequence whose chunks k/v [B, L, Hkv, D] the ranks of `group` (a
    torch ProcessGroup or a `collective.Group`; None is a ring of one)
    hold, chunk index = the rank's index in the group. Returns the chunk's
    output [B, L, H, D] in q's dtype."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not group over "
                         f"{k.shape[2]} kv heads")
    return _RingAttention.apply(q, k, v, group, bool(causal), float(scale))


def ring_attention_spmd(q, k, v, mesh, axis="sep", causal=True, scale=None):
    """The reference's entry (:95) over `mesh`'s `axis` group; q/k/v are
    this rank's chunks, as in `ring_attention`."""
    return ring_attention(q, k, v, _env.mesh_group(mesh, axis), causal, scale)
