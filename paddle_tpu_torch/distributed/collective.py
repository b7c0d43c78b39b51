"""Groups and collectives with Paddle's per-rank semantics
(↔ paddle_tpu/distributed/collective.py).

The JAX package's eager collectives act on stacked global arrays, one slice
per rank, because one controller plays every rank. Here each process is one
rank and each call is the `torch.distributed` collective on this rank's
tensor, in place where Paddle's is: `all_reduce(t)` leaves the reduction in
`t`, `all_gather(lst, t)` appends every rank's tensor to `lst`,
`reduce_scatter(t, lst)` leaves in `t` the reduction of every rank's
`lst[rank]`, and so on. Ranks given as `src`/`dst` are global ranks, as in
Paddle. With `sync_op=False` a call returns the work handle to `wait()` on.

Every call adds one to the registry family `collective_calls_total{op=}`
and its payload to `collective_bytes_total{op=}` of
`observability.metrics.default_registry()` (reference
`record_collective_traffic`, :66-108); `traffic(since)` reads them as
{"calls": {op: n}, "bytes": {op: n}} over a window. The training step's
own all-gathers, reduce-scatters and all-reduces go through
`_all_gather_flat`, `_reduce_scatter_flat` and `_all_reduce`, are counted
the same way and run under a `comm_watchdog.comm_task` named by the op,
so the `StepTimeline` sees their (host) intervals; the MoE layer's
all-to-alls go through `moe_comm.all_to_all`, under kind "a2a".

The compiled-form `primitives` of the reference (:652-700) are shard_map
bodies. Their eager counterparts for the model-parallel region are the
autograd functions at the end of this module, each over a torch process
group (the mesh's mp group, `env.mesh_group(mesh, "mp")`), on the current
stream, counted like the rest:

- `c_identity`: identity forward, all-reduce backward (Paddle's
  `_c_identity`, the input of a column-parallel layer);
- `mp_allreduce`: all-reduce forward, identity backward (the output of a
  row-parallel layer);
- `c_split` / `c_concat`: this rank's part of a dim forward and the
  all-gather backward, and the dual (a row-parallel input that is not yet
  parallel, a column-parallel output that is gathered);
- `all_gather_seq` / `reduce_scatter_seq`: along the sequence dim, the
  all-gather forward and reduce-scatter backward, and the reverse (the
  entry and exit of a sequence-parallel block).

They call their collective whatever the group's size, so a one-rank group
runs the code that a larger one does.
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

from ..observability.metrics import HandleCache, default_registry
from . import env as _env
from .comm_watchdog import comm_task

__all__ = ["Group", "P2POp", "ReduceOp", "all_gather",
           "all_gather_object", "all_reduce", "alltoall", "alltoall_single",
           "all_gather_seq", "barrier", "batch_isend_irecv", "broadcast",
           "broadcast_object_list", "c_concat", "c_identity", "c_split",
           "destroy_process_group", "gather_along", "get_group",
           "irecv", "isend", "mp_allreduce", "new_group",
           "record_collective_traffic", "recv", "reduce", "reduce_scatter",
           "reduce_scatter_seq", "scatter", "scatter_object_list", "send",
           "traffic", "wait"]

_HANDLES = HandleCache(lambda reg: (
    reg.counter("collective_calls_total", "eager collective invocations",
                ("op",)),
    reg.counter("collective_bytes_total",
                "payload bytes through eager collectives", ("op",)),
))


def record_collective_traffic(op: str, nbytes: int, calls: int = 1):
    """Bump collective_{calls,bytes}_total{op=} (reference :73-93)."""
    calls_, bytes_ = _HANDLES.get()
    calls_.inc(calls, op=op)
    if nbytes:
        bytes_.inc(int(nbytes), op=op)


def traffic(since=None) -> dict:
    """{"calls": {op: n}, "bytes": {op: n}} of the collectives counted since
    `since` (a `default_registry().snapshot()`; None: since the start),
    each count an int."""
    reg = default_registry()
    d = reg.delta(since) if since is not None else reg.snapshot()
    out = {"calls": {}, "bytes": {}}
    for key, v in d.items():
        for fam, part in (("collective_calls_total{op=", "calls"),
                          ("collective_bytes_total{op=", "bytes")):
            if key.startswith(fam):
                out[part][key[len(fam):-1]] = int(v)
    return out


def _record(op, *tensors):
    record_collective_traffic(
        op, sum(t.numel() * t.element_size() for t in tensors))


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


def _op(op):
    if op not in _TORCH_OPS and op != ReduceOp.AVG:
        raise ValueError(f"unsupported reduce op {op!r}")
    return _TORCH_OPS.get(op, dist.ReduceOp.SUM)


def _finish_avg(tensor, op, n):
    """gloo has no AVG: the sum, divided by the group's size."""
    if op == ReduceOp.AVG:
        tensor.div_(n)


class Group:
    """A set of ranks and its torch process group (reference group.py)."""

    def __init__(self, pg=None, ranks=None, gid=None, axis_names=None):
        self.process_group = pg
        self.ranks = (list(ranks) if ranks is not None
                      else dist.get_process_group_ranks(pg) if pg is not None
                      else list(range(_env.get_world_size())))
        self.nranks = len(self.ranks)
        self.id = gid if gid is not None else next(_gids)
        self.axis_names = tuple(axis_names) if axis_names else None
        _groups[self.id] = self

    @property
    def rank(self):
        r = _env.get_rank()
        return self.ranks.index(r) if r in self.ranks else -1

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks}, axes={self.axis_names})"


_groups: dict = {}
_gids = itertools.count(1)


def _world():
    g = _groups.get(0)
    if g is None or g.process_group is not dist.group.WORLD:
        g = Group(dist.group.WORLD, list(range(dist.get_world_size())), gid=0)
    return g


def _pg(group):
    return (group or _world()).process_group


def get_group(gid=0) -> Group:
    return _groups[gid] if gid in _groups else _world()


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """reference collective.py new_group; every rank must call it."""
    ranks = sorted(ranks) if ranks is not None else list(range(dist.get_world_size()))
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw)
    return Group(pg, ranks)


def destroy_process_group(group=None):
    """Destroy `group`, or with None the default group and every group."""
    if group is None:
        _groups.clear()
        _env.set_global_mesh(None)
        if _env.is_initialized():
            dist.destroy_process_group()
        return
    _groups.pop(group.id, None)
    if group.process_group is not None:
        dist.destroy_process_group(group.process_group)


class _Done:
    """The handle of a call made with sync_op=True: already complete."""

    def wait(self):
        return True

    def is_completed(self):
        return True


def _task(work, sync_op):
    if sync_op:
        if work is not None:
            work.wait()
        return _Done()
    return work


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    _record("all_reduce", tensor)
    g = group or _world()
    dist.all_reduce(tensor, op=_op(op), group=g.process_group)
    _finish_avg(tensor, op, g.nranks)
    return _Done()


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    _record("reduce", tensor)
    g = group or _world()
    dist.reduce(tensor, dst, op=_op(op), group=g.process_group)
    if _env.get_rank() == dst:
        _finish_avg(tensor, op, g.nranks)
    return _Done()


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Append every rank's `tensor` to `tensor_list` (in group order)."""
    _record("all_gather", tensor)
    g = group or _world()
    out = [torch.empty_like(tensor) for _ in range(g.nranks)]
    dist.all_gather(out, tensor.contiguous(), group=g.process_group)
    tensor_list.extend(out)
    return _Done()


def all_gather_object(object_list, obj, group=None):
    _record("all_gather_object")
    g = group or _world()
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.process_group)
    object_list.extend(out)
    return _Done()


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """`tensor` becomes the reduction over the ranks of their
    `tensor_list[my group rank]`."""
    _record("reduce_scatter", *tensor_list)
    g = group or _world()
    task = _task(dist.reduce_scatter(
        tensor, [t.contiguous() for t in tensor_list], op=_op(op),
        group=g.process_group, async_op=not sync_op), sync_op)
    if sync_op:
        _finish_avg(tensor, op, g.nranks)
    return task


def broadcast(tensor, src, group=None, sync_op=True):
    _record("broadcast", tensor)
    work = dist.broadcast(tensor, src, group=_pg(group), async_op=not sync_op)
    return _task(work, sync_op)


def broadcast_object_list(object_list, src=0, group=None):
    _record("broadcast_object_list")
    dist.broadcast_object_list(object_list, src, group=_pg(group))
    return _Done()


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """`tensor` becomes `tensor_list[my group rank]` of rank `src`."""
    _record("scatter", *(tensor_list or [tensor]))
    me = _env.get_rank()
    lst = [t.contiguous() for t in tensor_list] if me == src else None
    work = dist.scatter(tensor, lst, src=src, group=_pg(group),
                        async_op=not sync_op)
    return _task(work, sync_op)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    _record("scatter_object_list")
    out = [None]
    dist.scatter_object_list(out, in_object_list if _env.get_rank() == src
                             else None, src=src, group=_pg(group))
    out_object_list.append(out[0])
    return _Done()


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank i sends `in_tensor_list[j]` to rank j; `out_tensor_list` gets
    what every rank sent to this one, in group order (counted as
    all_to_all, as `alltoall_single` is)."""
    _record("all_to_all", *in_tensor_list)
    out = [torch.empty_like(t) for t in in_tensor_list]
    work = dist.all_to_all(out, [t.contiguous() for t in in_tensor_list],
                           group=_pg(group), async_op=not sync_op)
    out_tensor_list.extend(out)
    return _task(work, sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    _record("all_to_all", in_tensor)
    work = dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                                  output_split_sizes=out_split_sizes,
                                  input_split_sizes=in_split_sizes,
                                  group=_pg(group), async_op=not sync_op)
    return _task(work, sync_op)


def send(tensor, dst=0, group=None, sync_op=True):
    _record("send", tensor)
    if sync_op:
        dist.send(tensor.contiguous(), dst, group=_pg(group))
        return _Done()
    return dist.isend(tensor.contiguous(), dst, group=_pg(group))


def recv(tensor, src=0, group=None, sync_op=True):
    _record("recv", tensor)
    if sync_op:
        dist.recv(tensor, src, group=_pg(group))
        return _Done()
    return dist.irecv(tensor, src, group=_pg(group))


def isend(tensor, dst, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=None, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One send or receive of `batch_isend_irecv`: `op` is `isend` or
    `irecv`, `peer` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp takes isend or irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Start every send and receive of the list; returns their handles."""
    for p in p2p_op_list:
        _record("send" if p.op is isend else "recv", p.tensor)
    ops = [dist.P2POp(dist.isend if p.op is isend else dist.irecv,
                      p.tensor, p.peer, group=_pg(p.group))
           for p in p2p_op_list]
    return dist.batch_isend_irecv(ops)


def barrier(group=None):
    _record("barrier")
    dist.barrier(group=_pg(group))
    return _Done()


def wait(tensor, group=None, use_calc_stream=True):
    """Paddle's wait on a tensor's collective: the collectives above finish
    before they return unless sync_op=False, whose handles are waited on
    themselves; on the card this orders the current stream."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


# -- the training step's collectives: flat buffers, counted ----------------- #

_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _all_gather_flat(out, inp, pg, async_op=False):
    """out [n * k] <- every rank's inp [k], in group order."""
    _record("all_gather", inp)
    with comm_task("all_gather"):
        return _all_gather_single(out, inp, group=pg, async_op=async_op)


def _reduce_scatter_flat(out, inp, pg, async_op=False):
    """out [k] <- the sum over the ranks of their inp[r * k:(r + 1) * k]."""
    _record("reduce_scatter", inp)
    with comm_task("reduce_scatter"):
        return _reduce_scatter_single(out, inp, group=pg, async_op=async_op)


def _all_reduce(t, pg, async_op=False, op=dist.ReduceOp.SUM):
    _record("all_reduce", t)
    with comm_task("all_reduce"):
        return dist.all_reduce(t, op=op, group=pg, async_op=async_op)


def _all_to_all(out, inp, pg, async_op=False):
    """out [n * k] <- block r of every rank r's inp [n * k] (equal
    splits), in group order."""
    _record("all_to_all", inp)
    return dist.all_to_all_single(out, inp, group=pg, async_op=async_op)


# -- the model-parallel region: autograd functions over a process group ----- #

def _dim(x, dim):
    return dim % x.dim()


def _parts(x, dim, pg):
    """(group size, this rank's index, x's size along dim / group size)."""
    n, dim = dist.get_world_size(pg), _dim(x, dim)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over the {n} ranks of the model-parallel group")
    return n, dist.get_rank(pg), x.shape[dim] // n


def split_along(x, dim, pg):
    """This rank's part of x along dim (a view: no collective)."""
    n, r, k = _parts(x, dim, pg)
    return x.narrow(_dim(x, dim), r * k, k)


def gather_along(x, dim, pg):
    """Every rank's x concatenated along dim, in group order."""
    dim, n = _dim(x, dim), dist.get_world_size(pg)
    flat = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    _all_gather_flat(flat, x.contiguous().reshape(-1), pg)
    out = flat.view(n, *x.shape)
    if dim == 0:
        return out.reshape(n * x.shape[0], *x.shape[1:])
    return out.movedim(0, dim).reshape(
        *x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])


def reduce_scatter_along(x, dim, pg):
    """The sum over the ranks of their x, of which this rank keeps its
    part along dim."""
    n, _, k = _parts(x, dim, pg)
    dim = _dim(x, dim)
    rows = x.unflatten(dim, (n, k)).movedim(dim, 0).contiguous()
    out = torch.empty(rows.shape[1:], dtype=x.dtype, device=x.device)
    _reduce_scatter_flat(out.view(-1), rows.view(-1), pg)
    return out


def all_reduce_sum(x, pg):
    out = x.contiguous().clone()
    _all_reduce(out, pg)
    return out


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.pg), None


class _MPAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return all_reduce_sum(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return split_along(x, dim, pg).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_along(g, ctx.dim, ctx.pg), None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return gather_along(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return split_along(g, ctx.dim, ctx.pg).contiguous(), None, None


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return gather_along(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_along(g, ctx.dim, ctx.pg), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return reduce_scatter_along(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return gather_along(g, ctx.dim, ctx.pg), None, None


def c_identity(x, pg):
    """Identity forward, all-reduce of the gradient over pg backward."""
    return _CIdentity.apply(x, pg)


def mp_allreduce(x, pg):
    """All-reduce (sum) over pg forward, identity backward."""
    return _MPAllReduce.apply(x, pg)


def c_split(x, pg, dim=-1):
    """This rank's part of x along dim forward, all-gather backward."""
    return _Split.apply(x, pg, dim)


def c_concat(x, pg, dim=-1):
    """All-gather along dim forward, this rank's part backward."""
    return _Concat.apply(x, pg, dim)


def all_gather_seq(x, pg, dim=1):
    """All-gather along the sequence dim forward, reduce-scatter backward."""
    return _AllGatherSeq.apply(x, pg, dim)


def reduce_scatter_seq(x, pg, dim=1):
    """Reduce-scatter along the sequence dim forward, all-gather backward."""
    return _ReduceScatterSeq.apply(x, pg, dim)
