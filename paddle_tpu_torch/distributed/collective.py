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

Every call adds one to `CALLS[op]` and its payload to `BYTES[op]`
(reference `record_collective_traffic`, :73-108), as each kernel wrapper
counts its launches in `LAUNCHES`; the training step's own all-gathers,
reduce-scatters and all-reduces go through `_all_gather_flat`,
`_reduce_scatter_flat` and `_all_reduce` and are counted the same way. The
counters stay module objects until the observability module is ported
(ROADMAP queue A item 7). The compiled-form `primitives` of the reference
(:652) are shard_map bodies and come with items 1b-1d.
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

from . import env as _env

__all__ = ["CALLS", "BYTES", "Group", "P2POp", "ReduceOp", "all_gather",
           "all_gather_object", "all_reduce", "alltoall", "alltoall_single",
           "barrier", "batch_isend_irecv", "broadcast",
           "broadcast_object_list", "destroy_process_group", "get_group",
           "irecv", "isend", "new_group", "record_collective_traffic",
           "recv", "reduce", "reduce_scatter", "reset_counters", "scatter",
           "scatter_object_list", "send", "wait"]

CALLS: dict = {}   # op -> calls
BYTES: dict = {}   # op -> payload bytes


def record_collective_traffic(op: str, nbytes: int, calls: int = 1):
    CALLS[op] = CALLS.get(op, 0) + calls
    BYTES[op] = BYTES.get(op, 0) + int(nbytes)


def reset_counters():
    CALLS.clear()
    BYTES.clear()


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
    return _all_gather_single(out, inp, group=pg, async_op=async_op)


def _reduce_scatter_flat(out, inp, pg, async_op=False):
    """out [k] <- the sum over the ranks of their inp[r * k:(r + 1) * k]."""
    _record("reduce_scatter", inp)
    return _reduce_scatter_single(out, inp, group=pg, async_op=async_op)


def _all_reduce(t, pg, async_op=False):
    _record("all_reduce", t)
    return dist.all_reduce(t, group=pg, async_op=async_op)
