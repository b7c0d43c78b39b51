"""Eager cross-process collectives on host values
(↔ paddle_tpu/distributed/eager_multiproc.py).

Reference analog: the eager ProcessGroupNCCL/Gloo collectives
(paddle/phi/core/distributed/collective/process_group_nccl.cc, python API
python/paddle/distributed/communication/*.py).

The JAX package runs one controller per host and emulates these on
`jax.experimental.multihost_utils` (an all-gather over the global devices,
then a local reduce or select). The port runs one process per rank, so
each function here is a `torch.distributed` call over the default group:
values are numpy arrays (or anything `np.asarray` takes) in and numpy
arrays out, staged through a tensor on this rank's device (`env.device()`:
its card under NCCL, the CPU under gloo). The reductions keep the
reference's semantics: the values are gathered and reduced on the host by
`_reduce_rows`, so "avg" of integers is a float mean and "prod" exists.

The store-based functions (`store_allreduce_group`, `cleanup_group_keys`,
`p2p_send` / `p2p_recv`) run over the port's native TCPStore
(`distributed.store`) with the reference's key layout, so a subgroup of
members only can reduce without the default group.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist

from . import env as _env

__all__ = ["allgather_objects", "allgather_values", "allreduce_value",
           "alltoall_single_value", "barrier", "broadcast_objects",
           "broadcast_value", "cleanup_group_keys", "nprocs", "p2p_recv",
           "p2p_send", "rank", "store_allreduce_group"]


def nprocs() -> int:
    """The world's size; 1 without a process group (one process)."""
    return dist.get_world_size() if _env.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if _env.is_initialized() else 0


def _staged(v):
    """(a tensor of v on this rank's device, v as a numpy array). bool
    travels as uint8 (NCCL has no bool)."""
    arr = np.ascontiguousarray(np.asarray(v))
    t = torch.from_numpy(arr.astype(np.uint8) if arr.dtype == np.bool_
                         else arr.copy())
    return t.to(_env.device()) if nprocs() > 1 else t, arr


def _host(t, like):
    out = t.cpu().numpy()
    return out.astype(np.bool_) if like.dtype == np.bool_ else out


def allgather_values(v):
    """[nprocs, ...]: every rank's value of the same shape, stacked in rank
    order."""
    t, arr = _staged(v)
    if nprocs() == 1:
        return arr[None].copy()
    parts = [torch.empty_like(t) for _ in range(nprocs())]
    dist.all_gather(parts, t)
    return np.stack([_host(p, arr) for p in parts])


def _reduce_rows(g, op):
    """Reduce a stacked [n, ...] array over its leading axis: the one
    reduce-op dispatch of every reduction here."""
    if op in ("sum",):
        return g.sum(axis=0)
    if op in ("max",):
        return g.max(axis=0)
    if op in ("min",):
        return g.min(axis=0)
    if op in ("prod",):
        return g.prod(axis=0)
    if op in ("avg",):
        return g.mean(axis=0)
    raise ValueError(f"unsupported reduce op {op!r}")


def allreduce_value(v, op="sum"):
    return _reduce_rows(allgather_values(v), op)


def allgather_objects(obj):
    """Every rank's picklable object, in rank order (reference
    all_gather_object, communication/all_gather.py)."""
    if nprocs() == 1:
        return [pickle.loads(pickle.dumps(obj))]
    out = [None] * nprocs()
    dist.all_gather_object(out, obj)
    return out


def broadcast_value(v, src):
    """Rank `src`'s value (every rank passes one of the same shape)."""
    t, arr = _staged(v)
    if nprocs() > 1:
        dist.broadcast(t, src)
    return _host(t, arr)


def broadcast_objects(objs, src):
    """Rank `src`'s picklable object."""
    if nprocs() == 1:
        return pickle.loads(pickle.dumps(objs))
    box = [objs]
    dist.broadcast_object_list(box, src)
    return box[0]


def barrier(name="paddle_tpu_torch_barrier"):
    """Every rank of the default group reaches this point (`name` names the
    reference's sync point and is not needed here)."""
    if nprocs() > 1:
        dist.barrier()


def alltoall_single_value(v, n):
    """Equal-split single-tensor all-to-all: row chunk j of every rank's
    input lands on rank j, concatenated in source order."""
    if v.shape[0] % n != 0:
        raise ValueError(
            f"alltoall_single: leading dim {v.shape[0]} not divisible by "
            f"world size {n}")
    t, arr = _staged(v)
    if nprocs() == 1:
        return arr.copy()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t)
    return _host(out, arr)


# --------------------------------------------------------------------------- #
# subgroup reduce and point-to-point over the native TCPStore
# --------------------------------------------------------------------------- #

_group_seq: dict = {}


def cleanup_group_keys(store, gid=None):
    """Delete this rank's residual gar/ keys (the rolling cleanup of
    store_allreduce_group keeps the last two rounds of each tag live;
    without this, communicators used once or twice leak keys for the job's
    life). Called on group destroy or shutdown; gid=None sweeps every
    tag."""
    me = rank()
    for tag, seq in list(_group_seq.items()):
        if gid is not None and not tag.endswith(f"#g{gid}"):
            continue
        for s in (seq - 1, seq - 2):
            if s >= 0:
                try:
                    store.delete_key(f"gar/{tag}/{s}/{me}")
                except (KeyError, OSError, RuntimeError):
                    pass  # deleted by a peer's sweep, or the store is gone
        _group_seq.pop(tag, None)


def store_allreduce_group(store, v, ranks, op="sum", gid=None):
    """A members-only subgroup all-reduce over the TCPStore: each member
    posts its value under a sequenced group key, waits for every member's
    post, and reduces. Non-members never take part, so members-only calls
    (the reference's new_group semantics) cannot deadlock the world, and
    different groups may reduce different shapes at once.

    Cleanup: a member's round s-2 key is deleted when it enters round s; by
    then every peer has posted round s-1, which needed its round s-2 reads
    done."""
    ranks = sorted(int(r) for r in ranks)
    # gid tells apart two communicators of the same members (new_group
    # called twice): their reductions must not mix
    tag = ",".join(map(str, ranks)) + (f"#g{gid}" if gid is not None else "")
    seq = _group_seq.get(tag, 0)
    _group_seq[tag] = seq + 1
    me = rank()
    store.set(f"gar/{tag}/{seq}/{me}", pickle.dumps(np.asarray(v)))
    keys = [f"gar/{tag}/{seq}/{r}" for r in ranks]
    store.wait(keys)
    vals = np.stack([pickle.loads(store.get(k)) for k in keys])
    if seq >= 2:
        try:
            store.delete_key(f"gar/{tag}/{seq - 2}/{me}")
        except (KeyError, OSError, RuntimeError):
            pass  # the rolling cleanup is best effort; the reduce is done
    return _reduce_rows(vals, op)


_seq: dict = {}


def p2p_send(store, value, src, dst):
    key = f"p2p/{src}->{dst}/{_seq.setdefault((src, dst), 0)}"
    _seq[(src, dst)] += 1
    store.set(key, pickle.dumps(np.asarray(value)))


def p2p_recv(store, src, dst):
    key = f"p2p/{src}->{dst}/{_seq.setdefault((src, dst), 0)}"
    _seq[(src, dst)] += 1
    store.wait([key])
    out = pickle.loads(store.get(key))
    # consumed: long send/recv loops must not grow the store
    try:
        store.delete_key(key)
    except (KeyError, OSError, RuntimeError):
        pass  # the value is read; a leaked key only costs store memory
    return out
