"""Sharded checkpoint save with a crash-safe commit protocol
(↔ paddle_tpu/distributed/checkpoint/save_state_dict.py).

Reference: python/paddle/distributed/checkpoint/save_state_dict.py:135 —
every rank writes the shards it owns plus rank-0 writes a metadata file
mapping global tensors → (offset, shape, file).

Each rank (a process of `torch.distributed`, or the one process) writes
one `{rank}_0.distcp` npz with the shards it owns, and rank 0 writes
`0.metadata`. A `LocalShard` entry (a ZeRO-3 parameter's shard, an mp cut,
an expert shard, a pipeline stage's rows; `DistributedTrainStep.
train_state()` gives them) is written from the tensor the rank holds, at
its offset in the global tensor, and never gathered; a replicated one by
the rank its `write` names. A plain tensor is the same on every rank and
rank 0 writes it: the reference's rule that the lowest rank holding a
replica writes it (:57-112).

The on-disk format is the reference's. A bfloat16 tensor is written as an
ml_dtypes bfloat16 array where ml_dtypes is installed (the reference's
bytes), else as its int16 bits, which `load_state_dict` reads back bit for
bit; both carry the dtype "bfloat16" in the metadata and the same crcs.

Commit protocol (crash safety): nothing is ever written into `path` itself.
All files land in `path + ".tmp"`; after shards and metadata are written and
fsync'd the coordinator drops a COMMIT marker and renames the directory to
`path` in one atomic step. A save killed at any instant leaves either the
previous committed checkpoint untouched, or a `.tmp` directory that
discovery (`latest_checkpoint`) ignores and the next save sweeps away. The
fault points `ckpt.before_shards`, `ckpt.mid_save`, `ckpt.before_commit`
and `ckpt.before_rename` sit where the reference's do (:149, :165, :198,
:204).

`async_save=True` takes the device-to-host snapshot on the caller's thread
(a synchronous copy into fresh host memory, so the training step's in-place
updates of parameters and moments cannot reach it: the reference's
`copy=True` note, :90-94) and writes and commits on a background thread, at
most one save in flight. Multi-process runs save synchronously: the
metadata all-gather doubles as the "all shards written" barrier.

The port adds telemetry the reference's save lacks: the seconds of each
part go to the registry counter `checkpoint_save_seconds_total{part=}`
(snapshot, shard_crc, write, file_crc, commit) and the bytes of the shard
file to `checkpoint_bytes_total{op="save"}`.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from ...framework.core import Tensor
from ...framework.dtype import _numpy_bf16
from ...observability.metrics import HandleCache
from .. import faults
from .metadata import (
    COMMIT_FILE,
    LocalShard,
    LocalTensorMetadata,
    Metadata,
    crc32_file,
    crc32_of,
    metadata_path,
)

__all__ = ["save_state_dict"]

_METRICS = HandleCache(lambda reg: (
    reg.counter("checkpoint_save_seconds_total",
                "sharded checkpoint save seconds, by part", ("part",)),
    reg.counter("checkpoint_bytes_total",
                "shard file bytes saved or loaded", ("op",)),
))


def _timed(part, t0):
    """Add the seconds since `t0` to the save's `part`; returns now."""
    now = time.perf_counter()
    _METRICS.get()[0].inc(now - t0, part=part)
    return now


def _rank_and_world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard_key(name, offset):
    return name + "|" + ",".join(map(str, offset))


def _host_array(t):
    """A host numpy copy of t (a torch tensor, a `Tensor`, host data): the
    copy is load-bearing, since the step updates its tensors in place while
    an async save writes. bfloat16 as ml_dtypes' type where installed, else
    its int16 bits; the second value is the metadata's dtype string."""
    if isinstance(t, Tensor):
        t = t._value
    if not isinstance(t, torch.Tensor):
        arr = np.array(t, copy=True)
        return arr, str(arr.dtype)
    t = t.detach()
    host = t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
    if host.dtype is torch.bfloat16:
        bits = host.contiguous().view(torch.int16).numpy()
        nd = _numpy_bf16()
        return (bits.view(nd) if nd is not None else bits), "bfloat16"
    arr = host.contiguous().numpy()
    return arr, str(arr.dtype)


def _snapshot(state_dict):
    """Device→host snapshot: shard arrays (np copies), metadata entries, and
    the shard file name this rank will write. Runs on the caller's thread
    so an async save is immune to later in-place updates of the tensors."""
    t0 = time.perf_counter()
    rank, nproc = _rank_and_world()
    fname = f"{rank}_0.distcp"
    shards = {}
    meta_entries = {}
    global_shapes = {}

    for name, t in state_dict.items():
        parts = t if isinstance(t, (list, tuple)) else [t]
        entries = []
        for part in parts:
            if isinstance(part, LocalShard):
                global_shapes[name] = tuple(part.global_shape)
                if not part.write:
                    continue
                offset = tuple(int(o) for o in part.global_offset)
                data, dtype = _host_array(part.tensor)
            else:
                data, dtype = _host_array(part)
                global_shapes[name] = tuple(data.shape)
                if rank != 0:
                    continue   # the same on every rank: rank 0 writes it
                offset = (0,) * data.ndim
            key = _shard_key(name, offset)
            shards[key] = data
            # checksum filled in by _write_and_commit — hashing belongs on
            # the (possibly background) write thread, not on the train one
            entries.append(LocalTensorMetadata(
                offset, tuple(data.shape), dtype, fname, key))
        if entries:
            meta_entries[name] = entries
    _timed("snapshot", t0)
    return shards, meta_entries, global_shapes, fname


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _all_gather_object(obj):
    from ..collective import all_gather_object

    gathered = []
    all_gather_object(gathered, obj)
    return gathered


def _write_and_commit(plan, path, coordinator_rank, post_commit=None):
    shards, meta_entries, global_shapes, fname = plan
    rank, nproc = _rank_and_world()
    is_coord = rank == coordinator_rank or nproc == 1
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    # no rmtree of a stale tmp here: a peer may already be writing its
    # shard into tmp; leftovers of a crashed save are swept by the
    # coordinator after the gather (when every peer has finished writing)
    os.makedirs(tmp, exist_ok=True)
    if is_coord:
        # a save that died between COMMIT and rename leaves a committed-
        # looking tmp; drop the marker first so the rebuilt tmp can never
        # be mistaken for complete before this save's own commit
        try:
            os.unlink(os.path.join(tmp, COMMIT_FILE))
        except OSError:
            pass

    faults.fault_point("ckpt.before_shards")
    t = time.perf_counter()
    for entries in meta_entries.values():
        for e in entries:
            e.checksum = crc32_of(np.ascontiguousarray(shards[e.key]))
    t = _timed("shard_crc", t)
    # stream the npz straight to disk, then crc the written file: the
    # recorded checksum covers the exact on-disk bytes
    fpath = os.path.join(tmp, fname)
    with open(fpath, "wb") as f:
        np.savez(f, **shards)  # exact name (np.savez would append .npz)
        f.flush()
        os.fsync(f.fileno())
    t = _timed("write", t)
    _METRICS.get()[1].inc(os.path.getsize(fpath), op="save")
    file_crc = crc32_file(fpath)
    t = _timed("file_crc", t)
    faults.fault_point("ckpt.mid_save")  # shards on disk, metadata absent

    file_checksums = {fname: file_crc}
    # the gather is also the barrier proving every rank finished its shard
    # file: COMMIT must never cover a file still being written
    if nproc > 1:
        merged, shapes, crcs = {}, {}, {}
        for me, gs, fc in _all_gather_object(
                (meta_entries, global_shapes, file_checksums)):
            shapes.update(gs)
            crcs.update(fc)
            for k, v in me.items():
                merged.setdefault(k, []).extend(v)
        meta_entries, global_shapes, file_checksums = merged, shapes, crcs

    if is_coord:
        # sweep strays from a previous crashed save of this same step
        keep = set(file_checksums) | {os.path.basename(metadata_path(tmp))}
        for stray in os.listdir(tmp):
            if stray not in keep and stray != COMMIT_FILE:
                try:
                    os.unlink(os.path.join(tmp, stray))
                except OSError:
                    pass
        Metadata(meta_entries, global_shapes,
                 file_checksums=file_checksums).save(metadata_path(tmp))
        faults.fault_point("ckpt.before_commit")  # metadata written, no COMMIT
        with open(os.path.join(tmp, COMMIT_FILE), "w") as f:
            f.write('{"format": 1}\n')
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        faults.fault_point("ckpt.before_rename")  # committed, not yet visible
        if os.path.isdir(path):
            _replace_into(tmp, path)
        else:
            os.rename(tmp, path)
        _fsync_dir(parent)
        _timed("commit", t)
    if nproc > 1:
        # post-commit barrier: no rank starts its next save into the same
        # tmp dir while the coordinator is still renaming this one
        _all_gather_object(("commit_done", path))
    if is_coord and post_commit is not None:
        post_commit()


def _replace_into(tmp, path):
    """Overwrite an existing checkpoint dir without deleting unrelated files
    kept alongside it: the old COMMIT falls first, the new one lands last,
    so the dir is never valid with mixed contents."""
    try:
        os.unlink(os.path.join(path, COMMIT_FILE))
    except OSError:
        pass
    for name in os.listdir(tmp):
        if name != COMMIT_FILE:
            os.replace(os.path.join(tmp, name), os.path.join(path, name))
    _fsync_dir(path)  # data entries durable BEFORE the marker lands...
    os.replace(os.path.join(tmp, COMMIT_FILE), os.path.join(path, COMMIT_FILE))
    _fsync_dir(path)  # ...and the marker durable before save() returns
    shutil.rmtree(tmp, ignore_errors=True)


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    unique_id=None, async_save=False, _post_commit=None):
    """Save `state_dict` to the directory `path` (atomically committed).

    With `async_save=True` (single-process only) returns a handle whose
    `.result()` waits for the commit; `checkpoint.wait_async_save()` drains
    the in-flight save globally.
    """
    plan = _snapshot(state_dict)
    if async_save and _rank_and_world()[1] == 1:
        from .manager import _async_saver

        return _async_saver.submit(
            lambda: _write_and_commit(plan, path, coordinator_rank,
                                      post_commit=_post_commit))
    _write_and_commit(plan, path, coordinator_rank, post_commit=_post_commit)
    return None
