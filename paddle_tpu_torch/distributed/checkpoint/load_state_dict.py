"""Sharded checkpoint load onto the current placement
(↔ paddle_tpu/distributed/checkpoint/load_state_dict.py).

Reference: python/paddle/distributed/checkpoint/load_state_dict.py:476 —
reads the metadata, computes the overlap between saved shards and the
shards the current parallel config needs, and reads exactly those pieces.

Each entry of the target state dict is filled in place from the saved
shards that overlap it: a whole tensor (a `Parameter`, a buffer, a moment,
a `Tensor`) from the whole global tensor, a `LocalShard` (a ZeRO-3 shard,
an mp cut, an expert shard, a stage's rows) from the region it covers, so a
checkpoint written under one layout (a 2-rank ZeRO-3 step) loads under
another (one rank, mp 2) with no collective. Values are cast to the target's
dtype; a bfloat16 shard is read as bits, whether it was written as ml_dtypes'
bfloat16 (the reference's bytes, which np.load returns as 2-byte voids) or
as int16 bits (`save_state_dict` without ml_dtypes).

Integrity: before any target is written, every shard file the targets need
is verified against the crc32 recorded in the metadata and every target
name is looked up, so a corrupt file or a missing key raises before the
state changes (CheckpointCorruptError naming the file, KeyError naming the
key). A file without a recorded crc (a legacy save) has each shard checked
against its per-shard crc as it is read. A state dict with an `after_load()`
method (`jit.TrainStep.train_state()`) has it called after the fill. The
seconds of the file crcs and of the reads and copies go to the registry
counter `checkpoint_load_seconds_total{part=file_crc|read}`, the bytes of
the shard files to `checkpoint_bytes_total{op="load"}`.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ...framework.core import Tensor
from ...observability.metrics import HandleCache
from .metadata import (
    CheckpointCorruptError,
    LocalShard,
    Metadata,
    crc32_file,
    crc32_of,
    metadata_path,
)

__all__ = ["load_state_dict"]

_METRICS = HandleCache(lambda reg: (
    reg.counter("checkpoint_load_seconds_total",
                "sharded checkpoint load seconds, by part", ("part",)),
    reg.counter("checkpoint_bytes_total",
                "shard file bytes saved or loaded", ("op",)),
))


def _open_shard_file(path, fname, files_cache, file_checksums, files_crc_ok):
    """Verify + open a shard file once, caching the (lazy) npz handle."""
    fpath = os.path.join(path, fname)
    if fpath in files_cache:
        return files_cache[fpath]
    expected = file_checksums.get(fname, "")
    try:
        if expected:
            got = crc32_file(fpath)
            if got != expected:
                raise CheckpointCorruptError(
                    f"checkpoint shard file corrupt (checksum mismatch): "
                    f"{fpath} (expected {expected}, got {got})")
            files_crc_ok.add(fname)
    except OSError as e:
        raise CheckpointCorruptError(
            f"checkpoint shard file missing/unreadable: {fpath} ({e})") from e
    try:
        npz = np.load(fpath)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"checkpoint shard file missing: {fpath} ({e})") from e
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint shard file unparseable (truncated write?): {fpath} "
            f"({e})") from e
    files_cache[fpath] = npz
    return npz


def _as_torch(data, dtype):
    """A CPU torch tensor of a saved shard: bfloat16 from its bits."""
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(data).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(data))


def _assemble(meta_list, region, files_cache, path, file_checksums,
              verified, files_crc_ok):
    """The region (a tuple of (start, stop) per dim) of a global tensor as
    a CPU torch tensor, from the saved shards that overlap it."""
    out_shape = tuple(hi - lo for lo, hi in region)
    out = None
    for m in meta_list:
        # overlap of [offset, offset + shape) with the region
        src_sl, dst_sl = [], []
        for off, size, (rlo, rhi) in zip(m.global_offset, m.local_shape,
                                         region):
            lo, hi = max(off, rlo), min(off + size, rhi)
            if lo >= hi:
                break
            src_sl.append(slice(lo - off, hi - off))
            dst_sl.append(slice(lo - rlo, hi - rlo))
        else:
            npz = _open_shard_file(path, m.file_name, files_cache,
                                   file_checksums, files_crc_ok)
            try:
                data = npz[m.key]
            except Exception as e:
                raise CheckpointCorruptError(
                    f"shard '{m.key}' unreadable in "
                    f"{os.path.join(path, m.file_name)} ({e})") from e
            vkey = (m.file_name, m.key)
            if m.checksum and m.file_name not in files_crc_ok \
                    and vkey not in verified:
                if crc32_of(np.ascontiguousarray(data)) != m.checksum:
                    raise CheckpointCorruptError(
                        f"shard '{m.key}' corrupt (checksum mismatch) in "
                        f"{os.path.join(path, m.file_name)}")
                verified.add(vkey)
            piece = _as_torch(data, m.dtype)
            if tuple(m.global_offset) == tuple(r[0] for r in region) and \
                    tuple(piece.shape) == out_shape:
                return piece   # one shard is the whole region
            if out is None:
                out = torch.zeros(out_shape, dtype=piece.dtype)
            out[tuple(dst_sl)] = piece[tuple(src_sl)]
    if out is None:
        raise CheckpointCorruptError(
            f"checkpoint at {path} holds no shard of region {region}")
    return out


def _targets(value):
    """[(tensor to fill, region)] of one state dict entry."""
    parts = value if isinstance(value, (list, tuple)) else [value]
    out = []
    for part in parts:
        if isinstance(part, LocalShard):
            t = part.tensor._value if isinstance(part.tensor, Tensor) \
                else part.tensor
            out.append((t, tuple((o, o + s) for o, s in
                                 zip(part.global_offset, t.shape))))
        else:
            t = part._value if isinstance(part, Tensor) else part
            out.append((t, None))
    return out


def load_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    unique_id=None, offload=False):
    """Fill `state_dict`'s tensors in place from the checkpoint at `path`,
    each from the saved shards that cover its placement."""
    try:
        meta = Metadata.load(metadata_path(path))
    except OSError as e:
        raise CheckpointCorruptError(
            f"checkpoint metadata missing/unreadable: {metadata_path(path)} "
            f"({e}) — was this save interrupted before commit?") from e
    except (ValueError, KeyError, TypeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint metadata corrupt: {metadata_path(path)} ({e!r})") from e
    for name in state_dict:
        if name not in meta.state_dict_metadata:
            raise KeyError(f"{name} not found in checkpoint {path}")
    files_cache, verified, files_crc_ok = {}, set(), set()
    seconds, nbytes = _METRICS.get()
    t0 = time.perf_counter()
    for fname in sorted({m.file_name for name in state_dict
                         for m in meta.state_dict_metadata[name]}):
        _open_shard_file(path, fname, files_cache, meta.file_checksums,
                         files_crc_ok)
        nbytes.inc(os.path.getsize(os.path.join(path, fname)), op="load")
    t1 = time.perf_counter()
    seconds.inc(t1 - t0, part="file_crc")
    for name, value in state_dict.items():
        entries = meta.state_dict_metadata[name]
        gshape = tuple(meta.global_shapes[name])
        for t, region in _targets(value):
            if region is None:
                region = tuple((0, s) for s in gshape)
                if tuple(t.shape) != gshape:
                    raise ValueError(
                        f"{name}: the checkpoint holds shape {gshape}, the "
                        f"target {tuple(t.shape)}")
            piece = _assemble(entries, region, files_cache, path,
                              meta.file_checksums, verified, files_crc_ok)
            with torch.no_grad():
                if isinstance(t, torch.Tensor):
                    t.copy_(piece.reshape(t.shape))
                else:
                    state_dict[name] = Tensor(piece.clone())
    seconds.inc(time.perf_counter() - t1, part="read")
    after = getattr(state_dict, "after_load", None)
    if after is not None:
        after()
    return state_dict
