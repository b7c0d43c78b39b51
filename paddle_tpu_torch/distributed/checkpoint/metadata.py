"""Checkpoint metadata: the map from global tensors to on-disk shards
(↔ paddle_tpu/distributed/checkpoint/metadata.py, the same format).

Reference: python/paddle/distributed/checkpoint/metadata.py — Metadata holds
{state_name: [LocalTensorMetadata]} where each local shard records its global
offset + local shape + the file that stores it.

Crash-safety additions: every shard records a crc32 of its array bytes and
the metadata records a crc32 of every shard FILE, so a torn or bit-flipped
write is detected at load/discovery time instead of being deserialized into
the model silently.

`LocalShard` is the port's counterpart of a jax.Array's addressable shard:
a tensor this rank holds, placed at `global_offset` in a global tensor of
`global_shape`, which this rank writes (`write`) or leaves to the one rank
that owns its replicas. A state dict entry is a tensor (whole, the same on
every rank), a `LocalShard`, or a list of them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib

# the presence of this file inside a checkpoint directory marks the save as
# fully committed; saves that died mid-write never produce it
COMMIT_FILE = "COMMIT"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed checksum/structure validation. The message
    always names the offending file so the operator can see WHICH shard of
    WHICH step is bad."""


def crc32_of(data) -> str:
    """crc32 of any contiguous bytes-like object (bytes, or a C-contiguous
    numpy array via the buffer protocol — no .tobytes() copy needed)."""
    return "crc32:%08x" % (zlib.crc32(data) & 0xFFFFFFFF)


def crc32_file(path: str, chunk_size: int = 1 << 20) -> str:
    """Streamed file crc32 — verification must not require holding a
    multi-GB shard file in memory."""
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            crc = zlib.crc32(chunk, crc)
    return "crc32:%08x" % (crc & 0xFFFFFFFF)


@dataclasses.dataclass
class LocalTensorMetadata:
    global_offset: tuple  # start index of this shard in the global tensor
    local_shape: tuple
    dtype: str
    file_name: str
    key: str  # key inside the shard file
    checksum: str = ""  # crc32 of the shard's array bytes ("" = legacy save)


@dataclasses.dataclass
class LocalShard:
    tensor: object          # the held part (a torch tensor, a view of the live one)
    global_offset: tuple
    global_shape: tuple
    write: bool = True      # False: a replica another rank writes


@dataclasses.dataclass
class LocalTensorIndex:
    tensor_key: str
    global_offset: tuple


@dataclasses.dataclass
class Metadata:
    state_dict_metadata: dict  # name -> [LocalTensorMetadata]
    global_shapes: dict        # name -> tuple
    flat_mapping: dict = dataclasses.field(default_factory=dict)
    file_checksums: dict = dataclasses.field(default_factory=dict)  # fname -> crc32

    def save(self, path):
        payload = {
            "state_dict_metadata": {
                k: [dataclasses.asdict(m) for m in v]
                for k, v in self.state_dict_metadata.items()
            },
            "global_shapes": {k: list(v) for k, v in self.global_shapes.items()},
            "flat_mapping": self.flat_mapping,
            "file_checksums": self.file_checksums,
        }
        # fsync: the commit marker is only meaningful if the metadata it
        # covers has actually reached the disk first
        with open(path, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())

    @classmethod
    def load(cls, path):
        with open(path) as f:
            payload = json.load(f)
        return cls(
            state_dict_metadata={
                k: [LocalTensorMetadata(
                    tuple(m["global_offset"]), tuple(m["local_shape"]),
                    m["dtype"], m["file_name"], m["key"],
                    m.get("checksum", ""))
                    for m in v]
                for k, v in payload["state_dict_metadata"].items()
            },
            global_shapes={k: tuple(v) for k, v in payload["global_shapes"].items()},
            flat_mapping=payload.get("flat_mapping", {}),
            file_checksums=payload.get("file_checksums", {}),
        )


def metadata_path(dirname):
    return os.path.join(dirname, "0.metadata")
