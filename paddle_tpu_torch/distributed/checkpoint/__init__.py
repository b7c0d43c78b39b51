"""paddle_tpu_torch.distributed.checkpoint (↔
paddle_tpu/distributed/checkpoint): the sharded, crash-safe checkpoint.
Each rank writes the shards it holds, rank 0 the metadata, and a COMMIT
marker plus an atomic rename make a save visible only once it is whole;
`CheckpointManager` adds step directories, rotation, async saves and
`restore_latest` with rollback. The format is the reference's."""

from .metadata import (  # noqa: F401
    COMMIT_FILE,
    CheckpointCorruptError,
    LocalShard,
    LocalTensorIndex,
    LocalTensorMetadata,
    Metadata,
)
from .load_state_dict import load_state_dict  # noqa: F401
from .save_state_dict import save_state_dict  # noqa: F401
from .manager import (  # noqa: F401
    CheckpointInfo,
    CheckpointManager,
    checkpoint_steps,
    latest_checkpoint,
    validate_checkpoint,
    wait_async_save,
)

__all__ = ["save_state_dict", "load_state_dict", "Metadata",
           "LocalTensorMetadata", "LocalTensorIndex", "LocalShard",
           "CheckpointCorruptError", "COMMIT_FILE", "CheckpointInfo",
           "CheckpointManager", "checkpoint_steps", "latest_checkpoint",
           "validate_checkpoint", "wait_async_save"]
