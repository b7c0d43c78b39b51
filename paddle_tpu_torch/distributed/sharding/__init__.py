"""paddle.distributed.sharding (↔ paddle_tpu/distributed/sharding/__init__.py)."""

from ..parallel import group_sharded_parallel, save_group_sharded_model  # noqa: F401
