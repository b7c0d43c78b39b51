"""paddle_tpu_torch.distributed (↔ paddle_tpu/distributed/__init__.py):
the process group and mesh (`env`), Paddle's collectives on
`torch.distributed` (`collective`, with the autograd functions of the
model-parallel region), the fleet facade with the tensor- and
sequence-parallel layers, `DataParallel`, the group-sharded API and
`DistributedTrainStep` (data, tensor, sequence, pipeline, segment and
expert parallelism and ZeRO stages 1-3 with offload; the pipeline schedules
and ring attention are in `paddle_tpu_torch.parallel`), the MoE exchanges
`utils.global_scatter` / `global_gather` and the all-to-all record
`moe_comm`, the comm watchdog (`comm_watchdog`), the crash-test fault
points (`faults`) and the sharded checkpoint (`checkpoint`). One process
per rank: `spawn` starts `nprocs` of them."""

from . import (checkpoint, collective, comm_watchdog, env, faults, fleet,
               moe_comm, parallel, sharding, utils)
from .collective import (P2POp, ReduceOp, all_gather, all_gather_object,
                         all_reduce, alltoall, alltoall_single, barrier,
                         batch_isend_irecv, broadcast, broadcast_object_list,
                         destroy_process_group, get_group, irecv, isend,
                         new_group, recv, reduce, reduce_scatter, scatter,
                         scatter_object_list, send, wait)
from .env import (ParallelEnv, build_mesh, get_rank, get_world_size,
                  init_parallel_env, is_initialized)
from .parallel import (DataParallel, group_sharded_parallel,
                       save_group_sharded_model)
from .train_step import DistributedTrainStep, full_state_dict

__all__ = [
    "DataParallel", "DistributedTrainStep", "P2POp", "ParallelEnv",
    "ReduceOp", "all_gather", "all_gather_object", "all_reduce", "alltoall",
    "alltoall_single", "barrier", "batch_isend_irecv", "broadcast",
    "broadcast_object_list", "build_mesh", "checkpoint", "collective",
    "comm_watchdog",
    "destroy_process_group", "env", "faults", "fleet", "full_state_dict",
    "get_group",
    "get_rank", "get_world_size", "group_sharded_parallel",
    "init_parallel_env", "irecv", "is_initialized", "isend", "moe_comm",
    "new_group", "parallel", "recv", "reduce", "reduce_scatter",
    "save_group_sharded_model", "scatter", "scatter_object_list", "send",
    "sharding", "spawn", "utils", "wait",
]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(index, func, args, nprocs, port):
    import os

    os.environ.update(RANK=str(index), LOCAL_RANK=str(index),
                      WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """paddle.distributed.spawn: start `nprocs` processes (-1: one per CUDA
    device), each running `func(*args)` with RANK, LOCAL_RANK, WORLD_SIZE
    and a localhost MASTER_ADDR/MASTER_PORT set for `init_parallel_env`.
    The reference runs `func` once, its one controller playing every rank."""
    import torch
    import torch.multiprocessing as mp

    if nprocs == -1:
        nprocs = max(1, torch.cuda.device_count())
    return mp.spawn(_spawned, args=(func, tuple(args), nprocs, _free_port()),
                    nprocs=nprocs, join=join, daemon=daemon)
