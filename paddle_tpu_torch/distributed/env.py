"""The process group and the hybrid mesh (↔ paddle_tpu/distributed/env.py).

The JAX package runs one controller over every device and lets XLA place
the collectives. The port follows PyTorch instead: one process per rank,
a default process group from `init_parallel_env`, and a
`torch.distributed.device_mesh.DeviceMesh` whose named dims are the
reference's hybrid axes in its order, [dp, pp, sharding, sep, ep, mp]
(`AXIS_ORDER`, env.py:21). Trailing dims change fastest over the ranks, so
mp lands on neighbouring ranks, as `build_mesh` (:128-137) places it.

`init_parallel_env` takes its rendezvous from RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT, from PADDLE_MASTER ("host:port", with
PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM) as `tests/test_multiproc.py` sets
it, or from an explicit `init_method` (a `file://` store, as the CPU tests
use). The backend is NCCL when the rank's device is `cuda` (the default)
and gloo when the caller asks for the CPU. A rank on `cuda` binds
`cuda:{local_rank}`.

`build_mesh` also builds the groups over two dims that the step and the
topology read: (dp, sharding), the batch axes, and (dp, sep). Every rank
must call it, in the same order, as it must every `new_group`. The mp
group of a mesh is `mesh_group(mesh, "mp")`; the group over any other set
of dims (the step's token axes, e.g. (dp, sharding, sep) or (dp, ep)) is
made on first use by `mesh_group(mesh, axes)`, which every rank must then
call at the same point, as the step's constructor does.

`PartitionSpec` stands for the reference's `jax.sharding.PartitionSpec`
in `DistributedTrainStep`'s `input_specs` / `label_specs`: a tuple with
one entry per leading dim, None or an axis name or a tuple of axis names.
"""

from __future__ import annotations

import itertools
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["AXIS_ORDER", "ParallelEnv", "PartitionSpec", "build_mesh",
           "default_mesh",
           "get_global_mesh", "get_rank", "get_world_size",
           "init_parallel_env", "is_initialized", "mesh_group", "mesh_shape",
           "set_global_mesh"]

AXIS_ORDER = ("dp", "pp", "sharding", "sep", "ep", "mp")
# the groups over two dims that build_mesh makes beside the mesh's own
FUSED_AXES = (("dp", "sharding"), ("dp", "sep"))

_device = None           # this rank's torch.device, set by init_parallel_env
_global_mesh = None
_fused: dict = {}        # (id(mesh), axes) -> torch ProcessGroup


class PartitionSpec(tuple):
    """PartitionSpec("dp", None) == ("dp", None): how an input is cut over
    the mesh's axes, dim by dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rendezvous():
    """(init_method, rank, world_size) from the environment."""
    rank = int(os.environ.get("RANK", os.environ.get("PADDLE_TRAINER_ID", "0")))
    world = int(os.environ.get("WORLD_SIZE",
                               os.environ.get("PADDLE_TRAINERS_NUM", "1")))
    master = os.environ.get("PADDLE_MASTER")
    if master is None and "MASTER_ADDR" in os.environ:
        master = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if master is None:
        raise RuntimeError(
            "init_parallel_env: no rendezvous; set RANK, WORLD_SIZE, "
            "MASTER_ADDR and MASTER_PORT (or PADDLE_MASTER=host:port), or "
            "pass init_method")
    return f"tcp://{master}", rank, world


def init_parallel_env(strategy=None, *, device=None, init_method=None,
                      rank=None, world_size=None, timeout=None):
    """paddle.distributed.init_parallel_env (reference parallel.py:978):
    initialise the default process group once and return a `ParallelEnv`.
    `device` None means `cuda` (NCCL, `cuda:{local_rank}` bound); "cpu"
    means gloo. `init_method`, `rank` and `world_size` override the
    environment's rendezvous; `timeout` is a `datetime.timedelta`."""
    global _device
    if is_initialized():
        return ParallelEnv()
    dev = resolve_device(device)
    if init_method is None:
        init_method, env_rank, env_world = _rendezvous()
    else:
        env_rank = int(os.environ.get("RANK", "0"))
        env_world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = env_rank if rank is None else rank
    world_size = env_world if world_size is None else world_size
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    _device = dev
    return ParallelEnv()


def device() -> torch.device:
    """This rank's device: the one `init_parallel_env` bound, else `cuda`."""
    return _device if _device is not None else resolve_device(None)


def get_rank(group=None) -> int:
    if group is not None:
        return group.rank
    return dist.get_rank() if is_initialized() else 0


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return dist.get_world_size() if is_initialized() else 1


class ParallelEnv:
    """paddle.distributed.ParallelEnv: this rank's place in the world."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def local_rank(self):
        return int(os.environ.get("LOCAL_RANK", get_rank()))

    @property
    def device_id(self):
        if _device is None or _device.type != "cuda":
            return 0
        return _device.index or 0

    dev_id = device_id


def set_global_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh


def get_global_mesh():
    return _global_mesh


def build_mesh(dp=1, pp=1, sharding=1, sep=1, mp=1, ep=1):
    """A DeviceMesh over every rank with dims AXIS_ORDER, sizes (dp, pp,
    sharding, sep, ep, mp); it becomes the global mesh. The product must be
    the world size, and the process group must exist."""
    from torch.distributed.device_mesh import init_device_mesh

    sizes = dict(dp=dp, pp=pp, sharding=sharding, sep=sep, ep=ep, mp=mp)
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    total = int(torch.tensor(shape).prod())
    if not is_initialized():
        raise RuntimeError(
            f"build_mesh of {total} rank(s): no process group; call "
            "paddle_tpu_torch.distributed.init_parallel_env() on every rank "
            "first")
    if total != dist.get_world_size():
        raise ValueError(f"mesh {'x'.join(map(str, shape))} = {total} ranks, "
                         f"the world has {dist.get_world_size()}")
    mesh = init_device_mesh(device().type, shape, mesh_dim_names=AXIS_ORDER)
    for key in [k for k in _fused if k[0] == id(mesh)]:
        del _fused[key]   # a freed mesh's groups, its id reused
    for axes in FUSED_AXES:
        _fused[(id(mesh), axes)] = _fuse(mesh, axes)
    set_global_mesh(mesh)
    return mesh


def _fuse(mesh, axes):
    """This rank's group over the dims `axes` (every rank takes part in
    making every such group)."""
    grid = mesh.mesh
    idx = [AXIS_ORDER.index(a) for a in axes]
    others = [i for i in range(grid.dim()) if i not in idx]
    lists = []
    for coord in itertools.product(*[range(grid.shape[i]) for i in others]):
        sub = grid
        for i, c in sorted(zip(others, coord), reverse=True):
            sub = sub.select(i, c)
        lists.append(sub.reshape(-1).tolist())
    mine, _ = dist.new_subgroups_by_enumeration(lists)
    return mine


def mesh_group(mesh, axes):
    """The torch ProcessGroup of this rank over one dim (a name) or over
    several (a tuple, in AXIS_ORDER: one of FUSED_AXES, or made here on
    first use, a collective call of every rank)."""
    if isinstance(axes, str):
        return mesh.get_group(axes)
    axes = tuple(a for a in AXIS_ORDER if a in axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _fused:
        _fused[key] = _fuse(mesh, axes)
    return _fused[key]


def mesh_shape(mesh=None) -> dict:
    """axis -> size of `mesh` (default: the global mesh) over AXIS_ORDER,
    absent axes reported as 1 (reference :157)."""
    m = mesh if mesh is not None else get_global_mesh()
    if m is None:
        return {a: 1 for a in AXIS_ORDER}
    names = m.mesh_dim_names or ()
    return {a: int(m.mesh.shape[names.index(a)]) if a in names else 1
            for a in AXIS_ORDER}


def default_mesh():
    """The global mesh, else pure dp over every rank (reference :167)."""
    m = get_global_mesh()
    if m is None:
        m = build_mesh(dp=get_world_size())
    return m
