"""The hybrid topology (↔ paddle_tpu/distributed/fleet/base/topology.py):
`CommunicateTopology`, the rank grid over [data, pipe, sharding, sep,
model], and `HybridCommunicateGroup`, this rank's groups along each of its
dims, cut from the mesh that `env.build_mesh` makes of the same dims."""

from __future__ import annotations

import itertools

import numpy as np

from ... import collective as coll
from ... import env as _env

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = itertools.product(*[range(d) for d in dims])
        self._world = int(np.prod(dims))
        self._coord_to_rank = {}
        self._rank_to_coord = {}
        for rank, coord in enumerate(itertools.product(*[range(d) for d in dims])):
            self._coord_to_rank[coord] = rank
            self._rank_to_coord[rank] = coord

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        return self._coord_to_rank[tuple(kwargs[n] for n in self._parallel_names)]

    def get_coord(self, rank):
        return self._rank_to_coord[rank]

    def get_axis_list(self, axis_name, index):
        """Every rank whose coordinate on axis_name is index."""
        ax = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._rank_to_coord.items() if c[ax] == index)

    def get_comm_list(self, axis_name):
        """The rank groups along axis_name, one per setting of the others."""
        ax = self._parallel_names.index(axis_name)
        others = [range(d) for i, d in enumerate(self._dims) if i != ax]
        groups = []
        for combo in itertools.product(*others):
            ranks = []
            for v in range(self._dims[ax]):
                coord = list(combo)
                coord.insert(ax, v)
                ranks.append(self._coord_to_rank[tuple(coord)])
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self._rank_to_coord[global_rank])
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self._coord_to_rank[tuple(coord)]


_NAME_TO_AXIS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                 "sep": "sep", "model": "mp"}


class HybridCommunicateGroup:
    """This rank's groups of a topology (reference :189); it builds the
    global mesh of the topology's dims, so every rank constructs it."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = _env.get_rank()
        self.nranks = topology.world_size()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep")
        self._mp_degree = topology.get_dim("model")
        self.mesh = _env.build_mesh(
            dp=self._dp_degree, pp=self._pp_degree,
            sharding=self._sharding_degree, sep=self._sep_degree,
            mp=self._mp_degree)
        coord = topology.get_coord(self.global_rank)
        self._coord = dict(zip(topology.get_hybrid_group_names(), coord))
        self._groups = {
            name: coll.Group(_env.mesh_group(self.mesh, _NAME_TO_AXIS[name]),
                             axis_names=(_NAME_TO_AXIS[name],))
            for name in topology.get_hybrid_group_names()}
        self._dp_sharding_group = coll.Group(
            _env.mesh_group(self.mesh, ("dp", "sharding")),
            axis_names=("dp", "sharding"))
        self._dp_sep_group = coll.Group(
            _env.mesh_group(self.mesh, ("dp", "sep")), axis_names=("dp", "sep"))

    def get_parallel_mode(self):
        if (self._mp_degree == 1 and self._pp_degree == 1
                and self._sharding_degree == 1 and self._sep_degree == 1):
            return "data_parallel" if self._dp_degree > 1 else "single"
        if self._pp_degree > 1:
            return "pipeline_parallel"
        if self._sharding_degree > 1 and self._mp_degree == 1:
            return "sharding_parallel"
        if self._sep_degree > 1 and self._mp_degree == 1:
            return "segment_parallel"
        return "tensor_parallel"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._groups["data"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._groups["model"]

    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    def get_stage_id(self):
        return self._coord["pipe"]

    get_pipe_parallel_rank = get_stage_id

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._groups["pipe"]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    def get_sep_parallel_rank(self):
        return self._coord["sep"]

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    def get_dp_sharding_parallel_group(self):
        return self._dp_sharding_group

    def get_dp_sep_parallel_group(self):
        return self._dp_sep_group

    def get_pipe_parallel_peers(self):
        return self._groups["pipe"].ranks
