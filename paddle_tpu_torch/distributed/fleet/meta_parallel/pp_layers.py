"""Pipeline layer descriptions and their partition over the stages
(↔ paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py; reference
pp_layers.py: LayerDesc :57, SharedLayerDesc :77, PipelineLayer :258).

`PipelineLayer(layers, num_stages, loss_fn=...)` cuts its list of entries
(`LayerDesc`, `SharedLayerDesc`, built modules or callables) into
`num_stages` contiguous stages by the reference's uniform partition
(`_partition`, :111-118). The reference's one controller builds every
stage; here each rank builds and runs only its own stage's entries: the
rank's stage is its coordinate on the global mesh's pp axis (`fleet.init`
builds that mesh from its topology). Without a mesh every entry is built
and `forward` runs them all in turn.

A `SharedLayerDesc` key names one layer that several stages use (a tied
embedding). Every rank builds each shared layer, and its parameters are
broadcast from the first stage that declares it, which owns it: its
parameters' `is_firstly_shared` is True on that stage only, so that the
global-norm clip counts them once (:76-109). `PipelineParallel` sums their
gradients over the pp group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ... import collective as C
from ... import env as _env
from ....nn.layer.container import LayerList
from ....nn.layer.layers import Layer

__all__ = ["LayerDesc", "PipelineLayer", "SharedLayerDesc"]


class LayerDesc:
    """A layer to build on the stage that runs it:
    `layer_func(*inputs, **kwargs)`."""

    def __init__(self, layer_func, *inputs, **kwargs):
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("LayerDesc expects an nn.Module subclass")
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared by every entry of the same `key`; `forward_func(layer,
    x)` runs it where given."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _pp_place():
    """(this rank's stage, the pp group) on the global mesh (which
    `fleet.init` builds from its topology); (None, None) without one."""
    mesh = _env.get_global_mesh()
    if mesh is None:
        return None, None
    pg = _env.mesh_group(mesh, "pp")
    return dist.get_rank(pg), pg


class PipelineLayer(Layer):
    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._num_stages = num_stages or (topology.get_dim("pipe")
                                          if topology else 1)
        self._seg_method = seg_method
        self.descs = list(layers)
        self.segment_parts = self._partition(len(self.descs),
                                             self._num_stages)
        self._stage, self._pp_group = _pp_place()
        if self._pp_group is not None and \
                dist.get_world_size(self._pp_group) != self._num_stages:
            raise ValueError(f"{self._num_stages} stages over a pp group of "
                             f"{dist.get_world_size(self._pp_group)} ranks")
        self.shared_layers = nn.ModuleDict()
        self.run_funcs = []     # (entry index, layer or callable, forward_func)
        for i, d in enumerate(self.descs):
            mine = self._stage is None or self._stage_of(i) == self._stage
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self.shared_layers:
                    self.shared_layers[d.layer_name] = d.build_layer()
                if mine:
                    self.run_funcs.append(
                        (i, self.shared_layers[d.layer_name], d.forward_func))
            elif isinstance(d, LayerDesc):
                if mine:
                    self.run_funcs.append((i, d.build_layer(), None))
            elif isinstance(d, nn.Module) or callable(d):
                if mine:
                    self.run_funcs.append((i, d, None))
            else:
                raise TypeError(f"unsupported pipeline entry {d!r}")
        shared = {id(m) for m in self.shared_layers.values()}
        self._layer_list = LayerList(
            [f for _, f, _ in self.run_funcs
             if isinstance(f, nn.Module) and id(f) not in shared])
        self._share()

    def _stage_of(self, i):
        parts = self.segment_parts
        return next(s for s in range(self._num_stages)
                    if parts[s] <= i < parts[s + 1])

    def _share(self):
        """Mark each shared layer's owner (the first stage that declares
        it) and give every stage the owner's parameters."""
        owner = {}
        for i, d in enumerate(self.descs):
            if isinstance(d, SharedLayerDesc):
                owner.setdefault(d.layer_name, self._stage_of(i))
        for key, layer in self.shared_layers.items():
            for p in layer.parameters():
                p.is_firstly_shared = (self._stage is None
                                       or owner[key] == self._stage)
                if self._pp_group is not None:
                    src = dist.get_process_group_ranks(self._pp_group)[
                        owner[key]]
                    C.record_collective_traffic(
                        "broadcast", p.numel() * p.element_size())
                    with torch.no_grad():
                        dist.broadcast(p.data, src, group=self._pp_group)

    @staticmethod
    def _partition(n_layers, n_stages):
        """Uniform partition boundaries (reference seg_method='uniform')."""
        base, extra = divmod(n_layers, n_stages)
        parts = [0]
        for s in range(n_stages):
            parts.append(parts[-1] + base + (1 if s < extra else 0))
        return parts

    def get_num_stages(self):
        return self._num_stages

    def get_stage_layers(self, stage):
        """The (layer, forward_func) entries of `stage` that this rank
        built: its own stage's, or any stage's without a pp group."""
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return [(f, fwd) for i, f, fwd in self.run_funcs if lo <= i < hi]

    def forward(self, x):
        """This rank's stage (every stage without a pp group) on x."""
        for _, fn, fwd in self.run_funcs:
            x = fwd(fn, x) if fwd is not None else fn(x)
        return x
