"""Sequence parallelism (↔ paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py).

Between the tensor-parallel regions of a block the activations [B, S, H]
are cut along the sequence (dim 1) over the mp group: the norms and the
residual adds run on this rank's S / mp rows. The reference places the
cuts as sharding constraints; here they are the collectives of
`distributed.collective` over the mp group (the `group` given, else the
global mesh's):

- `ScatterOp`: this rank's rows forward, all-gather backward;
- `GatherOp`: all-gather forward, this rank's rows backward;
- `AllGatherOp`: all-gather forward, reduce-scatter backward (the input of
  a column-parallel layer: the ranks' partial input gradients are summed
  and cut in one collective);
- `ReduceScatterOp`: reduce-scatter forward, all-gather backward (the
  output of a row-parallel layer, in place of its all-reduce);
- `ColumnSequenceParallelLinear` / `RowSequenceParallelLinear`: the
  column- and row-parallel layers with those at their ends.

A parameter used on the sequence rows (a norm's weight and bias, a
row-parallel bias) gets a different gradient on every mp rank, each from
its own rows. The reference leaves the sum to GSPMD
(`register_sequence_parallel_allreduce_hooks` is a no-op there, :105-110).
Here `DistributedTrainStep` all-reduces the gradients of parameters marked
by `mark_as_sequence_parallel_parameter` over mp before its own reduction,
and `register_sequence_parallel_allreduce_hooks` does the same for an
eager loop (a hook after accumulation; it leaves the gradient to a step
that is reducing it).
"""

from __future__ import annotations

from ... import collective as C
from ..layers.mpu.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                    _mesh_mp_group, _pg)

__all__ = ["AllGatherOp", "ColumnSequenceParallelLinear", "GatherOp",
           "ReduceScatterOp", "RowSequenceParallelLinear", "ScatterOp",
           "identity_in_mp", "is_sequence_parallel_parameter",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks"]


def _group(group):
    return _pg(group) if group is not None else _mesh_mp_group()


class ScatterOp:
    """This rank's part of dim `axis` forward, all-gather backward."""

    @staticmethod
    def apply(x, axis=1, group=None):
        return C.c_split(x, _group(group), axis)


class GatherOp:
    """All-gather along `axis` forward, this rank's part backward."""

    @staticmethod
    def apply(x, axis=1, group=None):
        return C.c_concat(x, _group(group), axis)


class AllGatherOp:
    """All-gather along the sequence forward, reduce-scatter backward."""

    @staticmethod
    def apply(x, group=None):
        return C.all_gather_seq(x, _group(group), 1)


class ReduceScatterOp:
    """Reduce-scatter along the sequence forward, all-gather backward."""

    @staticmethod
    def apply(x, group=None):
        return C.reduce_scatter_seq(x, _group(group), 1)


def identity_in_mp(x, group=None):
    """Identity forward, the gradient all-reduced over mp backward
    (`collective.c_identity`)."""
    return C.c_identity(x, _group(group))


def mark_as_sequence_parallel_parameter(param):
    param.sequence_parallel = True


def is_sequence_parallel_parameter(param):
    return getattr(param, "sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse=False):
    """Sum the gradient of every sequence-parallel parameter of `model`
    over the mp group once the backward has accumulated it (reference
    :192); returns the hook handles. A `DistributedTrainStep` on the model
    sums them itself, so the hooks leave them alone while it reduces."""

    def hook(p):
        step = getattr(model, "_distributed_step", None)
        if p.grad is None or (step is not None and step._reducing):
            return
        pg = getattr(model, "_mp_group", None) or _mesh_mp_group()
        C._all_reduce(p.grad, pg)

    return [p.register_post_accumulate_grad_hook(hook)
            for p in model.parameters() if is_sequence_parallel_parameter(p)]


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel layer whose input is the sequence shard: it is
    all-gathered first (reference :113). `gather_output` must be False."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.gather_output:
            raise ValueError("ColumnSequenceParallelLinear keeps its output "
                             "parallel: gather_output=False")

    def _mp_input(self, x):
        return C.all_gather_seq(x, self.mp_group, 1)


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel layer whose output is reduce-scattered to the
    sequence shard, its bias (a sequence-parallel parameter) added after
    (reference :126). `input_is_parallel` must be True."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if not self.input_is_parallel:
            raise ValueError("RowSequenceParallelLinear takes the parallel "
                             "output of a column-parallel layer: "
                             "input_is_parallel=True")
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def _mp_output(self, out):
        return C.reduce_scatter_seq(out, self.mp_group, 1)

