"""Tensor-parallel layers (↔ paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py:64-165).

The reference annotates full weights with PartitionSpecs and lets GSPMD
place the collectives. Here each process is one rank, so a layer holds its
shard and calls the collectives of `distributed.collective` itself:

- `VocabParallelEmbedding`: rows [r * V/n, (r + 1) * V/n) of the table;
  ids outside the range look up row 0 and are zeroed, then the output is
  all-reduced (`mp_allreduce`).
- `ColumnParallelLinear`: the output features' shard of the weight and of
  the bias; the input goes through `c_identity` (its gradient all-reduced),
  and with `gather_output` the output is all-gathered (`c_concat`).
- `RowParallelLinear`: the input features' shard of the weight; an input
  that is not parallel yet is cut (`c_split`); the partial products are
  all-reduced and the bias, whole on every rank, is added once after.
- `ParallelCrossEntropy`: per-token cross entropy over vocab-sharded
  logits, an autograd Function: the row max and the sum of exp and the
  target logit (from the rank whose range holds it) are all-reduced; the
  backward is softmax minus one-hot on the local shard. `ignore_index`
  rows give 0.

The constructors take the reference's positional parameters (`weight_attr`
third, a `ParamAttr` applied by `Layer.create_parameter`); the port's own
(`weight_std`, `generator`, `device`, `dtype`) are keyword-only. As in the
reference, a bias takes no attribute and the vocab embedding's default
initializer is Xavier-normal (:74). Every layer is built at full size from the model's generator, so a seed
gives the single-device weights, and stays a single-device layer (the full
weight, no collective: serving and the one-device step run it so) until
`shard_model(model, group)` cuts it: `DistributedTrainStep` and fleet's
`TensorParallel` call that for a mesh's mp group. From then on the layer
calls its collectives over the group whatever its size, so a one-rank mp
group runs the code that a larger one does. A cut parameter is marked
`is_distributed = True` with `split_axis`, the dim it is cut on (which
`_HybridParallelClipGrad` and the step's clip read), and `dist_attr`
names the mp axis on that dim as the reference's PartitionSpecs do.
`ParallelCrossEntropy` without an `mp_group` takes the global mesh's mp
group (plain cross entropy when there is no mesh), as the reference reads
the global mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..... import amp
from .....nn import functional as F
from .....nn import initializer as I
from .....nn.layer.common import Embedding, Linear
from .... import collective as C
from .... import env as _env
from .....nn.layer.layers import Layer

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "is_distributed",
           "mark_as_sequence_parallel", "shard_model"]


def _pg(group):
    """A torch ProcessGroup from a `collective.Group` or a ProcessGroup."""
    return getattr(group, "process_group", group)


def _cut(p, dim, rank, n):
    """Cut parameter `p` in place to rank's part of n along dim."""
    size = p.shape[dim]
    if size % n:
        raise ValueError(f"a parameter of shape {tuple(p.shape)} does not "
                         f"cut over {n} model-parallel ranks along dim {dim}")
    k = size // n
    with torch.no_grad():
        p.data = p.data.narrow(dim, rank * k, k).contiguous()
    p.is_distributed = True
    p.split_axis = dim
    p.mp_part = (dim, rank, n)


def is_distributed(p):
    """Whether p is cut over mp: its `is_distributed` flag is set (a torch
    tensor has a method of that name, so only a set True counts)."""
    return getattr(p, "is_distributed", False) is True


def shard_model(model, group):
    """Cut every tensor-parallel layer of `model` (and each module that
    defines `_mp_check` / `_mp_shard`, e.g. the GPT attention's head
    counts) to this rank's part over `group`, in place. Every module is
    checked before any is cut. A model cut once keeps its cut; another
    group raises."""
    pg = _pg(group)
    done = getattr(model, "_mp_group", None)
    if done is not None:
        if done is not pg:
            raise RuntimeError("the model is cut over another "
                               "model-parallel group already")
        return model
    n, rank = dist.get_world_size(pg), dist.get_rank(pg)
    mods = [m for m in model.modules() if hasattr(m, "_mp_shard")]
    for m in mods:
        if hasattr(m, "_mp_check"):
            m._mp_check(n)
    for m in mods:
        m._mp_shard(pg, rank, n)
    model._mp_group = pg
    return model


class VocabParallelEmbedding(Embedding):
    """Embedding whose vocabulary rows are cut over mp (reference :64;
    Xavier-normal default init, as the JAX package's)."""

    mp_group = None
    _default_init = I.XavierNormal()

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, weight_std=None, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__(num_embeddings, embedding_dim,
                         weight_attr=weight_attr, weight_std=weight_std,
                         generator=generator, device=device, dtype=dtype)
        self.weight.dist_attr = ("mp", None)

    def _mp_shard(self, pg, rank, n):
        _cut(self.weight, 0, rank, n)
        self.mp_group = pg
        self._vocab_start = rank * self.weight.shape[0]

    def forward(self, x):
        if self.mp_group is None:
            return super().forward(x)
        rows = self.weight.shape[0]
        ids = x.long() - self._vocab_start
        outside = (ids < 0) | (ids >= rows)
        out = F.embedding(ids.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0)
        return C.mp_allreduce(out, self.mp_group)


class ColumnParallelLinear(Linear):
    """Linear whose output features (weight columns and bias) are cut over
    mp (reference :84)."""

    mp_group = None

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, weight_std=None, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__(in_features, out_features, weight_attr,
                         bias_attr=None if has_bias else False,
                         weight_std=weight_std, generator=generator,
                         device=device, dtype=dtype)
        self.gather_output = gather_output
        self.weight.dist_attr = (None, "mp")
        if self.bias is not None:
            self.bias.dist_attr = ("mp",)

    def _mp_shard(self, pg, rank, n):
        _cut(self.weight, 1, rank, n)
        if self.bias is not None:
            _cut(self.bias, 0, rank, n)
        self.mp_group = pg

    def _mp_input(self, x):
        return C.c_identity(x, self.mp_group)

    def forward(self, x):
        if self.mp_group is None:
            return super().forward(x)
        out = F.linear(self._mp_input(x), self.weight, self.bias)
        if self.gather_output:
            out = C.c_concat(out, self.mp_group, -1)
        return out


class RowParallelLinear(Linear):
    """Linear whose input features (weight rows) are cut over mp; the bias
    is whole on every rank and added after the reduction (reference :116)."""

    mp_group = None

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 weight_std=None, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, weight_attr,
                         bias_attr=None if has_bias else False,
                         weight_std=weight_std, generator=generator,
                         device=device, dtype=dtype)
        self.input_is_parallel = input_is_parallel
        self.weight.dist_attr = ("mp", None)

    def _mp_shard(self, pg, rank, n):
        _cut(self.weight, 0, rank, n)
        self.mp_group = pg

    def _mp_output(self, out):
        return C.mp_allreduce(out, self.mp_group)

    def forward(self, x):
        if self.mp_group is None:
            return super().forward(x)
        if not self.input_is_parallel:
            x = C.c_split(x, self.mp_group, -1)
        out = self._mp_output(F.linear(x, self.weight))
        if self.bias is None:
            return out
        (b,) = amp.cast_inputs("linear", self.bias)
        return out + b


def _f32_copy(t):
    """A float32 copy of t that may be written in place."""
    return t.float() if t.dtype != torch.float32 else t.clone()


class _ParallelCE(torch.autograd.Function):
    """loss = log(sum over every shard of exp(l - max)) - (l[id] - max) in
    f32, with the max, the sums and the target logit all-reduced over pg;
    the backward recomputes the local softmax from (logits, max, sum). Each
    direction holds one f32 copy of the local logits, worked in place."""

    @staticmethod
    def forward(ctx, logits, ids, valid, pg):
        e = _f32_copy(logits)
        rows = e.shape[-1]
        m = e.amax(-1)
        C._all_reduce(m, pg, op=dist.ReduceOp.MAX)
        local = ids - dist.get_rank(pg) * rows
        mine = (local >= 0) & (local < rows) & valid
        local = local.clamp(0, rows - 1)
        e.sub_(m[..., None])
        tgt = e.gather(-1, local[..., None])[..., 0]
        sums = torch.stack([e.exp_().sum(-1),
                            torch.where(mine, tgt, torch.zeros_like(tgt))])
        del e
        C._all_reduce(sums, pg)
        ctx.save_for_backward(logits, local, mine, valid, m, sums[0])
        return torch.where(valid, sums[0].log() - sums[1],
                           torch.zeros_like(tgt))

    @staticmethod
    def backward(ctx, g):
        logits, local, mine, valid, m, total = ctx.saved_tensors
        d = _f32_copy(logits).sub_(m[..., None]).exp_().div_(total[..., None])
        d.scatter_add_(-1, local[..., None], -mine.float()[..., None])
        d.mul_(torch.where(valid, g, torch.zeros_like(g))[..., None])
        return d.to(logits.dtype), None, None, None


def _mesh_mp_group():
    mesh = _env.get_global_mesh()
    return None if mesh is None else _env.mesh_group(mesh, "mp")


class ParallelCrossEntropy(Layer):
    """Per-token cross entropy (reduction "none") over logits whose
    vocabulary is cut over mp (reference :143); rows labelled
    `ignore_index` give 0. Over `mp_group`, else the global mesh's mp
    group; with neither (no mesh) the plain cross entropy over whole
    logits."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = mp_group
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        pg = _pg(self.mp_group) if self.mp_group is not None else _mesh_mp_group()
        if pg is None:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        (logits,) = amp.cast_inputs("cross_entropy", input)
        ids = label.long()
        if ids.dim() == logits.dim() and ids.shape[-1] == 1:
            ids = ids[..., 0]
        return _ParallelCE.apply(logits, ids, ids != self.ignore_index, pg)


def mark_as_sequence_parallel(x, group=None):
    """The reference's constraint of an activation [B, S, H] to its
    sequence shard over mp: this rank's rows of the sequence, all-gathered
    in the backward (sequence_parallel_utils.ScatterOp)."""
    pg = _pg(group) if group is not None else _mesh_mp_group()
    return C.c_split(x, pg, 1)
