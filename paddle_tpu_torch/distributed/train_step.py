"""`DistributedTrainStep`: the data-parallel and ZeRO training step over a
mesh (↔ paddle_tpu/distributed/train_step.py:116).

The reference is one XLA program over global arrays, its collectives
placed by `NamedSharding` specs. Here each process is one rank of a
`DeviceMesh` (`env.build_mesh`), and the step runs `jit.TrainStep`'s
forward, backward and update on this rank's tensors with explicit
collectives (`collective._all_gather_flat`, `_reduce_scatter_flat`,
`_all_reduce`, all counted in the registry's `collective_calls_total` /
`collective_bytes_total` and each run under a `comm_watchdog.comm_task`
named by its op and group). It does not
wrap the model in DDP or FSDP: the port's kernels are autograd Functions
that must see plain tensors, and the shards follow the reference's
`fsdp_spec`, so that shards and state line up name for name.

- **Batch.** Each input is split along its first dim over the batch ranks
  (`_batch_spec` :328-335): the ranks of `batch_axes`, any of dp,
  sharding and ep (the first the slowest, as a PartitionSpec of them
  orders them; dp and sharding must be among them when above 1), and
  replicated over the others; an input that does not divide is taken
  whole by every rank.
  `input_specs` / `label_specs` give, per input, how it is cut instead:
  the reference passes `PartitionSpec`s, which the port cannot import, so
  a spec here is a tuple with one entry per leading dim, each None
  (whole), an axis name or a tuple of axis names (cut over their product,
  the first the slowest), as `env.PartitionSpec` builds it; None or ()
  replicates the input. A cut must divide.
- **Segment parallelism.** For a model whose config has `context_parallel`
  the step also cuts dim 1 (the sequence) of every input of two or more
  dims contiguously over the mesh's sep ranks (where a spec leaves dim 1
  whole), and such an input must divide over both; the model's attention runs the ring over sep
  (`parallel.ring`). Any other model is whole on every sep rank, as the
  reference replicates it over sep. The token axes are the batch axes, and
  sep when the sequence is cut: the ranks whose tokens differ.
- **Loss.** The step's loss and gradients are those of `loss_fn` over the
  global batch, as the reference's (one `loss_fn` over the global arrays,
  `jit/__init__.py:322`). Each batch rank r runs `loss_fn` on its rows,
  giving loss_r, while `nn.functional.loss.record_reductions` collects how
  the port's reducing losses reduced (`cross_entropy`,
  `GPTPretrainingCriterion`): a mean over c_r terms, or a sum. With C the
  sum of c_r over the token ranks (an all-reduce) and n the number of
  token ranks, the step back-propagates loss_r * n * c_r / C for a mean
  and loss_r * n for a sum, and the gradients' reduction divides by n; the
  returned loss is the all-reduce of those weighted losses over n. A loss
  that sums several reductions (`BertPretrainingCriterion`: a masked-LM
  mean over the kept slots plus an NSP mean over the rows) notes each with
  its term, and each term t is weighed so by its own count w_t, one
  all-reduce of the counts a term: the step back-propagates loss_r +
  sum(t * (w_t - 1)), so whatever else the loss adds to the terms (an
  auxiliary loss) keeps weight 1; the terms are taken as added to the
  loss once each. A `loss_fn` that notes no reduction, or several of
  which one lacks its term (two `cross_entropy` calls), or a batch that
  no rank cuts, keeps the equal-count mean (loss_r * 1), which is exact
  for the even splits of the batch rule.
- **Batch norm.** Its batch statistics are those of the global batch, as
  the reference's over its global arrays: the forward runs inside
  `nn.functional.batch_stats_over` the batch ranks' group, so each batch
  norm all-reduces its per-channel count, sum and centred sum of squares
  over it (and the sums of its backward), over one rank too. The running
  statistics (buffers) then move alike on every rank, once a step; they
  are not cut by any stage, and `evaluate` leaves them alone.
- **Tensor and sequence parallelism.** Over the mesh's mp group the model
  is cut in place (`fleet.layers.mpu.shard_model`) before anything else:
  its tensor-parallel layers keep their shards and run their collectives,
  over a group of one too. The gradients of sequence-parallel parameters
  (norms and row-parallel biases under `sequence_parallel`) differ from
  rank to rank: their buckets are all-reduced over mp first. A recomputed
  block runs to its end, so that every rank issues the same collectives.
- **Pipeline parallelism.** A pipelined model (`models.GPTForCausalLMPipe`)
  keeps its stage's layers over the mesh's pp group (its `_pp_shard`); its
  1F1B `forward_loss` route (jit.TrainStep) runs a backward a microbatch,
  so the step reduces the accumulated gradients once, after the last
  (`_finish`), and stage 3's gathered gradients too. The parameters it
  shares over pp (tables, final norm, head) are summed over pp first; its
  stacks are not, and the clip's squared sum adds theirs over pp. A batch
  is cut so that microbatch m of a rank's rows is its part of the global
  microbatch m. Every rank returns the loss (the schedule broadcasts it
  from the last stage). Any other model is whole on every pp rank, which
  computes the whole step, as the reference replicates it over pp.
- **Expert parallelism.** Every `MoELayer` routes over the token ranks
  as one set of tokens, the reference's global routing (its capacity, the
  slots of its tokens and its aux loss; `_token_shard`), and one whose
  `ep_axis` names a token axis runs its experts cut over that axis's
  group (`_ep_shard`: each rank keeps E / n of the stacked experts and the
  tokens go to them and back by all-to-all). A parameter cut over ep has
  its gradient summed over the token axes other than its ep axis; every
  other parameter's over all of them.
- **Layout.** A parameter is cut along the dim `fsdp_spec` picks (the
  largest dim divisible by the `sharding` size, other than the dim of its
  mp or ep cut) into one shard per sharding rank; one with no such dim stays
  whole (:76-77). Unlike the
  reference, a sharding axis of size 1 is cut too (into one shard), so a
  one-rank mesh runs the same gathers and reduce-scatters, over a group of
  one, as a sharded one.
- **Stage 0.** Gradients are averaged over the token group (all-reduce).
- **Stage 1.** As stage 0, and the optimizer state (the f32 master copy
  too) is kept for this rank's shard only; the rank updates its shard and
  all-gathers the parameter.
- **Stage 2.** As stage 1, but a cut parameter's gradient is
  reduce-scattered over the sharding group to its owner shard (and
  all-reduced over the other token axes) (`_update_spec` :176).
- **Stage 3.** Parameters live as shards between steps: `p.data` is the
  shard. Each block of the model (a child of an `nn.ModuleList`, e.g. a
  decoder layer) all-gathers its cut parameters when it is called and
  lets go of them when it returns; the rest of the model is gathered for
  the model's whole forward. A saved-tensor hook hands autograd a token for
  a gathered tensor and gathers it again when the backward needs it; under
  per-layer recompute the block's gather fires again in the recomputed
  forward. A parameter gathered more than once (GPT-3's tied head) sums
  its gradients before they are reduce-scattered into the shard.
- **Buckets.** Gradients go to the collectives in buckets of 25 MB (the
  reference's default), filled in reverse parameter order, one kind of
  collective and one dtype to a bucket (O2 keeps LayerNorm parameters in
  f32). With `comm_overlap` (default on) a bucket's collective starts,
  asynchronously, as soon as its last gradient arrives in the backward
  (post-accumulate-grad hooks; the stage-3 gather's backward); without it
  every bucket starts after the backward. Both wait before the update and
  give the same bits.
- **Offload.** The optimizer states live on the host between steps, in
  pinned memory on `cuda` (`host_memory_kind`). The update streams each
  parameter's state through the device in slices along its first dim: in,
  the rule, and back out, on a side stream when `comm_overlap` is on.
- **Whole-parameter norms.** Lamb's trust ratio and Lars's local rate
  read norms of the whole parameter, as the reference's over its global
  arrays: the rule's squared sums over this rank's piece are all-reduced
  over the groups that hold the parameter's other pieces (sharding for a
  ZeRO shard, mp for a cut parameter, ep for an expert shard, pp for a
  pipelined stack), over a group of one too. Without offload the rule
  hands its sums to the step as it updates (`ctx["sum_norms"]`); under
  offload a first pass sums them over this rank's slices
  (`Optimizer.norm_parts`, streaming the state in and writing nothing
  back) and the rule reads the total (`ctx["sq_norms"]`).
- **Dropout.** A step's forward and backward run inside the rank rule of
  `framework.random` (`rank_scope`): each rank draws from generators
  seeded from the seed and its index over the token axes, with its mp
  coordinate for draws on tensors cut over mp. Outside a step's call the
  rank is (0, 0) again; building a step touches no generator.
- **Clip.** The global-norm clip's squared sum adds this rank's shards'
  sums over the sharding group, an mp-cut parameter's over the mp group
  (as the reference's `meta_optimizers.py:55-75`), an expert shard's over
  its ep group, a pipelined model's stacks' over the pp group, and counts
  a replicated parameter once.

- **Inputs.** The batch goes to the device under
  `comm_task("h2d/inputs")` (the reference's, :374-382).
- **Checkpoint.** `train_state()` (jit.TrainStep's) gives each parameter
  and optimizer state as this rank's shards (`checkpoint.LocalShard`): a
  ZeRO shard, an mp cut, an expert shard or a pipeline stage's rows at its
  offset in the global tensor, never gathered; a replica is written by the
  one rank whose coordinate is 0 on every mesh axis that does not cut it.
  `state_dict()` still gathers the whole parameters.

`mesh=None` with no process group (or a reference mesh of one device) is
`jit.TrainStep` on one device, as before: stages 1 and 2 are the stage-0 step there (over an axis of size 1
the reference's shardings are no-ops), and stage 3 and offload ask for a
mesh. Not ported (NotImplementedError naming ROADMAP queue A item 1f): an
expert axis that is not a token axis, experts of one model over two ep
axes, and expert layers in a model whose sequence is cut over sep.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import weakref

import numpy as np
import torch
import torch.utils.checkpoint
from torch.distributed.device_mesh import DeviceMesh

from ..framework import random
from ..jit import TrainStep
from ..nn.functional.norm import batch_stats_over
from ..parallel import pipeline as _pipeline
from . import collective as C
from . import env as _env
from .checkpoint.metadata import LocalShard
from .comm_watchdog import comm_task
from .fleet.layers.mpu.mp_layers import is_distributed, shard_model

__all__ = ["DistributedTrainStep", "fsdp_spec", "full_state_dict",
           "host_memory_kind", "shard_dim", "shard_params_for_stage3"]

BUCKET_BYTES = 25e6        # the reference's reduce-scatter bucket (25 MB)
OFFLOAD_SLICE = 1 << 23    # elements of a state slice streamed at a time

_BATCH_AXES = ("dp", "sharding", "ep")


def host_memory_kind(mesh):
    """Where offloaded states live: "pinned_host" for a mesh on `cuda`,
    "unpinned_host" on the CPU (where host and device memory coincide, so
    offload keeps the states where they are and runs the same code)."""
    return "pinned_host" if mesh.device_type == "cuda" else "unpinned_host"


def shard_dim(shape, n, exclude=None):
    """The dim `fsdp_spec` cuts over n ranks: the largest dim divisible by
    n (the later one on a tie) other than `exclude`, or None."""
    cands = [(s, i) for i, s in enumerate(shape)
             if i != exclude and s % n == 0 and s >= n]
    return max(cands)[1] if cands else None


def fsdp_spec(shape, axis="sharding", mesh=None, existing=None):
    """reference :54: the spec, a tuple of axis names or None per dim, that
    shards the largest dim divisible by the axis size; None (or
    `existing`) when the axis has size 1 or no dim divides."""
    size = _env.mesh_shape(mesh or _env.get_global_mesh())[axis]
    if size <= 1 or not shape:
        return existing
    base = list(existing) if existing is not None else [None] * len(shape)
    base += [None] * (len(shape) - len(base))
    if axis in base:
        return tuple(base)
    free = [s if base[i] is None else 0 for i, s in enumerate(shape)]
    dim = shard_dim(free, size)
    if dim is None or free[dim] == 0:
        return tuple(base) if existing is not None else None
    base[dim] = axis
    return tuple(base)


def shard_params_for_stage3(model, axis="sharding", mesh=None):
    """Annotate every parameter with its FSDP spec (reference :83)."""
    for _, p in model.named_parameters():
        p.dist_attr = fsdp_spec(tuple(p.shape), axis, mesh,
                                getattr(p, "dist_attr", None))


class _Layout:
    """How one parameter lies over the sharding group: cut along `dim`
    into n shards of `size` (this rank's is `rank`), or whole (dim None);
    an mp-cut parameter is not cut again along its mp dim (`exclude`)."""

    def __init__(self, shape, n, rank, exclude=None):
        self.shape = torch.Size(shape)
        self.dim = shard_dim(self.shape, n, exclude)
        self.n, self.rank = n, rank
        self.size = None if self.dim is None else self.shape[self.dim] // n
        self.shard_shape = None
        if self.dim is not None:
            self.shard_shape = self.shape[:self.dim] + (self.size,) + \
                self.shape[self.dim + 1:]

    def shard(self, full):
        return full.narrow(self.dim, self.rank * self.size, self.size)

    def assemble(self, flat):
        """The full tensor from the n shards gathered rank after rank into
        `flat`."""
        return flat.view(self.n, *self.shard_shape).movedim(
            0, self.dim).reshape(self.shape)

    def split(self, full):
        """[n, shard numel]: row r is rank r's shard of `full`."""
        return full.unflatten(self.dim, (self.n, self.size)).movedim(
            self.dim, 0).reshape(self.n, -1)


class _Bucket:
    """Gradients that go through one collective: "scatter" (reduce-scatter
    over the sharding group to each rank's shard, then all-reduce over the
    other token axes) or "reduce" (all-reduce over the token axes); with
    `ep` (expert shards) not over their ep axis, with `pp` (a pipelined
    model's parameters shared by its stages) summed over pp first, with
    `sp` (sequence-parallel parameters) over mp."""

    def __init__(self, kind, dtype, sp=False, pp=False, ep=None):
        self.kind, self.dtype, self.sp, self.pp = kind, dtype, sp, pp
        self.ep = ep
        self.names, self.offsets, self.total, self.nbytes = [], [], 0, 0
        self.reset()

    def add(self, name, numel, nbytes):
        """`numel`: the elements of the parameter this bucket's collective
        leaves on one rank; `nbytes`: its full gradient's bytes."""
        self.names.append(name)
        self.offsets.append(self.total)
        self.total += numel
        self.nbytes += nbytes

    def reset(self):
        self.buf = self.out = self.work = None
        self.arrived = set()


class _Gather(torch.autograd.Function):
    """A stage-3 parameter's shard -> the full parameter; the backward hands
    the full gradient to the step, which reduce-scatters it into the shard
    (so no gradient flows to the shard through autograd)."""

    @staticmethod
    def forward(ctx, p, step, name):
        ctx.step, ctx.name = step, name
        return step._gather_full(name, p)

    @staticmethod
    def backward(ctx, g):
        ctx.step._gathered_grad(ctx.name, g)
        return None, None, None


class _Token:
    """What autograd keeps of a saved gathered parameter (or a view of one)
    in place of its memory."""

    def __init__(self, name, t):
        self.name = name
        self.view = (t.size(), t.stride(), t.storage_offset())


class DistributedTrainStep(TrainStep):
    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 input_specs=None, label_specs=None, sharding_stage=None,
                 offload=False, batch_axes=("dp", "sharding"),
                 comm_overlap=None, **kw):
        if sharding_stage is None:
            sharding_stage = getattr(optimizer, "_sharding_stage", 0)
        if sharding_stage not in (0, 1, 2, 3):
            raise ValueError(f"sharding_stage must be 0-3, got {sharding_stage}")
        offload = bool(offload or getattr(optimizer, "_sharding_offload", False))
        self._specs = (_check_specs(input_specs), _check_specs(label_specs))
        self._split = False
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            # the reference's meshes are JAX ones: one of a single device is
            # the one-device step here, a larger one needs the process group
            if mesh.size > 1:
                raise RuntimeError(
                    "a mesh of more than one device is a DeviceMesh over the "
                    "ranks: call init_parallel_env() and build_mesh() on "
                    "every rank")
            mesh = None
        elif mesh is None and _env.is_initialized():
            mesh = _env.default_mesh()
        self.mesh = mesh
        self.sharding_stage = sharding_stage
        self.offload = offload
        self.comm_overlap = True if comm_overlap is None else bool(comm_overlap)
        self._side = None   # the offload's copy stream on cuda
        super().__init__(model, loss_fn, optimizer, **kw)
        if mesh is None:
            if sharding_stage == 3 or offload:
                raise RuntimeError(
                    "sharding stage 3 and offload shard over a mesh: call "
                    "init_parallel_env() and build_mesh() on every rank first")
            return
        sizes = _env.mesh_shape(mesh)
        batch_axes = tuple(batch_axes)
        bad = [a for a in batch_axes if a not in _BATCH_AXES]
        if bad:
            raise ValueError(f"batch axes {bad}: the step cuts the batch "
                             f"over {_BATCH_AXES}")
        if any(sizes[a] > 1 and a not in batch_axes for a in ("dp", "sharding")):
            raise NotImplementedError(
                f"batch axes {batch_axes} leave out a dp or sharding axis of "
                "the mesh: the step splits the batch over both (other "
                "layouts come with ROADMAP queue A item 1f)")
        # the model's ring attention and cross entropy read the global mesh
        _env.set_global_mesh(mesh)
        self._seq_cut = bool(getattr(getattr(model, "config", None),
                                     "context_parallel", False))
        self._token_axes = batch_axes + ("sep",) * self._seq_cut
        self._token_pg = _env.mesh_group(mesh, self._token_axes)
        self._batch_pg = _env.mesh_group(mesh, batch_axes)
        self._shard_pg = _env.mesh_group(mesh, "sharding")
        self._mp_pg = _env.mesh_group(mesh, "mp")
        self._pp_pg = _env.mesh_group(mesh, "pp")
        self._n_batch = 1
        self._batch_rank = 0   # in batch_axes' order, the first the slowest
        for a in batch_axes:
            self._n_batch *= sizes[a]
            self._batch_rank = self._batch_rank * sizes[a] + \
                mesh.get_local_rank(a)
        self._n_tokens = self._n_batch * (sizes["sep"] if self._seq_cut else 1)
        token = 0
        for a in self._token_axes:
            token = token * sizes[a] + mesh.get_local_rank(a)
        self._rng_rank = (token, mesh.get_local_rank("mp"))
        shard_model(model, self._mp_pg)
        # a pipelined model keeps its stage's layers; any other is whole on
        # every pp rank, which computes the whole step
        self._pipe = hasattr(model, "_pp_shard")
        if self._pipe:
            model._pp_shard(self._pp_pg)
        self._pp_shared = {k for k, p in self.params.items() if self._pipe
                           and not getattr(p, "pp_stage", False)}
        self._mp_dim = {k: p.split_axis if is_distributed(p)
                        else None for k, p in self.params.items()}
        self._ep_axes = self._shard_experts(model)
        # (ep axis or None, scatter) -> the group a bucket's all-reduce
        # runs over: the token axes, less the bucket's ep axis, less
        # sharding after a reduce-scatter
        self._reduce_pgs = {
            (ep, scatter): _env.mesh_group(mesh, tuple(
                a for a in self._token_axes
                if a != ep and not (scatter and a == "sharding")))
            for ep in [None, *sorted(set(self._ep_axes.values()))]
            for scatter in (False, True)}
        self._sp = {k for k, p in self.params.items()
                    if getattr(p, "sequence_parallel", False)}
        n = sizes["sharding"]
        r = torch.distributed.get_rank(self._shard_pg)
        self._layouts = {k: _Layout(p.shape, n, r, 0 if k in self._ep_axes
                                    else self._mp_dim[k])
                         if sharding_stage else None
                         for k, p in self.params.items()}
        self._buckets, self._bucket_of = self._plan()
        self._reducing = self._in_forward = False
        self._reduced, self._uses, self._acc, self._live = {}, {}, {}, {}
        self._scattering = []   # scatter buckets whose input is still held
        if offload and self.comm_overlap and self._device().type == "cuda":
            self._side = torch.cuda.Stream(device=self._device())
        # the hooks hold the step weakly: a tensor's hooks are kept on the
        # C++ side, out of the cycle collector's sight, so a strong
        # reference there would keep the step, its model and its states
        # alive for good
        ref = weakref.ref(self)

        def hook(p, k):
            step = ref()
            if step is not None:
                step._grad_hook(k, p)

        for k, p in self.params.items():
            p.register_post_accumulate_grad_hook(
                lambda p, k=k: hook(p, k))
        if sharding_stage == 3:
            self._shard_model()
        model._distributed_step = self

    def _shard_experts(self, model):
        """Give every MoE layer the token ranks to route over, and cut the
        experts of each whose `ep_axis` names a token axis over that axis's
        group (module docstring). Returns {parameter name: ep axis} of the
        parameters cut so."""
        layers = [m for m in model.modules() if hasattr(m, "_token_shard")]
        if layers and self._seq_cut:
            raise NotImplementedError(
                "MoE layers in a model whose sequence is cut over sep are "
                "ported with ROADMAP queue A item 1f")
        axes = set()
        for m in layers:
            m._token_shard(self._token_pg, self._batch_rank,
                           lambda: self._split)
            if m.ep_axis and m._fast():
                if m.ep_axis not in self._token_axes:
                    raise NotImplementedError(
                        f"experts cut over {m.ep_axis!r}, which the batch "
                        f"is not ({self._token_axes}): ROADMAP queue A item "
                        "1f")
                axes.add(m.ep_axis)
                m._ep_shard(_env.mesh_group(self.mesh, m.ep_axis))
        if len(axes) > 1:
            raise NotImplementedError(
                f"experts over the axes {sorted(axes)}: one ep axis a model "
                "(ROADMAP queue A item 1f)")
        self._ep_pg = (_env.mesh_group(self.mesh, axes.pop()) if axes
                       else None)
        return {k: p.ep_axis for k, p in self.params.items()
                if getattr(p, "ep_axis", None)}

    # -- layout -------------------------------------------------------- #

    def _cut(self, name):
        """The parameter's layout if it is cut into shards, else None."""
        lay = self._layouts[name] if self.mesh is not None else None
        return lay if lay is not None and lay.dim is not None else None

    def _scatter(self, name):
        return self.sharding_stage >= 2 and self._cut(name) is not None

    def _plan(self):
        """Buckets of at most BUCKET_BYTES in reverse parameter order, one
        (kind, dtype, sequence-parallel or not, shared over pp or not, ep
        axis) to a bucket."""
        buckets, open_, of = [], {}, {}
        for name in reversed(list(self.params)):
            p = self.params[name]
            kind = "scatter" if self._scatter(name) else "reduce"
            key = (kind, p.dtype, name in self._sp, name in self._pp_shared,
                   self._ep_axes.get(name))
            b = open_.get(key)
            if b is None:
                b = open_[key] = _Bucket(*key)
                buckets.append(b)
            n = self._layouts[name].n if kind == "scatter" else 1
            b.add(name, p.numel() // n, p.numel() * p.element_size())
            of[name] = b
            if b.nbytes >= BUCKET_BYTES:
                del open_[key]
        return buckets, of

    # -- stage 3: shards, gathers ---------------------------------------- #

    def _shard_model(self):
        """p.data becomes this rank's shard; each block (a child of a
        ModuleList) gathers its own cut parameters around its call, the
        root module the rest."""
        owner = {}
        for mname, mod in self.model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                owner.setdefault(id(p), (mname, mod, pname))
        blocks = {mname for mname, mod in self.model.named_modules()
                  if isinstance(mod, torch.nn.ModuleList)}
        units = {"": []}
        for mname, mod in self.model.named_modules():
            if mname and mname.rpartition(".")[0] in blocks:
                units[mname] = []
        with torch.no_grad():
            for name, p in self.params.items():
                lay = self._cut(name)
                if lay is None:
                    continue
                mname, mod, pname = owner[id(p)]
                unit = max((u for u in units
                            if u == "" or mname == u or mname.startswith(u + ".")),
                           key=len)
                units[unit].append((mod, pname, name, p))
                p.data = lay.shard(p.detach()).contiguous()
        for uname, members in units.items():
            if members:
                mod = self.model.get_submodule(uname)
                mod.register_forward_pre_hook(
                    lambda m, a, ms=members: self._enter(ms))
                mod.register_forward_hook(
                    lambda m, a, o, ms=members: self._leave(ms))

    def _gather_full(self, name, p):
        lay = self._cut(name)
        flat = torch.empty(lay.n * p.numel(), dtype=p.dtype, device=p.device)
        C._all_gather_flat(flat, p.detach().reshape(-1), self._shard_pg)
        return lay.assemble(flat)

    def _enter(self, members):
        count = torch.is_grad_enabled() and self._reducing and self._in_forward
        for mod, pname, name, p in members:
            full = _Gather.apply(p, self, name)
            if count:
                self._uses[name] = self._uses.get(name, 0) + 1
                self._live[id(full)] = (weakref.ref(full), name)
            mod._parameters[pname] = full

    def _leave(self, members):
        for mod, pname, _, p in members:
            mod._parameters[pname] = p

    def _gathered_grad(self, name, g):
        if not self._reducing:
            raise RuntimeError("a stage-3 model's backward runs inside its "
                               "DistributedTrainStep")
        acc = self._acc.get(name)
        self._acc[name] = g if acc is None else acc + g
        if self._pipe:
            return   # one backward a microbatch: reduced after the last
        self._uses[name] -= 1
        if self._uses[name] == 0:
            self._ready(name, self._acc.pop(name))

    def _pack(self, t):
        for cand in (t, t._base):
            e = self._live.get(id(cand)) if cand is not None else None
            if e is not None and e[0]() is cand:
                return _Token(e[1], t)
        return t

    def _unpack(self, x):
        if not isinstance(x, _Token):
            return x
        full = self._gather_full(x.name, self.params[x.name])
        return full.as_strided(*x.view)

    # -- gradients: buckets and their collectives ------------------------ #

    def _grad_hook(self, name, p):
        # (a stage-3 shard's accumulator runs too, with no gradient: the
        # gather's backward hands the gradient over itself). A pipelined
        # model runs a backward a microbatch: its gradients accumulate
        # until `_finish`
        if self._reducing and not self._pipe and p.grad is not None:
            self._ready(name, p.grad)
            p.grad = None

    def _buffer(self, b):
        """The bucket's input: one row per rank for a scatter."""
        if b.buf is None:
            rows = self._layouts[b.names[0]].n if b.kind == "scatter" else 1
            b.buf = torch.zeros(rows, b.total, dtype=b.dtype,
                                device=self._device())
        return b.buf

    def _ready(self, name, g):
        b = self._bucket_of[name]
        i = b.names.index(name)
        lo = b.offsets[i]
        src = (self._layouts[name].split(g) if b.kind == "scatter"
               else g.reshape(1, -1))
        self._buffer(b)[:, lo:lo + src.shape[1]].copy_(src)
        b.arrived.add(name)
        # (a pipelined model's buckets start in `_finish`, in plan order:
        # a stage holds gradients of only some of the shared parameters)
        if self.comm_overlap and not self._pipe and \
                len(b.arrived) == len(b.names):
            self._launch(b)

    def _launch(self, b):
        buf = self._buffer(b)
        if b.pp:
            # each stage's gradient of a shared parameter from its own use
            _pipeline.pp_all_reduce(buf, self._pp_pg)
        if b.sp:
            # each mp rank's gradient comes from its own sequence rows
            C._all_reduce(buf, self._mp_pg)
        if b.kind == "scatter":
            b.out = torch.empty(b.total, dtype=b.dtype, device=buf.device)
            b.work = C._reduce_scatter_flat(b.out, buf.view(-1),
                                            self._shard_pg, async_op=True)
            # a scatter's input is its parameters' whole gradient: let go
            # of the one before once its collective is done, so no more
            # than two are held (on the card the wait orders the stream
            # and does not block the host)
            for prev in self._scattering:
                prev.work.wait()
                prev.buf = None
            self._scattering = [b]
        else:
            b.out = buf.view(-1)
            b.work = C._all_reduce(b.out, self._reduce_pgs[(b.ep, False)],
                                   async_op=True)

    def _finish(self):
        """Start what the backward did not, wait for every bucket, and
        leave each parameter's averaged gradient (its shard's, for a
        scattered one) in `_reduced`."""
        if self._pipe:   # what the microbatches' backwards accumulated
            for name, p in self.params.items():
                if p.grad is not None:
                    self._ready(name, p.grad)
                    p.grad = None
        for name, acc in list(self._acc.items()):  # a gather left unused
            self._ready(name, acc)
        self._acc.clear()
        for b in self._buckets:
            if b.work is None:
                self._launch(b)
        for b in self._buckets:
            b.work.wait()
            b.buf = None
            if b.kind == "scatter":
                C._all_reduce(b.out, self._reduce_pgs[(b.ep, True)])
            b.out.div_(self._n_tokens)
            for name, lo in zip(b.names, b.offsets):
                shape = (self._layouts[name].shard_shape if b.kind == "scatter"
                         else self.params[name].shape)
                self._reduced[name] = b.out[lo:lo + shape.numel()].view(shape)
            b.reset()

    # -- the step -------------------------------------------------------- #

    def _batches(self, inputs, labels):
        with comm_task("h2d/inputs"):
            xs, ys = super()._batches(inputs, labels)
        if self.mesh is None:
            return xs, ys
        self._split = False
        return (self._cut_batch(xs, self._specs[0]),
                self._cut_batch(ys, self._specs[1]))

    def _cut_batch(self, xs, specs):
        if specs is None:
            n, r, M = self._n_batch, self._batch_rank, self._microbatches()
            out = []
            for x in xs:
                if x.dim() > 0 and x.shape[0] % (n * M) == 0:
                    x = self._rows(x, n, r)
                    self._split = True
                elif self._seq_cut and x.dim() > 1:
                    raise ValueError(f"{x.shape[0]} rows of an input "
                                     f"{tuple(x.shape)} do not divide over "
                                     f"{n} batch ranks")
                if self._seq_cut and x.dim() > 1:
                    x = self._sequence(x)
                out.append(x)
            return out
        if len(specs) != len(xs):
            raise ValueError(f"{len(specs)} specs for {len(xs)} inputs")
        out = []
        for x, spec in zip(xs, specs):
            x = self._cut_input(x, spec)
            whole = spec is None or len(spec) < 2 or spec[1] is None
            if self._seq_cut and x.dim() > 1 and whole:
                x = self._sequence(x)
            out.append(x)
        return out

    def _sequence(self, x):
        """This sep rank's contiguous chunk of dim 1."""
        n = _env.mesh_shape(self.mesh)["sep"]
        if x.shape[1] % n:
            raise ValueError(f"the sequence of an input {tuple(x.shape)} "
                             f"does not divide over {n} sep ranks")
        k = x.shape[1] // n
        return x.narrow(1, self.mesh.get_local_rank("sep") * k, k)

    def _microbatches(self):
        return self.model.num_microbatches if self._pipe else 1

    def _rows(self, x, n, r):
        """Rank r of n's rows of x: a pipelined model's microbatch m of
        them is its part of the global microbatch m (contiguous rows
        otherwise)."""
        M = self._microbatches()
        return x.unflatten(0, (M, n, -1))[:, r].flatten(0, 1)

    def _cut_input(self, x, spec):
        sizes = _env.mesh_shape(self.mesh)
        for d, axes in enumerate(spec or ()):
            if axes is None:
                continue
            names = (axes,) if isinstance(axes, str) else tuple(axes)
            n, r = 1, 0
            for a in names:   # the first axis is the slowest
                r = r * sizes[a] + self.mesh.get_local_rank(a)
                n *= sizes[a]
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of an input {tuple(x.shape)} "
                                 f"does not divide over {names} ({n} ranks)")
            if d == 0:
                M = self._microbatches()
                if x.shape[0] % (n * M):
                    raise ValueError(f"{x.shape[0]} rows do not divide "
                                     f"into {M} microbatches over {n} ranks")
                x = self._rows(x, n, r)
            else:
                k = x.shape[d] // n
                x = x.narrow(d, r * k, k)
            self._split |= bool(set(self._token_axes) & set(names))
        return x

    def _loss(self, inputs, labels):
        if self.mesh is None:
            return super()._loss(inputs, labels)
        with contextlib.ExitStack() as stack:
            # a recomputed block runs to its end (torch stops a
            # recomputation early by default, once it has what the
            # backward needs): every rank issues the block's collectives,
            # and a stage-3 block lets go of its gathered parameters there
            stack.enter_context(
                torch.utils.checkpoint.set_checkpoint_early_stop(False))
            stack.enter_context(batch_stats_over(self._batch_pg))
            if self.sharding_stage == 3 and self._reducing:
                self._in_forward = True
                stack.callback(setattr, self, "_in_forward", False)
                stack.enter_context(torch.autograd.graph.saved_tensors_hooks(
                    self._pack, self._unpack))
            return super()._loss(inputs, labels)

    def _loss_weight(self, notes, loss, whole_of=0):
        """This rank's weight of its loss, or of one noted term, in the
        global loss (module docstring, "Loss"): n * c_r / C for a mean, n
        for a sum, 1 otherwise; a one-stage pipeline's microbatch
        (`whole_of` = M) as jit.TrainStep weighs it, times n."""
        if self.mesh is None:
            return super()._loss_weight(notes, loss, whole_of)
        if len(notes) != 1:
            return 1.0
        n = self._n_tokens if self._split else 1
        kind, count, denom, _ = notes[0]
        if kind == "sum":
            return float(n * max(whole_of, 1))
        if whole_of:
            self._counts.append(count)
            return n * whole_of * denom
        if not self._split:
            return 1.0
        total = self._sum_counts(count)
        denom = torch.as_tensor(denom, dtype=torch.float32, device=loss.device)
        return n * denom / total.clamp(min=1.0)

    def _sum_counts(self, count):
        total = super()._sum_counts(count)
        if self.mesh is not None and self._split:
            C._all_reduce(total, self._token_pg)
        return total

    def _mean_loss(self, loss):
        loss = loss.detach().clone()
        C._all_reduce(loss, self._token_pg)
        return loss.div_(self._n_tokens)

    def __call__(self, inputs, labels):
        if self.mesh is None:
            return super().__call__(inputs, labels)
        for b in self._buckets:
            b.reset()
        self._uses, self._acc, self._live = {}, {}, {}
        self._scattering = []
        self._reducing = True
        try:
            with random.rank_scope(*self._rng_rank):
                loss = super().__call__(inputs, labels)
        finally:
            self._reducing = self._split = False
            self._live = {}
        return self._mean_loss(loss)

    @torch.no_grad()
    def evaluate(self, inputs, labels):
        if self.mesh is None:
            return super().evaluate(inputs, labels)
        try:
            with random.rank_scope(*self._rng_rank):
                loss = super().evaluate(inputs, labels)
        finally:
            self._split = False
        return self._mean_loss(loss)

    # -- the update ------------------------------------------------------ #

    @torch.no_grad()
    def _update(self):
        if self.mesh is not None:
            self._finish()
        super()._update()
        if self._side is not None:
            torch.cuda.current_stream().wait_stream(self._side)

    def _shard_grad(self, name, g):
        if self.mesh is None:
            return g
        g = self._reduced.pop(name)
        if self.sharding_stage == 1 and self._cut(name) is not None:
            return self._cut(name).shard(g)
        return g

    def _shard_param_for_update(self, name, p):
        if self.sharding_stage in (1, 2) and self._cut(name) is not None:
            return self._cut(name).shard(p)
        return p

    def _restore_param(self, name, p):
        if self.sharding_stage in (1, 2) and self._cut(name) is not None:
            p.copy_(self._gather_full(name, self._cut(name).shard(p).contiguous()))

    def _grad_sq_sum(self, grads):
        if self.mesh is None:
            return super()._grad_sq_sum(grads)
        # the groups a parameter's squared sum adds up over, in this order:
        # its sharding shards, its mp parts, its expert shards, a pipelined
        # model's stages; one all-reduce a group, of every sum that still
        # needs it (the same list on every rank)
        levels = [("sharding", self._shard_pg), ("mp", self._mp_pg)]
        if self._ep_pg is not None:
            levels.append(("ep", self._ep_pg))
        if self._pipe:
            levels.append(("pp", self._pp_pg))

        def needs(k):
            return frozenset(a for a, cut in (
                ("sharding", self._cut(k) is not None),
                ("mp", self._mp_dim[k] is not None),
                ("ep", k in self._ep_axes),
                ("pp", self._pipe and k not in self._pp_shared)) if cut)

        zero = torch.zeros((), device=self._device())
        names = [a for a, _ in levels]
        parts = {frozenset(c): zero for i in range(len(names) + 1)
                 for c in itertools.combinations(names, i)}
        for k, g in grads.items():
            if g is not None:
                parts[needs(k)] = parts[needs(k)] + g.float().square().sum()
        for a, pg in levels:
            keys = sorted((c for c in parts if a in c), key=sorted)
            vec = torch.stack([parts.pop(c) for c in keys])
            if a == "pp":
                _pipeline.pp_all_reduce(vec, pg)
            else:
                C._all_reduce(vec, pg)
            for c, v in zip(keys, vec):
                parts[c - {a}] = parts[c - {a}] + v
        return parts[frozenset()]

    def _apply(self, name, p, g, lr, ctx):
        if self.mesh is not None and self.optimizer.whole_norms:
            if self.offload:
                ctx = dict(ctx, sq_norms=self._whole_sq_norms(
                    name, self._offload_norm_parts(name, p, g, ctx)))
            else:
                ctx = dict(ctx, sum_norms=functools.partial(
                    self._whole_sq_norms, name))
        if not self.offload:
            return super()._apply(name, p, g, lr, ctx)
        t = self._shard_param_for_update(name, p)
        st = self._host_state(p, t)
        # a 0-d state (NAdam's mu_prod, ASGD's idx) is the whole
        # parameter's: every slice steps its own copy of the value before
        # the step, and the last slice's is written back once
        whole = {k for k, v in st.items() if v.dim() == 0}
        for part in self._offload_parts(t):
            dev = {k: v.to(t.device, copy=True) if k in whole
                   else part(v).to(t.device, non_blocking=True)
                   for k, v in st.items()}
            self.optimizer.apply_rule(part(t), None if g is None else part(g),
                                      dev, lr, ctx)
            if t.device.type == "cuda":
                self._to_host({k: v for k, v in dev.items() if k not in whole},
                              {k: part(v) for k, v in st.items()
                               if k not in whole})
        for k in whole:
            st[k].copy_(dev[k])

    @staticmethod
    def _offload_parts(t):
        """One function a slice of OFFLOAD_SLICE elements along t's first
        dim, cutting t, its gradient or a state tensor to the slice (a
        state [n, *t.shape], ASGD's ring, along its second dim)."""
        n = t.shape[0] if t.dim() else 1
        rows = max(1, OFFLOAD_SLICE // max(1, t[0].numel())) if t.dim() else 1
        for i in range(0, n, rows):
            def part(x, i=i):
                if not t.dim() or not x.dim():
                    return x
                d = 0 if x.shape == t.shape else 1
                return x.narrow(d, i, min(rows, x.shape[d] - i))
            yield part

    def _offload_norm_parts(self, name, p, g, ctx):
        """This rank's piece's squared sums of a `whole_norms` rule (Lamb,
        Lars), summed over its offload slices: a first pass that streams
        the state in and writes nothing back."""
        opt = self.optimizer
        t = self._shard_param_for_update(name, p)
        st = self._host_state(p, t)
        parts = 0
        for part in self._offload_parts(t):
            dev = {k: part(v).to(t.device, non_blocking=True)
                   for k, v in st.items()}
            parts = parts + opt.norm_parts(
                part(t), None if g is None else part(g), dev, ctx)
        return parts

    def _whole_sq_norms(self, name, parts):
        """The whole parameter's squared sums from this rank's piece's
        `parts`: all-reduced over the groups that hold the other pieces,
        over groups of one too."""
        parts = parts.float().contiguous()
        if self._cut(name) is not None:
            C._all_reduce(parts, self._shard_pg)
        if self._mp_dim[name] is not None:
            C._all_reduce(parts, self._mp_pg)
        if name in self._ep_axes:
            C._all_reduce(parts, self._ep_pg)
        if self._pipe and name not in self._pp_shared:
            _pipeline.pp_all_reduce(parts, self._pp_pg)
        return parts

    def _host_state(self, p, t):
        """p's optimizer state on the host (pinned on cuda), made on first
        use (shaped like t, the tensor this rank updates)."""
        opt = self.optimizer
        st = opt._states.get(id(p))
        if st is None:
            st = opt.init_state(torch.empty(t.shape, dtype=t.dtype))
            if opt._multi_precision and t.dtype in (torch.bfloat16, torch.float16):
                st["master"] = t.detach().float().cpu()
        if any(v.device.type != "cpu" or (t.is_cuda and not v.is_pinned())
               for v in st.values()):
            st = {k: v.cpu().pin_memory() if t.is_cuda else v.cpu()
                  for k, v in st.items()}
        opt._states[id(p)] = st
        return st

    def _to_host(self, dev, host):
        if self._side is None:
            for k, v in dev.items():
                host[k].copy_(v)
            return
        self._side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._side):
            for k, v in dev.items():
                host[k].copy_(v, non_blocking=True)
                v.record_stream(self._side)

    def _gather_state(self, name, v):
        """A state tensor of `name` as the whole parameter's (a shard's
        gathered over sharding and mp; host-resident ones through the
        device)."""
        if self.mesh is None:
            return v.detach().clone()
        if self.sharding_stage and self._cut(name) is not None:
            v = self._gather_full(name, v.to(self._device()).contiguous())
        if self._mp_dim[name] is not None:
            return C.gather_along(v.to(self._device()), self._mp_dim[name],
                                  self._mp_pg)
        if name in self._ep_axes:
            return C.gather_along(v.to(self._device()), 0, self._ep_pg)
        return v.detach().clone()

    def state_dict(self):
        """The model's full parameters and buffers under the reference's
        names (stage-3 shards gathered); every rank must call it."""
        return full_state_dict(self.model)

    # -- the training state as this rank's shards (module docstring) ----- #

    def _init_states(self):
        if not self.offload:
            return super()._init_states()
        for k, p in self.params.items():
            self._host_state(p, self._shard_param_for_update(k, p))

    def _placement(self, name, t, state):
        if self.mesh is None or name is None or t.dim() == 0:
            return t
        p = self.params[name]
        lay = self._layouts[name]
        local = list(lay.shape if lay is not None else p.shape)
        gshape = list(local)
        idx = [np.arange(n) for n in local]   # local -> global index a dim
        cut = set()
        if self._mp_dim[name] is not None:
            d = self._mp_dim[name]
            n = torch.distributed.get_world_size(self._mp_pg)
            r = torch.distributed.get_rank(self._mp_pg)
            gshape[d] = local[d] * n
            idx[d] = idx[d] + r * local[d]
            cut.add("mp")
        ep = getattr(p, "ep_part", None)
        if name in self._ep_axes and ep is not None:
            d, r, n = ep
            gshape[d] = local[d] * n
            idx[d] = idx[d] + r * local[d]
            cut.add(self._ep_axes[name])
        pp = getattr(p, "pp_part", None)
        if self._pipe and name not in self._pp_shared and pp is not None:
            S, s, V = pp
            k = local[0] // V
            gshape[0] = S * local[0]
            j = np.arange(local[0])
            idx[0] = (j // k) * S * k + s * k + j % k
            cut.add("pp")
        zero = self._cut(name)
        if zero is not None and (state or self.sharding_stage == 3) and \
                tuple(t.shape) == tuple(zero.shard_shape):
            z = zero.dim
            idx[z] = idx[z][zero.rank * zero.size:(zero.rank + 1) * zero.size]
            cut.add("sharding")
        sizes = _env.mesh_shape(self.mesh)
        write = all(self.mesh.get_local_rank(a) == 0
                    for a in _env.AXIS_ORDER if sizes[a] > 1 and a not in cut)
        # runs of consecutive global indices a dim; a block a combination
        runs = []
        for ix in idx:
            cuts = np.flatnonzero(np.diff(ix) != 1) + 1
            starts = np.concatenate([[0], cuts])
            ends = np.concatenate([cuts, [len(ix)]])
            runs.append([(int(a), int(ix[a]), int(b - a))
                         for a, b in zip(starts, ends)])
        shards = []
        for combo in itertools.product(*runs):
            view = t
            for d, (lo, _, n) in enumerate(combo):
                view = view.narrow(d, lo, n)
            shards.append(LocalShard(view, tuple(g for _, g, _ in combo),
                                     tuple(gshape), write))
        return shards


def full_state_dict(model):
    """`model.state_dict()` with every stage-3 parameter gathered from its
    shards, every mp-cut one from the mp ranks, every expert shard from its
    ep ranks and a pipelined model's stacks from its stages (a collective:
    every rank of the mesh calls it); a model that is not cut gives its own
    tensors."""
    step = getattr(model, "_distributed_step", None)
    mp_pg = getattr(model, "_mp_group", None)
    pp_pg = getattr(model, "_pp_group", None)
    out = {}
    names = {id(p): k for k, p in model.named_parameters()}
    for k, v in model.state_dict(keep_vars=True).items():
        name = names.get(id(v))
        t, fresh = v.detach(), False
        if (step is not None and step.sharding_stage == 3 and name is not None
                and step._cut(name) is not None):
            t, fresh = step._gather_full(name, v), True
        if mp_pg is not None and is_distributed(v):
            t, fresh = C.gather_along(t, v.split_axis, mp_pg), True
        if getattr(v, "ep_group", None) is not None:
            t, fresh = C.gather_along(t, v.ep_part[0], v.ep_group), True
        if pp_pg is not None and getattr(v, "pp_part", None) is not None:
            t, fresh = _pipeline.gather_stages(t, pp_pg, v.pp_part[2]), True
        out[k] = t if fresh else t.clone()
    return out


def _check_specs(specs):
    """`input_specs` / `label_specs`: None, or one spec per input (None or
    a tuple of None / axis name / tuple of axis names per dim)."""
    if specs is None:
        return None
    for spec in specs:
        for axes in spec or ():
            names = (axes,) if isinstance(axes, str) else tuple(axes or ())
            bad = [a for a in names if a not in _env.AXIS_ORDER]
            if bad:
                raise ValueError(f"spec {spec!r} names axes {bad} that the "
                                 f"mesh lacks {_env.AXIS_ORDER}")
    return [tuple(s) if s is not None else None for s in specs]

