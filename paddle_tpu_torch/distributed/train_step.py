"""`DistributedTrainStep`: the data-parallel and ZeRO training step over a
mesh (↔ paddle_tpu/distributed/train_step.py:116).

The reference is one XLA program over global arrays, its collectives
placed by `NamedSharding` specs. Here each process is one rank of a
`DeviceMesh` (`env.build_mesh`), and the step runs `jit.TrainStep`'s
forward, backward and update on this rank's tensors with explicit
collectives (`collective._all_gather_flat`, `_reduce_scatter_flat`,
`_all_reduce`, all counted in `collective.CALLS` / `BYTES`). It does not
wrap the model in DDP or FSDP: the port's kernels are autograd Functions
that must see plain tensors, and the shards follow the reference's
`fsdp_spec`, so that shards and state line up name for name.

- **Batch.** Each input is split along its first dim over the (dp,
  sharding) ranks (`_batch_spec` :328-335); an input that does not divide
  is taken whole by every rank. The returned loss is the mean over those
  ranks.
- **Layout.** A parameter is cut along the dim `fsdp_spec` picks (the
  largest dim divisible by the `sharding` size) into one shard per
  sharding rank; one with no such dim stays whole (:76-77). Unlike the
  reference, a sharding axis of size 1 is cut too (into one shard), so a
  one-rank mesh runs the same gathers and reduce-scatters, over a group of
  one, as a sharded one.
- **Stage 0.** Gradients are averaged over the (dp, sharding) group
  (all-reduce).
- **Stage 1.** As stage 0, and the optimizer state (the f32 master copy
  too) is kept for this rank's shard only; the rank updates its shard and
  all-gathers the parameter.
- **Stage 2.** As stage 1, but a cut parameter's gradient is
  reduce-scattered over the sharding group to its owner shard (and
  all-reduced over dp) (`_update_spec` :176).
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
- **Clip.** The global-norm clip's squared sum adds this rank's shards'
  sums over the sharding group, and counts a parameter that is not cut
  once.

`mesh=None` with no process group (or a reference mesh of one device) is
`jit.TrainStep` on one device, as before: stages 1 and 2 are the stage-0 step there (over an axis of size 1
the reference's shardings are no-ops), and stage 3 and offload ask for a
mesh. Tensor, pipeline, segment and expert parallelism (a mesh whose mp,
pp, sep or ep is above 1) raise NotImplementedError naming their ROADMAP
queue A items.
"""

from __future__ import annotations

import weakref

import torch
import torch.utils.checkpoint
from torch.distributed.device_mesh import DeviceMesh

from ..jit import TrainStep
from . import collective as C
from . import env as _env

__all__ = ["DistributedTrainStep", "fsdp_spec", "full_state_dict",
           "host_memory_kind", "shard_dim", "shard_params_for_stage3"]

BUCKET_BYTES = 25e6        # the reference's reduce-scatter bucket (25 MB)
OFFLOAD_SLICE = 1 << 23    # elements of a state slice streamed at a time

_UNPORTED_AXES = {"mp": "tensor parallelism (ROADMAP queue A item 1b)",
                  "pp": "pipeline parallelism (ROADMAP queue A item 1c)",
                  "sep": "segment parallelism (ROADMAP queue A item 1d)",
                  "ep": "expert parallelism (ROADMAP queue A item 1e)"}


def host_memory_kind(mesh):
    """Where offloaded states live: "pinned_host" for a mesh on `cuda`,
    "unpinned_host" on the CPU (where host and device memory coincide, so
    offload keeps the states where they are and runs the same code)."""
    return "pinned_host" if mesh.device_type == "cuda" else "unpinned_host"


def shard_dim(shape, n):
    """The dim `fsdp_spec` cuts over n ranks: the largest dim divisible by
    n (the later one on a tie), or None."""
    cands = [(s, i) for i, s in enumerate(shape) if s % n == 0 and s >= n]
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
    into n shards of `size` (this rank's is `rank`), or whole (dim None)."""

    def __init__(self, shape, n, rank):
        self.shape = torch.Size(shape)
        self.dim = shard_dim(self.shape, n)
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
    over the sharding group to each rank's shard, then all-reduce over dp)
    or "reduce" (all-reduce over the (dp, sharding) group)."""

    def __init__(self, kind, dtype):
        self.kind, self.dtype = kind, dtype
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
        if input_specs is not None or label_specs is not None:
            raise NotImplementedError(
                "input_specs / label_specs (tensor and sequence parallel "
                "layouts) are ported with ROADMAP queue A item 1b")
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
        for axis, what in _UNPORTED_AXES.items():
            if sizes[axis] > 1:
                raise NotImplementedError(
                    f"a mesh with {axis}={sizes[axis]}: {what}")
        if any(sizes[a] > 1 and a not in batch_axes for a in ("dp", "sharding")):
            raise NotImplementedError(
                f"batch axes {tuple(batch_axes)} leave out a dp or sharding "
                "axis of the mesh: the step splits the batch over both "
                "(other layouts come with ROADMAP queue A items 1b-1e)")
        self._batch_pg = _env.mesh_group(mesh, ("dp", "sharding"))
        self._shard_pg = _env.mesh_group(mesh, "sharding")
        self._dp_pg = _env.mesh_group(mesh, "dp")
        self._n_batch = sizes["dp"] * sizes["sharding"]
        self._batch_rank = torch.distributed.get_rank(self._batch_pg)
        n = sizes["sharding"]
        r = torch.distributed.get_rank(self._shard_pg)
        self._layouts = {k: _Layout(p.shape, n, r) if sharding_stage else None
                         for k, p in self.params.items()}
        self._buckets, self._bucket_of = self._plan()
        self._reducing = self._in_forward = False
        self._reduced, self._uses, self._acc, self._live = {}, {}, {}, {}
        self._scattering = []   # scatter buckets whose input is still held
        if offload and self.comm_overlap and self._device().type == "cuda":
            self._side = torch.cuda.Stream(device=self._device())
        for k, p in self.params.items():
            p.register_post_accumulate_grad_hook(
                lambda p, k=k: self._grad_hook(k, p))
        if sharding_stage == 3:
            self._shard_model()
        model._distributed_step = self

    # -- layout -------------------------------------------------------- #

    def _cut(self, name):
        """The parameter's layout if it is cut into shards, else None."""
        lay = self._layouts[name] if self.mesh is not None else None
        return lay if lay is not None and lay.dim is not None else None

    def _scatter(self, name):
        return self.sharding_stage >= 2 and self._cut(name) is not None

    def _plan(self):
        """Buckets of at most BUCKET_BYTES in reverse parameter order, one
        (kind, dtype) to a bucket."""
        buckets, open_, of = [], {}, {}
        for name in reversed(list(self.params)):
            p = self.params[name]
            kind = "scatter" if self._scatter(name) else "reduce"
            b = open_.get((kind, p.dtype))
            if b is None:
                b = open_[(kind, p.dtype)] = _Bucket(kind, p.dtype)
                buckets.append(b)
            n = self._layouts[name].n if kind == "scatter" else 1
            b.add(name, p.numel() // n, p.numel() * p.element_size())
            of[name] = b
            if b.nbytes >= BUCKET_BYTES:
                del open_[(kind, p.dtype)]
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
        # gather's backward hands the gradient over itself)
        if self._reducing and p.grad is not None:
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
        if self.comm_overlap and len(b.arrived) == len(b.names):
            self._launch(b)

    def _launch(self, b):
        buf = self._buffer(b)
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
            b.work = C._all_reduce(b.out, self._batch_pg, async_op=True)

    def _finish(self):
        """Start what the backward did not, wait for every bucket, and
        leave each parameter's averaged gradient (its shard's, for a
        scattered one) in `_reduced`."""
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
                C._all_reduce(b.out, self._dp_pg)
            b.out.div_(self._n_batch)
            for name, lo in zip(b.names, b.offsets):
                shape = (self._layouts[name].shard_shape if b.kind == "scatter"
                         else self.params[name].shape)
                self._reduced[name] = b.out[lo:lo + shape.numel()].view(shape)
            b.reset()

    # -- the step -------------------------------------------------------- #

    def _batch(self, xs):
        xs = super()._batch(xs)
        if self.mesh is None:
            return xs
        n, r = self._n_batch, self._batch_rank
        return [x.chunk(n)[r] if x.dim() and x.shape[0] % n == 0 else x
                for x in xs]

    def _loss(self, inputs, labels):
        if self.sharding_stage != 3 or not self._reducing:
            return super()._loss(inputs, labels)
        self._in_forward = True
        try:
            # a recomputed block must run to its end, where it lets go of
            # its gathered parameters (torch stops a recomputation early
            # by default, once it has what the backward needs)
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack), \
                    torch.utils.checkpoint.set_checkpoint_early_stop(False):
                return super()._loss(inputs, labels)
        finally:
            self._in_forward = False

    def _mean_loss(self, loss):
        loss = loss.detach().clone()
        C._all_reduce(loss, self._batch_pg)
        return loss.div_(self._n_batch)

    def __call__(self, inputs, labels):
        if self.mesh is None:
            return super().__call__(inputs, labels)
        for b in self._buckets:
            b.reset()
        self._uses, self._acc, self._live = {}, {}, {}
        self._scattering = []
        self._reducing = True
        try:
            loss = super().__call__(inputs, labels)
        finally:
            self._reducing = False
            self._live = {}
        return self._mean_loss(loss)

    @torch.no_grad()
    def evaluate(self, inputs, labels):
        loss = super().evaluate(inputs, labels)
        return loss if self.mesh is None else self._mean_loss(loss)

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
        zero = torch.zeros((), device=self._device())
        sq = {k: g.float().square().sum() for k, g in grads.items()
              if g is not None}
        cut = sum((v for k, v in sq.items() if self._cut(k) is not None), zero)
        whole = sum((v for k, v in sq.items() if self._cut(k) is None), zero)
        C._all_reduce(cut, self._shard_pg)
        return cut + whole

    def _apply(self, name, p, g, lr, ctx):
        if not self.offload:
            return super()._apply(name, p, g, lr, ctx)
        t = self._shard_param_for_update(name, p)
        st = self._host_state(p, t)
        n = t.shape[0] if t.dim() else 1
        rows = max(1, OFFLOAD_SLICE // max(1, t[0].numel())) if t.dim() else 1
        for i in range(0, n, rows):
            def part(x):
                return x.narrow(0, i, min(rows, x.shape[0] - i)) if x.dim() else x
            dev = {k: part(v).to(t.device, non_blocking=True)
                   for k, v in st.items()}
            self.optimizer.apply_rule(part(t), None if g is None else part(g),
                                      dev, lr, ctx)
            if t.device.type == "cuda":
                self._to_host(dev, {k: part(v) for k, v in st.items()})

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
        gathered; host-resident ones through the device)."""
        if self.mesh is None or not self.sharding_stage or self._cut(name) is None:
            return v.detach().clone()
        return self._gather_full(name, v.to(self._device()).contiguous())

    def state_dict(self):
        """The model's full parameters and buffers under the reference's
        names (stage-3 shards gathered); every rank must call it."""
        return full_state_dict(self.model)


def full_state_dict(model):
    """`model.state_dict()` with every stage-3 parameter gathered from its
    shards (a collective: every rank of the mesh calls it); a model that no
    DistributedTrainStep shards gives its own tensors."""
    step = getattr(model, "_distributed_step", None)
    out = {}
    names = {id(p): k for k, p in model.named_parameters()}
    for k, v in model.state_dict(keep_vars=True).items():
        name = names.get(id(v))
        if (step is not None and step.sharding_stage == 3 and name is not None
                and step._cut(name) is not None):
            out[k] = step._gather_full(name, v)
        else:
            out[k] = v.detach().clone()
    return out

