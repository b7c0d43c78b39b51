"""Pipeline parallelism over a pp process group (↔ paddle_tpu/parallel/pipeline.py).

The reference compiles each schedule into one XLA program: a `lax.scan`
whose ticks `ppermute` activations over the mesh's pp axis, with XLA's
autodiff (or a `custom_vjp`) for the backward. The port runs one process
per rank, and a process can neither join another's program nor
differentiate through its sends, so each schedule here is a loop that this
rank runs over its own stage, as Paddle's `forward_backward_pipeline`
(pipeline_parallel.py:684) and Megatron's schedules are: activations go to
the next stage and gradients to the previous one through
`torch.distributed.batch_isend_irecv`, and each microbatch's backward is
`torch.autograd.backward(stage_output, gradient_from_the_next_stage)`.

A stage function is `stage_fn(x, m)`: on the first stage x is microbatch m
of the inputs (`inputs_mb`, leaves [M, ...] as `microbatch` cuts them), on
the others what the previous stage's `stage_fn` returned for m, received:
a tensor, or a tuple of tensors. Floating-point tensors are
differentiable; others (riders) pass without a gradient. The functions
close over their parameters, whose gradients accumulate in `.grad` as
usual. A stage that is the only one sends and receives nothing, so
`group=None` (or a group of one) runs the same code with one stage.

- `pipeline_spmd` (GPipe, FThenB): every forward, then every backward. It
  returns the last stage's outputs, stacked [M, ...], on every rank (a
  broadcast), as an autograd Function whose backward runs the backward
  schedule: every rank's loss must be the same function of them, and the
  last stage's gradient of them is the one used.
- `pipeline_1f1b`: warm-up forwards, then one forward and one backward a
  step, then the cool-down backwards (Megatron's order, each send paired
  with its receive in one batch, so that NCCL sees both ends post them in
  the same order). A stage holds at most min(M, S - s) microbatches in
  flight, and only their inputs: each forward runs without a graph and the
  backward runs the stage again from the kept input (the reference's
  remat). The last stage applies `loss_fn(y, m)` to each output as it
  comes and seeds that microbatch's backward with loss / M. The schedule
  runs every backward and returns the mean of the M losses, broadcast from
  the last stage; it is not itself differentiable.
- `pipeline_interleaved` (VPP): stage s holds chunks v = 0..V-1, virtual
  stage v * S + s (`pack_chunked`), and runs `stage_fn(v, x, m)`; a
  microbatch rides the ring from the last stage back to the first V
  times. Each tick every rank sends what it computed to the next stage
  and receives from the previous one in one batch, as the reference's
  tick does; the backward runs the ticks in reverse. Needs M >= S.

Receive buffers: before a call's first message on each link the sender
sends a small int64 header of the shapes and dtypes to come, so a stage
need not know what its neighbour computes (the hidden state under
sequence parallelism, or in the autocast dtype). `double_buffer` is taken
and keeps the math the same; the reference's environment default for it
is not ported (no toggles).

`IN_FLIGHT[schedule]` is the most microbatches this rank held in flight in
its last call of that schedule, and `PP_CALLS` counts what went over a pp
group: "send" and "recv" (tensors, headers included), "broadcast" and
"all_reduce" (a group's first use, and the training step's sums of the
parameters shared over pp). Sends, receives and broadcasts are counted in
the registry's `collective_calls_total` / `collective_bytes_total` too.
"""

from __future__ import annotations

from collections import deque

import torch
import torch.distributed as dist

from .. import amp
from ..distributed import collective as C

__all__ = ["IN_FLIGHT", "PP_CALLS", "gather_stages", "microbatch",
           "pack_chunked", "pipeline_1f1b", "pipeline_interleaved",
           "pipeline_spmd", "pp_all_reduce", "stack_pytrees", "stage_rows",
           "unmicrobatch", "unstack_leading"]

IN_FLIGHT: dict = {}   # schedule -> most microbatches held in this rank's last call
PP_CALLS: dict = {}    # op -> calls over a pp group

_META = 64             # int64 entries of a shape header
_CODES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool)


def _count(op):
    PP_CALLS[op] = PP_CALLS.get(op, 0) + 1


# -- trees ------------------------------------------------------------------ #

def _flatten(tree):
    """(leaves, rebuild) of a tensor or a (nested) tuple / list / dict."""
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t) for t in tree]

        def rebuild(xs):
            out, i = [], 0
            for p, r in parts:
                out.append(r(xs[i:i + len(p)]))
                i += len(p)
            return type(tree)(out)
        return [x for p, _ in parts for x in p], rebuild
    if isinstance(tree, dict):
        keys = list(tree)
        leaves, rebuild = _flatten([tree[k] for k in keys])
        return leaves, lambda xs: dict(zip(keys, rebuild(xs)))
    return [tree], lambda xs: xs[0]


def _map(fn, tree):
    leaves, rebuild = _flatten(tree)
    return rebuild([fn(x) for x in leaves])


def stack_pytrees(trees):
    """Stack trees of one structure along a new leading dim."""
    flat = [_flatten(t) for t in trees]
    return flat[0][1]([torch.stack(xs) for xs in zip(*(f for f, _ in flat))])


def unstack_leading(tree, n):
    """Inverse of stack_pytrees: one tree per leading index."""
    return [_map(lambda a, i=i: a[i], tree) for i in range(n)]


def microbatch(tree, num_microbatches):
    """Every leaf [B, ...] -> [M, B / M, ...]: microbatch m is the
    contiguous rows [m * B / M, (m + 1) * B / M)."""
    def split(a):
        if a.shape[0] % num_microbatches:
            raise ValueError(f"batch {a.shape[0]} not divisible by "
                             f"{num_microbatches} microbatches")
        return a.reshape(num_microbatches, a.shape[0] // num_microbatches,
                         *a.shape[1:])
    return _map(split, tree)


def unmicrobatch(tree):
    """Inverse of microbatch: [M, mb, ...] -> [M * mb, ...]."""
    return _map(lambda a: a.reshape(a.shape[0] * a.shape[1], *a.shape[2:]),
                tree)


def pack_chunked(stacked, S, V):
    """[S * V, ...] virtual-stage-major leaves -> [V, S, ...]: stage s holds
    chunks v * S + s (the reference's layout, pp_layers.py
    get_stage_from_index)."""
    return _map(lambda a: a.reshape(V, S, *a.shape[1:]), stacked)


def stage_rows(t, S, s, V=1):
    """Stage s's rows of a stacked [L, ...] tensor: its V chunks of
    L / (S V) rows, virtual stages v * S + s, in chunk order."""
    L = t.shape[0]
    if L % (S * V):
        raise ValueError(f"{L} layers do not divide over {S} stages x {V} "
                         "chunks")
    k = L // (S * V)
    return torch.cat([t.narrow(0, (v * S + s) * k, k) for v in range(V)])


def gather_stages(t, pg, V=1):
    """The whole [L, ...] stack from every stage's `stage_rows` (a
    collective over the pp group pg)."""
    S = dist.get_world_size(pg)
    flat = torch.empty(S * t.numel(), dtype=t.dtype, device=t.device)
    C._all_gather_flat(flat, t.contiguous().reshape(-1), pg)
    k = t.shape[0] // V
    return flat.view(S, V, k, *t.shape[1:]).transpose(0, 1).reshape(
        S * t.shape[0], *t.shape[1:])


def pp_all_reduce(t, pg, async_op=False):
    """Sum t over the pp group pg in place (counted in PP_CALLS)."""
    _count("all_reduce")
    return C._all_reduce(t, pg, async_op=async_op)


# -- this rank's place in the pp group: its sends and receives -------------- #

def _diff(t):
    return t.is_floating_point()


def _header(tree, device):
    leaves = _flatten(tree)[0]
    h = [len(leaves) if isinstance(tree, (tuple, list)) else -1]
    for t in leaves:
        h += [_CODES.index(t.dtype), t.dim(), *t.shape]
    if len(h) > _META:
        raise ValueError(f"tensors of shapes {[tuple(t.shape) for t in leaves]}"
                         f" do not fit a {_META}-entry shape header")
    out = torch.zeros(_META, dtype=torch.int64)
    out[:len(h)] = torch.tensor(h, dtype=torch.int64)
    return out.to(device)


def _read_header(h):
    """([(shape, dtype)], rebuild) from a header."""
    h = h.tolist()
    like, i = [], 1
    for _ in range(abs(h[0])):
        code, nd = h[i], h[i + 1]
        like.append((tuple(h[i + 2:i + 2 + nd]), _CODES[code]))
        i += 2 + nd
    return like, (lambda xs: xs[0]) if h[0] < 0 else tuple


class _Ring:
    """Stage s of S over a pp process group (None: one stage); `prev` and
    `next` are the global ranks beside it on the ring (the last stage's next
    is the first). A ring of one stage hands its sends to itself."""

    _used: set = set()

    def __init__(self, group):
        pg = getattr(group, "process_group", group)
        self.pg = pg
        self.S, self.s, self.device = 1, 0, torch.device("cpu")
        if pg is not None:
            ranks = dist.get_process_group_ranks(pg)
            self.S, self.s = len(ranks), dist.get_rank(pg)
            self.prev = ranks[(self.s - 1) % self.S]
            self.next = ranks[(self.s + 1) % self.S]
            if dist.get_backend(pg) == "nccl":
                self.device = torch.device("cuda", torch.cuda.current_device())
            if pg not in _Ring._used:
                # NCCL wants every rank of a group in its first collective,
                # which a send between two stages is not
                _Ring._used.add(pg)
                pp_all_reduce(torch.zeros(1, device=self.device), pg)
        self.first, self.last = self.s == 0, self.s == self.S - 1
        self._sent_header = False
        self._from_prev = None   # (like, rebuild) once the header came

    def _op(self, send, t, peer):
        kind = "send" if send else "recv"
        _count(kind)
        C.record_collective_traffic(kind, t.numel() * t.element_size())
        return dist.P2POp(dist.isend if send else dist.irecv, t, peer,
                          group=self.pg)

    def _run(self, ops):
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    def comm(self, send_next=None, send_prev=None, recv_prev=False,
             recv_next=None):
        """One batch of this stage's sends and receives: the tree
        `send_next` to the next stage, the tensors `send_prev` to the
        previous one; with `recv_prev` what the previous stage sends (its
        header says the shapes), with `recv_next` ([(shape, dtype)]) what
        the next one sends back. Returns (tree from prev, tensors from
        next), None where nothing was received."""
        if self.S == 1 and (recv_prev or recv_next is not None):
            # only VPP receives at one stage: its chunks wrap to the
            # stage itself; every other one-stage call posts nothing below
            got = None
            if recv_prev:
                got = _flatten(send_next)[1](
                    [t.detach().clone() for t in _flatten(send_next)[0]])
            return got, (None if recv_next is None
                         else [t.detach().clone() for t in send_prev])
        head = []
        if send_next is not None and not self._sent_header:
            self._sent_header = True
            head.append(self._op(True, _header(send_next, self.device),
                                 self.next))
        hbuf = None
        if recv_prev and self._from_prev is None:
            hbuf = torch.zeros(_META, dtype=torch.int64, device=self.device)
            head.append(self._op(False, hbuf, self.prev))
        self._run(head)
        if hbuf is not None:
            self._from_prev = _read_header(hbuf)
        ops, got_prev, got_next = [], None, None
        for t in _flatten(send_next)[0] if send_next is not None else ():
            ops.append(self._op(True, t.detach().contiguous(), self.next))
        for t in send_prev or ():
            ops.append(self._op(True, t.detach().contiguous(), self.prev))
        if recv_prev:
            got_prev = [torch.empty(s, dtype=d, device=self.device)
                        for s, d in self._from_prev[0]]
            ops += [self._op(False, t, self.prev) for t in got_prev]
        if recv_next is not None:
            got_next = [torch.empty(s, dtype=d, device=self.device)
                        for s, d in recv_next]
            ops += [self._op(False, t, self.next) for t in got_next]
        self._run(ops)
        if got_prev is not None:
            got_prev = self._from_prev[1](got_prev)
        return got_prev, got_next

    def broadcast_last(self, tree, like=None):
        """The last stage's tree (a tensor or tuple of tensors) on every
        rank; the others pass None. Given `like` ([(shape, dtype)], a tuple
        of them unless one), no header goes first."""
        if self.pg is None:
            return tree
        src = dist.get_process_group_ranks(self.pg)[-1]
        if like is None:
            hbuf = (_header(tree, self.device) if self.last else
                    torch.zeros(_META, dtype=torch.int64, device=self.device))
            self._bcast(hbuf, src)
            like, rebuild = _read_header(hbuf)
        else:
            rebuild = (lambda xs: xs[0]) if len(like) == 1 else tuple
        ts = (_flatten(tree)[0] if self.last else
              [torch.empty(s, dtype=d, device=self.device) for s, d in like])
        for t in ts:
            self._bcast(t, src)
        return rebuild(ts)

    def _bcast(self, t, src):
        _count("broadcast")
        C.record_collective_traffic("broadcast", t.numel() * t.element_size())
        dist.broadcast(t, src, group=self.pg)


def _grads_of(xs):
    """The gradients of the float tensors of xs (zeros where none came)."""
    return [t.grad if t.grad is not None else torch.zeros_like(t)
            for t in xs if _diff(t)]


def _backward(ys, grads):
    """Back-propagate `grads` (one per float tensor of ys) into ys."""
    pairs = [(y, g) for y, g in zip([y for y in ys if _diff(y)], grads)
             if y.requires_grad]
    if pairs:
        torch.autograd.backward([y for y, _ in pairs], [g for _, g in pairs])


def _like(ys):
    return [(t.shape, t.dtype) for t in ys if _diff(t)]


# -- GPipe and VPP: tick schedules under one autograd Function --------------- #

class _Schedule(torch.autograd.Function):
    """A schedule's forward ticks in the forward, its backward ticks in the
    backward. `dummy` needs a gradient, so every rank's output does and
    every rank joins the backward schedule."""

    @staticmethod
    def forward(ctx, sched, dummy, *leaves):
        ctx.sched = sched
        outs = sched.forward(leaves)
        ctx.mark_non_differentiable(*[o for o in outs if not _diff(o)])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ctx.sched.backward(grads))


class _Ticks:
    """What GPipe and VPP share: each step's kept input (and graph, without
    remat) and its backward, the first stage's input gradients, and the
    last stage's outputs put on every rank."""

    name = None

    def __init__(self, ring, inputs_mb, remat):
        self.ring = ring
        self.leaves, self.rebuild = _flatten(inputs_mb)
        self.M = self.leaves[0].shape[0]
        self.remat, self.grad = remat, torch.is_grad_enabled()
        self.amp = amp.amp_state()
        self.kept, self.peak = {}, 0
        self.out_like = None     # (shape, dtype) of the stage output's floats
        self.outs = {}           # the last stage's outputs, by microbatch
        self.dx = {}             # the first stage's input gradients, by microbatch

    def fn(self, key, x):
        raise NotImplementedError

    def input(self, m):
        """Microbatch m of the inputs as a tree of fresh tensors; a float
        that needs a gradient is a leaf that takes one."""
        return self.rebuild([
            t[m].detach().requires_grad_(self.grad and t.requires_grad
                                         and _diff(t)) for t in self.leaves])

    def received(self, x):
        """A received tree as a step's input: its floats take gradients."""
        return _map(lambda t: t.requires_grad_(self.grad and _diff(t)), x)

    def step(self, key, x):
        """One forward step on the tree x; returns its output, detached."""
        build = self.grad and not self.remat
        with torch.enable_grad() if build else torch.no_grad():
            y = self.fn(key, x)
        ys, rebuild = _flatten(y)
        self.kept[key] = (_flatten(x), ys if build else None)
        self.peak = max(self.peak, len(self.kept))
        if self.out_like is None:
            self.out_like = _like(ys)
        return rebuild([t.detach() for t in ys])

    def back(self, key, grads):
        """The backward of a kept step from its output's gradients; returns
        the gradients of its float inputs."""
        (xs, rebuild), ys = self.kept.pop(key)
        if ys is None:
            xs = [t.detach().requires_grad_(_diff(t)) for t in xs]
            with torch.enable_grad(), amp.auto_cast.restore(self.amp):
                ys = _flatten(self.fn(key, rebuild(xs)))[0]
        _backward(ys, grads)
        return _grads_of(xs)

    def forward(self, leaves):
        self.ticks()
        IN_FLIGHT[self.name] = self.peak
        tree = None
        if self.ring.last:
            ys = [_flatten(self.outs[m]) for m in range(self.M)]
            tree = ys[0][1]([torch.stack(c) for c in zip(*(y for y, _ in ys))])
        self.outs = {}
        self.result, self.result_rebuild = _flatten(
            self.ring.broadcast_last(tree))
        return self.result

    def out_grads(self, grads, m):
        """The last stage's gradients of its output m: from those of the
        stacked results (zeros for one that got none), floats only."""
        return [torch.zeros_like(r[m]) if g is None else g[m]
                for r, g in zip(self.result, grads) if _diff(r)]

    def backward(self, grads):
        self.back_ticks(grads)
        res, j = [], 0
        for t in self.leaves:
            if _diff(t):
                if self.ring.first and t.requires_grad:
                    res.append(torch.stack([self.dx[m][j]
                                            for m in range(self.M)]))
                else:
                    res.append(None)
                j += 1
            else:
                res.append(None)
        self.dx = {}
        return res


def _apply(sched):
    outs = _Schedule.apply(sched, torch.empty(0, requires_grad=True),
                           *sched.leaves)
    return sched.result_rebuild(list(outs))


def pipeline_spmd(stage_fn, inputs_mb, *, group=None, remat=True,
                  double_buffer=False):
    """GPipe / FThenB over the pp group `group`: the last stage's outputs,
    each leaf stacked [M, ...], on every rank; differentiable (see the
    module docstring). `remat` keeps only each stage's inputs and runs the
    stage again in the backward; without it each microbatch's graph is
    kept. `double_buffer` is accepted and changes nothing."""
    return _apply(_GPipe(stage_fn, _Ring(group), inputs_mb, remat))


class _GPipe(_Ticks):
    name = "gpipe"

    def __init__(self, stage_fn, ring, inputs_mb, remat):
        super().__init__(ring, inputs_mb, remat)
        self.stage_fn = stage_fn

    def fn(self, m, x):
        return self.stage_fn(x, m)

    def ticks(self):
        ring, M, S, s = self.ring, self.M, self.ring.S, self.ring.s
        got = None
        for t in range(M + S - 1):
            m, y = t - s, None
            if 0 <= m < M:
                y = self.step(m, self.input(m) if ring.first
                              else self.received(got))
                if ring.last:
                    self.outs[m] = y
            # the previous stage runs microbatch m + 1 this tick
            got = ring.comm(send_next=None if ring.last else y,
                            recv_prev=not ring.first and 0 <= m + 1 < M)[0]

    def back_ticks(self, grads):
        ring, M, S, s = self.ring, self.M, self.ring.S, self.ring.s
        got = None
        for t in range(M + S - 1):
            m, dx = t - (S - 1 - s), None
            if 0 <= m < M:
                dx = self.back(m, self.out_grads(grads, m) if ring.last
                               else got)
                if ring.first:
                    self.dx[m] = dx
            # the next stage runs the backward of microbatch m + 1 this tick
            recv = self.out_like if not ring.last and 0 <= m + 1 < M else None
            got = ring.comm(send_prev=None if ring.first else dx,
                            recv_next=recv)[1]


def pipeline_interleaved(stage_fn, inputs_mb, *, group=None, num_chunks,
                         remat=True, double_buffer=False):
    """The interleaved (VPP) schedule over the pp group `group`:
    `stage_fn(v, x, m)` runs chunk v of this stage (virtual stage
    v * S + s); the last chunk's outputs, stacked [M, ...], on every rank;
    differentiable. Needs M >= S (the reference's bound: a microbatch back
    from the last stage must find stage 0 done with its chunk); an explicit
    `double_buffer=True` needs M >= 2S - 1, as the reference's does, and
    changes nothing else."""
    ring = _Ring(group)
    M = _flatten(inputs_mb)[0][0].shape[0]
    if double_buffer and M < 2 * ring.S - 1:
        raise ValueError(f"double-buffered interleaved schedule needs "
                         f"microbatches >= 2*pp-1 ({M} < {2 * ring.S - 1})")
    if M < ring.S:
        raise ValueError(f"interleaved schedule needs microbatches >= pp "
                         f"degree ({M} < {ring.S})")
    return _apply(_Interleaved(stage_fn, ring, inputs_mb, remat, num_chunks))


class _Interleaved(_Ticks):
    """Stage s runs schedule index r = v * M + m at tick r + s, for
    T = V M + S - 1 ticks. What the last stage sends for chunk v < V - 1
    wraps to stage 0, which keeps it until its chunk v + 1 runs m; in the
    backward the gradient of it comes back the same way."""

    name = "vpp"

    def __init__(self, stage_fn, ring, inputs_mb, remat, V):
        super().__init__(ring, inputs_mb, remat)
        self.stage_fn, self.V = stage_fn, V

    def fn(self, key, x):
        v, m = key
        return self.stage_fn(v, x, m)

    def ticks(self):
        ring, M, V, S, s = self.ring, self.M, self.V, self.ring.S, self.ring.s
        wrap, got = {}, None
        for t in range(V * M + S - 1):
            r, y, v = t - s, None, None
            if 0 <= r < V * M:
                v, m = divmod(r, M)
                if not ring.first:
                    x = self.received(got)
                elif v == 0:
                    x = self.input(m)
                else:
                    x = self.received(wrap.pop((v, m)))
                y = self.step((v, m), x)
                if ring.last and v == V - 1:
                    self.outs[m] = y
                    y = None
            # the previous stage on the ring ran index a this tick
            a = t - (s - 1 if not ring.first else S - 1)
            recv = (0 <= a < (V - 1) * M) if ring.first else (0 <= a < V * M)
            got = ring.comm(send_next=y, recv_prev=recv)[0]
            if ring.first and recv:
                wrap[(a // M + 1, a % M)] = got

    def back_ticks(self, grads):
        ring, M, V, S, s = self.ring, self.M, self.V, self.ring.S, self.ring.s
        T = V * M + S - 1
        wrap, got = {}, None
        for tb in range(T):
            t = T - 1 - tb
            r, dx = t - s, None
            if 0 <= r < V * M:
                v, m = divmod(r, M)
                if ring.last and v == V - 1:
                    g = self.out_grads(grads, m)
                elif ring.last:
                    g = wrap.pop((v, m))
                else:
                    g = got
                dx = self.back((v, m), g)
                if ring.first and v == 0:
                    self.dx[m] = dx
                    dx = None
            # the next stage on the ring ran the backward of index b
            b = t - (s + 1 if not ring.last else 0)
            recv = (M <= b < V * M) if ring.last else (0 <= b < V * M)
            got = ring.comm(send_prev=dx,
                            recv_next=self.out_like if recv else None)[1]
            if ring.last and recv:
                wrap[(b // M - 1, b % M)] = got


# -- 1F1B ------------------------------------------------------------------------ #

def pipeline_1f1b(stage_fn, loss_fn, inputs_mb, *, group=None):
    """The 1F1B schedule over the pp group `group` (see the module
    docstring): every microbatch's forward and backward, the gradients
    left in the parameters' `.grad` (and in `inputs_mb` where it needs
    one). Returns the mean of `loss_fn(y, m)` over the M microbatches, a
    0-d f32 tensor broadcast from the last stage to every rank."""
    ring = _Ring(group)
    leaves, rebuild = _flatten(inputs_mb)
    M, S, s = leaves[0].shape[0], ring.S, ring.s
    warm = min(S - s - 1, M)
    kept, peak, like = deque(), 0, []
    lsum, mf = None, 0

    def input_m(m):
        return rebuild([t[m] for t in leaves])

    def forward(x):
        nonlocal mf, peak, lsum
        m, mf = mf, mf + 1
        with torch.no_grad():
            y = stage_fn(input_m(m) if ring.first else x, m)
        g = None
        if ring.last:
            ys, yr = _flatten(y)
            yd = [t.detach().requires_grad_(_diff(t)) for t in ys]
            with torch.enable_grad():
                loss = loss_fn(yr(yd), m).float()
            torch.autograd.backward(loss / M)
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
            g = _grads_of(yd)
        elif not like:
            like.extend(_like(_flatten(y)[0]))
        kept.append((m, None if ring.first else _flatten(x), g))
        peak = max(peak, len(kept))
        return None if ring.last else y

    def backward(g_next):
        m, x, g = kept.popleft()
        with torch.enable_grad():
            if ring.first:
                xs, y = None, stage_fn(input_m(m), m)
            else:
                xs = [t.detach().requires_grad_(_diff(t)) for t in x[0]]
                y = stage_fn(x[1](xs), m)
            _backward(_flatten(y)[0], g if ring.last else g_next)
        return None if ring.first else _grads_of(xs)

    def recv_forward():
        return None if ring.first else ring.comm(recv_prev=True)[0]

    for _ in range(warm):
        ring.comm(send_next=forward(recv_forward()))
    x = recv_forward() if M > warm else None
    for i in range(M - warm):
        y = forward(x)
        g = ring.comm(send_next=y, recv_next=None if ring.last else like)[1]
        dx = backward(g)
        last_step = i == M - warm - 1
        x = ring.comm(send_prev=dx,
                      recv_prev=not ring.first and not last_step)[0]
    for _ in range(warm):
        g = ring.comm(recv_next=like)[1]
        ring.comm(send_prev=backward(g))
    IN_FLIGHT["1f1b"] = peak
    return ring.broadcast_last(lsum / M if ring.last else None,
                               like=[((), torch.float32)])
