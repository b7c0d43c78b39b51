"""Optimizers (↔ paddle_tpu/optimizer/optimizer.py): `Optimizer`, `SGD`,
`Momentum`, `Adam`, `AdamW`, `Adamax`, `Adagrad`, `Adadelta`, `RMSProp`,
`Lamb`, `Lars`, `NAdam`, `RAdam`, `Rprop` and `ASGD` (`LBFGS` is in
`optimizer/lbfgs.py`).

As in the JAX package, each optimizer defines a pure update rule,
`init_state(p)` and `update(p, g, state, lr, ctx) -> (new_p, new_state)`,
on tensors; `step()` walks the parameters and applies it, and
`jit.TrainStep` applies the same rule. The parameters are updated in place
(the JAX package swaps in fresh arrays).

With `multi_precision` a bf16/f16 parameter keeps an f32 master copy in its
state and the rule runs on the master. Adam's `moment_dtype` stores m and v
in a low-precision type (e.g. "bfloat16"); the update itself always
computes in f32 and stores each tensor back in its own dtype.

The state is keyed by the parameter's id (`_states`), as in the JAX
package; a `TrainStep` also records the parameters by name (`_names`),
which is how `convert.load_paddle_tpu_opt_state` finds the state of a
named parameter.

`grad_clip` takes the clip classes of `nn.clip`: `step()` applies it to
the (parameter, gradient) pairs it updates, and `jit.TrainStep` applies the
global-norm clip over every gradient, as the JAX step does.

`learning_rate` is a float or a scheduler of `optimizer.lr`, read through
`get_lr()` on every step (eager or `TrainStep`); `set_lr` and
`set_lr_scheduler` as the reference's (:47-62).

The weight decay of a parameter is `_param_decay(name, p)`: the
optimizer's coefficient; 0 for a parameter with its own regularizer
(`ParamAttr(regularizer=...)`, whose term `step()` adds to the gradient
before the clip and which replaces the coefficient, as the reference's
`append_regularization_ops` order, :93-114); or, for an `AdamW` with
`apply_decay_param_fun`, 0 where the function, called with the
parameter's name, says no. `weight_decay` itself takes a float: a
regularizer given there raises a TypeError naming `ParamAttr` (the
reference accepts it and fails at its first step, ROADMAP queue C). A
parameter's rate is the optimizer's times its
`optimize_attr["learning_rate"]` (`_param_lr`, :130), on `step()` and on
the steps of `jit.TrainStep`, whose reference ignores the factor (ROADMAP
queue C). The name
is the parameter's `state_dict` name where the optimizer knows it (a
`TrainStep` records the names, and `parameters` may be given as
`model.named_parameters()` pairs), else "" (the reference's eager step
reads `p.name`, which its layers leave None). The port honours the filter
on both routes; the reference's compiled step applies one coefficient to
every parameter (ROADMAP queue C).

Lamb's trust ratio and Lars's local rate read norms of the whole
parameter (`whole_norms`). The rule computes the squared sums of the piece
it updates and hands them to `_sq_norms`: a step that updates pieces of a
parameter (a ZeRO shard, an mp-cut parameter) passes `ctx["sum_norms"]`,
which sums them over the ranks that hold the other pieces; a step that
updates offload slices sums them first (`norm_parts`, a pass that writes
nothing) and passes the whole parameter's in `ctx["sq_norms"]`; with
neither the rule takes the norms of what it was given.

A rank of a sharded `DistributedTrainStep` keeps state only for its shard
of a parameter: `apply_update(p, g, lr, ctx, target)` updates `target` (a
shard of p, or p itself) and keys the state, shaped like `target`, by p.
"""

from __future__ import annotations

import torch

from .lr import LRScheduler

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "Lamb",
           "Lars", "Momentum", "NAdam", "Optimizer", "RAdam", "RMSProp",
           "Rprop", "SGD"]

_LOW = (torch.bfloat16, torch.float16)


def _regularizer(p):
    return p.__dict__.get("regularizer")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if grad_clip is not None and not callable(grad_clip):
            raise TypeError("grad_clip takes a clip of nn.clip (e.g. "
                            "ClipGradByGlobalNorm)")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError("learning_rate takes a float or a scheduler of "
                            "optimizer.lr")
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
        self._names: dict = {}    # name -> parameter
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], tuple):
                # model.named_parameters(): the names come along
                self._names = dict(parameters)
                parameters = [p for _, p in parameters]
        self._parameter_list = parameters
        if hasattr(weight_decay, "add_to"):
            raise TypeError(
                f"weight_decay takes a float, not {type(weight_decay).__name__}"
                "; a regularizer goes on a parameter through "
                "ParamAttr(regularizer=...)")
        self._weight_decay = 0.0 if weight_decay is None else float(weight_decay)
        self._multi_precision = multi_precision
        self._grad_clip = grad_clip
        self._states: dict = {}   # id(parameter) -> state dict
        self._step_count = 0

    def get_lr(self):
        """The rate of the next step: the scheduler's current one, if any."""
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return self._lr

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("set_lr cannot be used with an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    def _decay_coeff(self):
        return self._weight_decay

    def _param_decay(self, name, p):
        """The weight decay of parameter p named `name` (module
        docstring)."""
        return 0.0 if _regularizer(p) is not None else self._decay_coeff()

    @staticmethod
    def _param_lr(lr, p):
        """The rate of parameter p: `lr` times its learning-rate factor."""
        attr = p.__dict__.get("_optimize_attr")
        return lr if attr is None else lr * attr.get("learning_rate", 1.0)

    @staticmethod
    def _regularized(params_grads):
        """(p, g) pairs with each parameter's regularizer term added to its
        gradient (before the clip)."""
        return [(p, g if _regularizer(p) is None
                 else _regularizer(p).add_to(g, p))
                for p, g in params_grads]

    # rules that read norms of the whole parameter (Lamb, Lars) set this
    whole_norms = False

    def norm_parts(self, t, g, st, ctx):
        """The squared sums (f32, 1-d) a `whole_norms` rule's norms take
        over the piece t of a parameter, from the inputs `apply_rule` would
        give the rule, leaving the state as it is."""
        raise NotImplementedError

    @staticmethod
    def _sq_norms(parts, ctx):
        """The whole parameter's squared sums from those of this piece,
        `parts` (module docstring)."""
        if "sq_norms" in ctx:
            return ctx["sq_norms"]
        total = ctx.get("sum_norms")
        return parts if total is None else total(parts)

    def init_state(self, p):
        return {}

    def update(self, p, g, state, lr, ctx):
        raise NotImplementedError

    def _params(self):
        if self._parameter_list is None:
            raise ValueError("optimizer constructed without parameters")
        return self._parameter_list

    def _get_state(self, p, target=None):
        st = self._states.get(id(p))
        if st is None:
            t = p if target is None else target
            st = self.init_state(t)
            if self._multi_precision and t.dtype in _LOW:
                st["master"] = t.detach().float()
            self._states[id(p)] = st
        return st

    @torch.no_grad()
    def apply_update(self, p, g, lr, ctx, target=None):
        """One step of the rule on parameter p (or on `target`, the shard of
        p this rank updates) with gradient g (None reads as zeros), in
        place; the master copy takes the f32 result."""
        t = p if target is None else target
        self.apply_rule(t, g, self._get_state(p, t), lr, ctx)

    @staticmethod
    def _rule_inputs(t, g, st):
        master = st.get("master")
        pv = master if master is not None else t.detach()
        gv = torch.zeros_like(pv) if g is None else g.to(pv.dtype)
        return pv, gv, {k: v for k, v in st.items() if k != "master"}

    @torch.no_grad()
    def apply_rule(self, t, g, st, lr, ctx):
        """The rule on tensor t with state st (tensors shaped like t, all
        written in place): a whole parameter, a shard or a slice of one."""
        master = st.get("master")
        pv, gv, rule_state = self._rule_inputs(t, g, st)
        new_p, new_st = self.update(pv, gv, rule_state, lr, ctx)
        if master is not None:
            master.copy_(new_p)
        t.copy_(new_p)
        for k, v in new_st.items():
            st[k].copy_(v)

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient (eager Paddle step),
        the gradients clipped by `grad_clip` first."""
        self._step_count += 1
        pairs = self._regularized([(p, p.grad) for p in self._params()
                                   if p.requires_grad and p.grad is not None])
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        lr = self.get_lr()
        names = {id(q): k for k, q in self._names.items()}
        for p, g in pairs:
            ctx = {"step": self._step_count, "weight_decay":
                   self._param_decay(names.get(id(p), ""), p)}
            self.apply_update(p, g, self._param_lr(lr, p), ctx)

    def clear_grad(self, set_to_zero=True):
        for p in self._params():
            p.grad = None


class SGD(Optimizer):
    """p <- p - lr * (g + weight_decay * p) (reference :194)."""

    def update(self, p, g, state, lr, ctx):
        wd = ctx["weight_decay"]
        if wd:
            g = g + wd * p
        return p - lr * g, state


class Momentum(Optimizer):
    """v <- momentum * v + g (g with L2 `weight_decay` * p added), then
    p <- p - lr * v, or p - lr * (g + momentum * v) with `use_nesterov`
    (reference :206-226). The velocity is stored in f32 for a bf16/f16
    parameter; the rule computes in the gradient's dtype, its scalars
    rounded to it, as the reference's, and stores the result into the
    velocity's."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, p):
        dt = torch.float32 if p.dtype in _LOW else p.dtype
        return {"velocity": torch.zeros_like(
            p, dtype=dt, memory_format=torch.contiguous_format)}

    def update(self, p, g, state, lr, ctx):
        # the reference's Python scalars enter its jnp arithmetic in the
        # gradient's dtype (weak typing): round them so here too
        def s(x):
            return torch.tensor(x, dtype=g.dtype).item()

        wd, mu = ctx["weight_decay"], s(self._momentum)
        if wd:
            g = g + s(wd) * p
        v = mu * state["velocity"].to(g.dtype) + g
        upd = g + mu * v if self._nesterov else v
        return p - s(lr) * upd, {"velocity": v}


class Adam(Optimizer):
    """Adam with L2 weight decay folded into the gradient; AdamW decouples
    it. `moment_dtype`: storage type of m and v (default: f32 for bf16/f16
    parameters, else the parameter's type)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._decoupled = False
        self._moment_dtype = (_DTYPES[moment_dtype]
                              if isinstance(moment_dtype, str) else moment_dtype)

    def init_state(self, p):
        if self._moment_dtype is not None:
            mdt = self._moment_dtype
        else:
            mdt = torch.float32 if p.dtype in _LOW else p.dtype
        return {"m": torch.zeros_like(p, dtype=mdt, memory_format=torch.contiguous_format),
                "v": torch.zeros_like(p, dtype=mdt, memory_format=torch.contiguous_format)}

    def update(self, p, g, state, lr, ctx):
        """The JAX rule `Adam.update` (optimizer.py:254-273): computes in f32
        and stores back in each tensor's own dtype."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        t = ctx["step"]
        wd = ctx["weight_decay"]
        m_dt, v_dt, p_dt = state["m"].dtype, state["v"].dtype, p.dtype
        p32 = p.float()
        g32 = g.float()
        if wd and not self._decoupled:
            g32 = g32 + wd * p32
        m = b1 * state["m"].float() + (1 - b1) * g32
        v = b2 * state["v"].float() + (1 - b2) * g32.square()
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        upd = mhat / (vhat.sqrt() + eps)
        if wd and self._decoupled:
            upd = upd + wd * p32
        return ((p32 - lr * upd).to(p_dt),
                {"m": m.to(m_dt), "v": v.to(v_dt)})


def _accepted_and_ignored(cls, option, value):
    """An option the reference accepts and never reads: the port takes
    None only (ROADMAP queue C)."""
    if value is not None:
        raise NotImplementedError(
            f"{cls} {option}: the reference accepts it and applies nothing "
            f"(ROADMAP queue C); the port takes None only")


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01), on the parameters
    `apply_decay_param_fun(name)` accepts (all without it; module
    docstring)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, moment_dtype=None,
                 name=None):
        _accepted_and_ignored("AdamW", "lr_ratio", lr_ratio)
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         moment_dtype=moment_dtype, name=name)
        self._decoupled = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _param_decay(self, name, p):
        fn = self._apply_decay_param_fun
        if fn is not None and not fn(name):
            return 0.0
        return super()._param_decay(name, p)


def _zeros(p, dtype=None):
    return torch.zeros_like(p, dtype=dtype,
                           memory_format=torch.contiguous_format)


class Adamax(Optimizer):
    """Adam with the infinity norm (↔ :314): u <- max(b2 u, |g|), p <- p -
    lr / (1 - b1^t) * m / (u + eps); L2 decay folded into g."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_state(self, p):
        return {"m": _zeros(p), "u": _zeros(p)}

    def update(self, p, g, state, lr, ctx):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        wd = ctx["weight_decay"]
        if wd:
            g = g + wd * p
        m = b1 * state["m"] + (1 - b1) * g
        u = torch.maximum(b2 * state["u"], g.abs())
        return (p - lr / (1 - b1 ** ctx["step"]) * m / (u + eps),
                {"m": m, "u": u})


class Adagrad(Optimizer):
    """moment <- moment + g^2, p <- p - lr * g / (sqrt(moment) + eps)
    (↔ :335)."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, p):
        return {"moment": _zeros(p).fill_(self._init_acc)}

    def update(self, p, g, state, lr, ctx):
        wd = ctx["weight_decay"]
        if wd:
            g = g + wd * p
        mom = state["moment"] + g.square()
        return p - lr * g / (mom.sqrt() + self._epsilon), {"moment": mom}


class Adadelta(Optimizer):
    """The running averages of g^2 and of the update's square set the step
    (↔ :353)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._epsilon, self._rho = epsilon, rho

    def init_state(self, p):
        return {"avg_sq_grad": _zeros(p), "avg_sq_update": _zeros(p)}

    def update(self, p, g, state, lr, ctx):
        wd = ctx["weight_decay"]
        if wd:
            g = g + wd * p
        eps, rho = self._epsilon, self._rho
        asg = rho * state["avg_sq_grad"] + (1 - rho) * g.square()
        upd = (state["avg_sq_update"] + eps).sqrt() / (asg + eps).sqrt() * g
        asu = rho * state["avg_sq_update"] + (1 - rho) * upd.square()
        return p - lr * upd, {"avg_sq_grad": asg, "avg_sq_update": asu}


class RMSProp(Optimizer):
    """g scaled by the root of the running mean of g^2 (centred on the
    running mean of g with `centered`), through a momentum velocity
    (↔ :372)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, p):
        st = {"mean_square": _zeros(p), "velocity": _zeros(p)}
        if self._centered:
            st["mean_grad"] = _zeros(p)
        return st

    def update(self, p, g, state, lr, ctx):
        wd = ctx["weight_decay"]
        if wd:
            g = g + wd * p
        rho, eps = self._rho, self._epsilon
        ms = rho * state["mean_square"] + (1 - rho) * g.square()
        new_state = {"mean_square": ms}
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = (ms - mg.square() + eps).sqrt()
            new_state["mean_grad"] = mg
        else:
            denom = (ms + eps).sqrt()
        v = self._momentum * state["velocity"] + lr * g / denom
        new_state["velocity"] = v
        return p - v, new_state


def _sq_parts(a, b):
    return torch.stack([a.float().square().sum(), b.float().square().sum()])


def _ratio(num_sq, den_sq):
    """sqrt(num_sq) / sqrt(den_sq) where both are above 0, else 1 (the
    trust ratio of Lamb)."""
    w, r = num_sq.sqrt(), den_sq.sqrt()
    return torch.where((w > 0) & (r > 0), w / r, torch.ones_like(w))


class Lamb(Optimizer):
    """AdamW's step r = m^ / (sqrt(v^) + eps) + wd p scaled by the layer's
    trust ratio ||p|| / ||r|| over the whole parameter (↔ :402; module
    docstring, `whole_norms`). m and v are f32 for a bf16/f16 parameter.
    `exclude_from_weight_decay_fn` takes None only (ROADMAP queue C)."""

    whole_norms = True

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        _accepted_and_ignored("Lamb", "exclude_from_weight_decay_fn",
                              exclude_from_weight_decay_fn)
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_state(self, p):
        dt = torch.float32 if p.dtype in _LOW else p.dtype
        return {"m": _zeros(p, dt), "v": _zeros(p, dt)}

    def _step_dir(self, p, g, state, ctx):
        b1, b2, t = self._beta1, self._beta2, ctx["step"]
        m = b1 * state["m"] + (1 - b1) * g
        v = b2 * state["v"] + (1 - b2) * g.square()
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        return m, v, mhat / (vhat.sqrt() + self._epsilon) + \
            ctx["weight_decay"] * p

    def norm_parts(self, t, g, st, ctx):
        p, g, state = self._rule_inputs(t, g, st)
        return _sq_parts(p, self._step_dir(p, g, state, ctx)[2])

    def update(self, p, g, state, lr, ctx):
        m, v, r = self._step_dir(p, g, state, ctx)
        w_sq, r_sq = self._sq_norms(_sq_parts(p, r), ctx)
        trust = _ratio(w_sq, r_sq).to(p.dtype)
        return p - lr * trust * r, {"m": m, "v": v}


class Lars(Momentum):
    """Momentum with the layer-wise rate coeff * ||p|| / (||g|| + wd ||p||)
    over the whole parameter (↔ :432; `whole_norms`).
    `exclude_from_weight_decay` takes None only (ROADMAP queue C)."""

    whole_norms = True

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, multi_precision=False,
                 name=None):
        _accepted_and_ignored("Lars", "exclude_from_weight_decay",
                              exclude_from_weight_decay)
        super().__init__(learning_rate, momentum, parameters,
                         weight_decay=lars_weight_decay, grad_clip=grad_clip,
                         multi_precision=multi_precision, name=name)
        self._lars_coeff = lars_coeff

    def norm_parts(self, t, g, st, ctx):
        p, g, _ = self._rule_inputs(t, g, st)
        return _sq_parts(p, g)

    def update(self, p, g, state, lr, ctx):
        wd = ctx["weight_decay"]
        w_sq, g_sq = self._sq_norms(_sq_parts(p, g), ctx)
        w, gn = w_sq.sqrt(), g_sq.sqrt()
        local_lr = torch.where((w > 0) & (gn > 0),
                               self._lars_coeff * w / (gn + wd * w + 1e-12),
                               torch.ones_like(w)).to(g.dtype)
        g = g + wd * p
        v = self._momentum * state["velocity"].to(g.dtype) + local_lr * g
        return p - lr * v, {"velocity": v}


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


class NAdam(Optimizer):
    """Adam with Nesterov momentum and the momentum decay schedule
    mu_t = b1 (1 - 0.96^(t psi) / 2) (↔ :453), its product kept in the
    state (`mu_prod`, f32 0-d)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay

    def init_state(self, p):
        return {"m": _zeros(p), "v": _zeros(p),
                "mu_prod": torch.ones((), dtype=torch.float32,
                                      device=p.device)}

    def update(self, p, g, state, lr, ctx):
        b1, b2, eps, psi = self._beta1, self._beta2, self._epsilon, self._psi
        t = _f32(ctx["step"], p)
        wd = ctx["weight_decay"]
        if wd:
            g = g + wd * p
        mu_t = b1 * (1 - 0.5 * torch.pow(0.96, t * psi))
        mu_next = b1 * (1 - 0.5 * torch.pow(0.96, (t + 1) * psi))
        mu_prod = state["mu_prod"] * mu_t
        m = b1 * state["m"] + (1 - b1) * g
        v = b2 * state["v"] + (1 - b2) * g * g
        m_hat = (mu_next * m / (1 - mu_prod * mu_next)
                 + (1 - mu_t) * g / (1 - mu_prod))
        v_hat = v / (1 - torch.pow(b2, t))
        return (p - lr * m_hat / (v_hat.sqrt() + eps),
                {"m": m, "v": v, "mu_prod": mu_prod})


class RAdam(Optimizer):
    """Adam with the variance rectification of Liu et al. while the
    approximated SMA length rho_t is above 5, SGD with momentum before
    (↔ :491)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_state(self, p):
        return {"m": _zeros(p), "v": _zeros(p)}

    def update(self, p, g, state, lr, ctx):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        t = _f32(ctx["step"], p)
        wd = ctx["weight_decay"]
        if wd:
            g = g + wd * p
        m = b1 * state["m"] + (1 - b1) * g
        v = b2 * state["v"] + (1 - b2) * g * g
        b1t, b2t = torch.pow(b1, t), torch.pow(b2, t)
        m_hat = m / (1 - b1t)
        rho_inf = 2.0 / (1 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * b2t / (1 - b2t)
        r_num = (rho_t - 4) * (rho_t - 2) * rho_inf
        r_den = (rho_inf - 4) * (rho_inf - 2) * rho_t
        rect = (r_num / r_den).clamp(min=0.0).sqrt()
        v_hat = (v / (1 - b2t)).sqrt()
        adaptive = rect * m_hat / (v_hat + eps)
        return (p - lr * torch.where(rho_t > 5.0, adaptive, m_hat),
                {"m": m, "v": v})


class Rprop(Optimizer):
    """Resilient propagation (↔ :531): each element's step grows by
    etas[1] while its gradient keeps its sign, shrinks by etas[0] when it
    flips (and that element then skips its update), clipped to
    `learning_rate_range`; p moves by the step times sign(g). A full-batch
    method, without weight decay."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         name=name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def init_state(self, p):
        return {"prev_g": _zeros(p), "step_size": _zeros(p).fill_(self.get_lr())}

    def update(self, p, g, state, lr, ctx):
        sign = (g * state["prev_g"]).sign()
        factor = torch.where(sign > 0, self._eta_pos,
                             torch.where(sign < 0, self._eta_neg, 1.0))
        step = (state["step_size"] * factor.to(p.dtype)).clamp(
            self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g)
        return p - step * g_eff.sign(), {"prev_g": g_eff, "step_size": step}


class ASGD(Optimizer):
    """Averaged SGD (↔ :554): p moves by lr / n times the sum d of the last
    n = `batch_num` gradients, kept in a ring `ys` [n, *p.shape] (written
    in place) with its slot counter `idx` (int32 0-d)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision, name=name)
        self._n = max(int(batch_num), 1)

    def init_state(self, p):
        # under multi_precision the rule runs on the f32 master, so the
        # gradient history is f32 too
        dt = (torch.float32 if self._multi_precision and p.dtype in _LOW
              else p.dtype)
        return {"d": _zeros(p, dt),
                "ys": torch.zeros((self._n, *p.shape), dtype=dt,
                                  device=p.device),
                "idx": torch.zeros((), dtype=torch.int32, device=p.device)}

    def update(self, p, g, state, lr, ctx):
        wd = ctx["weight_decay"]
        if wd:
            g = g + wd * p
        ys = state["ys"]
        g = g.to(ys.dtype)
        i = (state["idx"] % self._n).reshape(1).long()
        d = state["d"] - ys.index_select(0, i)[0] + g
        ys.index_copy_(0, i, g[None])
        return p - lr / self._n * d, {"d": d, "ys": ys,
                                      "idx": state["idx"] + 1}
