"""Optimizers (↔ paddle_tpu/optimizer/optimizer.py): `Optimizer`, `Adam`,
`AdamW`.

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
global-norm clip over every gradient, as the JAX step does. Not ported
yet: learning-rate schedulers (optimizer/lr.py) raise NotImplementedError
(ROADMAP queue A item 4).

A rank of a sharded `DistributedTrainStep` keeps state only for its shard
of a parameter: `apply_update(p, g, lr, ctx, target)` updates `target` (a
shard of p, or p itself) and keys the state, shaped like `target`, by p.
"""

from __future__ import annotations

import torch

__all__ = ["Adam", "AdamW", "Optimizer"]

_LOW = (torch.bfloat16, torch.float16)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if grad_clip is not None and not callable(grad_clip):
            raise TypeError("grad_clip takes a clip of nn.clip (e.g. "
                            "ClipGradByGlobalNorm)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers (optimizer/lr.py) are ported with "
                "ROADMAP queue A item 4; pass a float")
        self._lr = float(learning_rate)
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = 0.0 if weight_decay is None else float(weight_decay)
        self._multi_precision = multi_precision
        self._grad_clip = grad_clip
        self._states: dict = {}   # id(parameter) -> state dict
        self._names: dict = {}    # name -> parameter, recorded by TrainStep
        self._step_count = 0

    def get_lr(self):
        return self._lr

    def _decay_coeff(self):
        return self._weight_decay

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

    @torch.no_grad()
    def apply_rule(self, t, g, st, lr, ctx):
        """The rule on tensor t with state st (tensors shaped like t, all
        written in place): a whole parameter, a shard or a slice of one."""
        master = st.get("master")
        pv = master if master is not None else t.detach()
        gv = torch.zeros_like(pv) if g is None else g.to(pv.dtype)
        rule_state = {k: v for k, v in st.items() if k != "master"}
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
        ctx = {"step": self._step_count, "weight_decay": self._decay_coeff()}
        pairs = [(p, p.grad) for p in self._params()
                 if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        for p, g in pairs:
            self.apply_update(p, g, self._lr, ctx)

    def clear_grad(self, set_to_zero=True):
        for p in self._params():
            p.grad = None


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


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, moment_dtype=None,
                 name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW lr_ratio / apply_decay_param_fun are ported with "
                "ROADMAP queue A item 4")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         moment_dtype=moment_dtype, name=name)
        self._decoupled = True
