"""Incubate optimizers (↔ paddle_tpu/incubate/optimizer/__init__.py):
`LookAhead` and `ModelAverage`, over the port's eager optimizers.

`LookAhead(inner, alpha, k)` steps `inner` and every k-th step moves the
slow weights alpha of the way to the fast ones and resets the fast
weights to them (Zhang et al. 2019); the slow weights are snapshotted at
the first step. `ModelAverage(rate, parameters, min_average_window,
max_average_window)` sums the parameters after each `step()` over a
trailing window of min(max_window, max(min_window, int(updates * rate)))
steps, restarting the sum when it grows past it; `apply()` swaps the
average in (rounded to each parameter's dtype) and `restore()` (or
leaving its `with` block) swaps the weights back. Both update the
parameters in place, where the reference swaps in fresh arrays.

The port's optimizers keep no `state_dict` (their state travels through
`convert.load_paddle_tpu_opt_state`), so `LookAhead.state_dict()` holds
LookAhead's own state, the step count and the slow weights, under the
reference's keys.
"""

from __future__ import annotations

import torch

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead:
    """The reference's LookAhead (:21): k fast steps of `inner_optimizer`,
    then slow <- slow + alpha (fast - slow) and fast <- slow."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_count = 0
        self._slow = None  # id(parameter) -> its slow weights

    def __getattr__(self, name):
        return getattr(self.__dict__["inner_optimizer"], name)

    def _params(self):
        return self.inner_optimizer._parameter_list or []

    @torch.no_grad()
    def step(self):
        params = self._params()
        if self._slow is None:
            self._slow = {id(p): p.detach().clone() for p in params}
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for p in params:
                slow = self._slow.setdefault(id(p), p.detach().clone())
                slow.add_(p.detach() - slow, alpha=self.alpha)
                p.copy_(slow)

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()

    def state_dict(self):
        sd = {"@lookahead_step": self._step_count}
        if self._slow is not None:
            sd["@lookahead_slow"] = [self._slow[id(p)].clone()
                                     for p in self._params()]
        return sd

    def set_state_dict(self, state):
        state = dict(state)
        self._step_count = int(state.pop("@lookahead_step", 0))
        slow = state.pop("@lookahead_slow", None)
        if slow is not None:
            self._slow = {id(p): torch.as_tensor(v).to(p.device, p.dtype)
                          for p, v in zip(self._params(), slow)}


class ModelAverage:
    """The reference's ModelAverage (:87): a running sum of the parameters
    over a trailing window, swapped in by `apply()` for evaluation."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._params = list(parameters or [])
        self._sum = {id(p): torch.zeros_like(p) for p in self._params}
        self._num = 0
        self._updates = 0
        self._backup = None
        self._need_restore = True

    @torch.no_grad()
    def step(self):
        """Add the current parameters to the sum (after the optimizer's
        step); past the window the sum restarts from them."""
        self._updates += 1
        self._num += 1
        window = min(self.max_average_window,
                     max(self.min_average_window,
                         int(self._updates * self.average_window)))
        restart = self._num > window
        for p in self._params:
            if restart:
                self._sum[id(p)] = p.detach().clone()
            else:
                self._sum[id(p)] = self._sum[id(p)] + p.detach()
        if restart:
            self._num = 1

    def clear_grad(self, set_to_zero=True):
        for p in self._params:
            p.grad = None

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Swap the averaged weights in; usable as a context manager."""
        if self._num == 0:
            return self
        self._backup = {id(p): p.detach().clone() for p in self._params}
        for p in self._params:
            p.copy_((self._sum[id(p)] / self._num).to(p.dtype))
        self._need_restore = need_restore
        return self

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._params:
            p.copy_(self._backup[id(p)])
        self._backup = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._need_restore:
            self.restore()
        return False
