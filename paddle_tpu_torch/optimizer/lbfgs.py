"""L-BFGS (↔ paddle_tpu/optimizer/lbfgs.py): a closure-driven `step()`, the
two-loop recursion over the last `history_size` (s, y) pairs, and a
bracketing strong-Wolfe line search (`line_search_fn="strong_wolfe"`) or
a fixed step. It is eager by design, as in the reference: each line-search
iteration calls the closure again and reads the loss on the host. The
flat parameters and gradients are f32 on the parameters' device; an L2
`weight_decay` folds into the objective (its 0.5 wd ||p||^2 value and its
gradient), so that the line search tests f and g of one function.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _dot(a, b):
    return float(torch.dot(a, b))


class LBFGS(Optimizer):
    """Usage, as the reference's:

        def closure():
            opt.clear_grad()
            loss = loss_fn(model(x), y)
            loss.backward()
            return loss

        loss = opt.step(closure)
    """

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        if grad_clip is not None:
            raise ValueError(
                "LBFGS does not support grad_clip: clipping the line-search "
                "gradients breaks the Wolfe conditions")
        super().__init__(learning_rate, parameters, weight_decay, None,
                         name=name)
        self.max_iter = max_iter
        self.max_eval = max_eval or max_iter * 5 // 4
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self.history_size = history_size
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or 'strong_wolfe'")
        self.line_search_fn = line_search_fn
        self._s: list = []   # parameter deltas
        self._y: list = []   # gradient deltas

    def _trainable(self):
        return [p for p in self._params() if p.requires_grad]

    def _flat_grad(self, params):
        wd = self._decay_coeff()
        gs = []
        for p in params:
            g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None \
                else p.grad.float()
            if wd:
                g = g + wd * p.detach().float()
            gs.append(g.reshape(-1))
        return torch.cat(gs)

    @staticmethod
    def _flat_params(params):
        return torch.cat([p.detach().float().reshape(-1) for p in params])

    @staticmethod
    def _set_flat(params, flat):
        off = 0
        for p in params:
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n

    def _direction(self, g):
        """The two-loop recursion over the (s, y) history."""
        q = -g
        alphas = []
        for s, y in reversed(list(zip(self._s, self._y))):
            rho = 1.0 / _dot(y, s)
            a = rho * _dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (_dot(s, y) / _dot(y, y))
        for a, rho, s, y in reversed(alphas):
            b = rho * _dot(y, q)
            q = q + (a - b) * s
        return q

    def _decay_term(self, params):
        wd = self._decay_coeff()
        if not wd:
            return 0.0
        return 0.5 * wd * float(sum(p.detach().float().square().sum()
                                    for p in params))

    @torch.no_grad()
    def step(self, closure):
        """One L-BFGS outer step; `closure` re-evaluates the loss and the
        gradients. Returns the last loss (f32, 0-d, on the host)."""
        params = self._trainable()
        with torch.enable_grad():
            loss = closure()
        loss_val = float(loss) + self._decay_term(params)
        flat_grad = self._flat_grad(params)
        n_evals = 1
        lr = self.get_lr()

        for it in range(self.max_iter):
            if float(flat_grad.abs().max()) <= self.tol_grad:
                break
            d = self._direction(flat_grad)
            gtd = _dot(flat_grad, d)
            if gtd > -1e-16:  # not a descent direction: reset the history
                self._s.clear()
                self._y.clear()
                d = -flat_grad
                gtd = _dot(flat_grad, d)
            t = lr if (self._s or it > 0) else min(
                1.0, 1.0 / max(float(flat_grad.abs().sum()), 1e-12)) * lr
            x0 = self._flat_params(params)

            def eval_at(step_size, x0=x0, d=d):
                self._set_flat(params, x0 + step_size * d)
                with torch.enable_grad():
                    ls = closure()
                return (float(ls) + self._decay_term(params),
                        self._flat_grad(params))

            if self.line_search_fn == "strong_wolfe":
                t, new_loss, new_grad, evals = _strong_wolfe(
                    eval_at, t, loss_val, flat_grad, d, gtd)
                n_evals += evals
            else:
                new_loss, new_grad = eval_at(t)
                n_evals += 1

            s = t * d
            y = new_grad - flat_grad
            if _dot(s, y) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            done = abs(new_loss - loss_val) < self.tol_change
            loss_val, flat_grad = new_loss, new_grad
            if done or n_evals >= self.max_eval:
                break

        self._step_count += 1
        return torch.tensor(loss_val, dtype=torch.float32)


def _strong_wolfe(eval_at, t, f0, g0, d, gtd0, c1=1e-4, c2=0.9, max_ls=10):
    """The bracketing strong-Wolfe line search (↔ lbfgs.py `_strong_wolfe`)."""
    f_prev, t_prev = f0, 0.0
    f_new, g_new = eval_at(t)
    evals = 1
    for i in range(max_ls):
        gtd_new = _dot(g_new, d)
        if f_new > f0 + c1 * t * gtd0 or (i > 0 and f_new >= f_prev):
            return _zoom(eval_at, t_prev, t, f_prev, f_new, f0, gtd0, d,
                         c1, c2, evals)
        if abs(gtd_new) <= -c2 * gtd0:
            return t, f_new, g_new, evals
        if gtd_new >= 0:
            return _zoom(eval_at, t, t_prev, f_new, f_prev, f0, gtd0, d,
                         c1, c2, evals)
        t_prev, f_prev = t, f_new
        t = t * 2.0
        f_new, g_new = eval_at(t)
        evals += 1
    return t, f_new, g_new, evals


def _zoom(eval_at, lo, hi, f_lo, f_hi, f0, gtd0, d, c1, c2, evals,
          max_zoom=10):
    t = lo
    f_new, g_new = f_lo, None
    for _ in range(max_zoom):
        t = 0.5 * (lo + hi)
        f_new, g_new = eval_at(t)
        evals += 1
        if f_new > f0 + c1 * t * gtd0 or f_new >= f_lo:
            hi, f_hi = t, f_new
        else:
            gtd_new = _dot(g_new, d)
            if abs(gtd_new) <= -c2 * gtd0:
                break
            if gtd_new * (hi - lo) >= 0:
                hi, f_hi = lo, f_lo
            lo, f_lo = t, f_new
    if g_new is None:
        f_new, g_new = eval_at(t)
        evals += 1
    return t, f_new, g_new, evals
