"""Full-batch convex solvers of the linear family, batched over candidates.

Counterpart of ``transmogrifai_tpu/models/solvers.py``. Where the JAX
package differentiates a loss with ``jax.grad`` and ``vmap``s one
candidate's solver over a grid, the port's solvers take the gradient (or
value and gradient) as a function of a batch of parameter rows: every
array here has a leading candidate axis ``B`` and the caller writes the
gradient in closed form, one matrix product per direction for all
candidates together.

- :func:`_power_iteration_sq_norm` / :func:`design_lipschitz`: the
  Lipschitz bound of a weighted design, 16 fixed power steps;
- :func:`fista_minimize`: proximal gradient with Nesterov momentum, the
  JAX package's fixed-trip ``fori_loop`` (``tol <= 0``) or its
  ``while_loop`` (``tol > 0``) as a predicated loop that freezes each
  candidate at its own stopping iteration;
- :func:`lbfgs_minimize`: optax's ``lbfgs()`` (memory 10, scaled initial
  preconditioner, zoom line search of at most 20 steps starting from a
  step of 1) transcribed step for step, for one candidate. The line
  search's scalar logic runs on the host, one read-back per trial step.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["design_lipschitz", "fista_minimize", "lbfgs_minimize"]

#: FISTA with tol > 0 reads one "all rows frozen" flag back this often
_CHECK_EVERY = 16


def _power_iteration_sq_norm(X: torch.Tensor, iters: int = 16,
                             w: Optional[torch.Tensor] = None,
                             mu: Optional[torch.Tensor] = None,
                             sigma: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """(B,) largest eigenvalues of Xs_b^T diag(w_b) Xs_b / sum(w_b) by
    power iteration, with ``Xs_b = (X - mu_b) / sigma_b`` never formed:
    ``Xs v = X (v/sigma) - mu.(v/sigma)`` and ``Xs^T r = (X^T r -
    mu sum(r)) / sigma``. ``X`` (n, d); ``w`` (B, n) row weights;
    ``mu``, ``sigma`` (B, d). B is 1 when all three are None."""
    n, d = X.shape
    B = next((a.shape[0] for a in (w, mu, sigma) if a is not None), 1)
    if w is None:
        wsum = torch.full((B,), float(n), dtype=X.dtype, device=X.device)
    else:
        wsum = torch.clamp(torch.sum(w, dim=1), min=1e-12)

    def matvec(v):                          # (B, d) -> (B, d)
        vs = v if sigma is None else v / sigma
        m = X @ vs.T                        # (n, B)
        if mu is not None:
            m = m - torch.sum(vs * mu, dim=1)
        r = m if w is None else m * w.T
        u = (X.T @ r).T
        if mu is not None:
            u = u - mu * torch.sum(r, dim=0)[:, None]
        if sigma is not None:
            u = u / sigma
        return u / wsum[:, None]

    v = torch.full((B, d), 1.0 / math.sqrt(d), dtype=X.dtype,
                   device=X.device)
    for _ in range(iters):
        u = matvec(v)
        v = u / (torch.linalg.vector_norm(u, dim=1, keepdim=True) + 1e-12)
    return torch.sum(v * matvec(v), dim=1)


def design_lipschitz(X: torch.Tensor, l2, curvature_bound: float = 0.25,
                     w: Optional[torch.Tensor] = None,
                     mu: Optional[torch.Tensor] = None,
                     sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) Lipschitz bounds for losses sum(w phi(x.b))/sum(w) +
    l2/2 |b|^2 with phi'' <= ``curvature_bound`` (0.25 logistic, 2
    squared hinge); ``l2`` a scalar or (B,)."""
    return (curvature_bound
            * _power_iteration_sq_norm(X, w=w, mu=mu, sigma=sigma) + l2)


def fista_minimize(grad_fn: Callable[[torch.Tensor], torch.Tensor], l1,
                   w0: torch.Tensor, lipschitz: torch.Tensor,
                   max_iter: int = 500, tol: float = 1e-7,
                   l1_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FISTA on B candidates at once: minimize ``smooth_b(w) + l1_b *
    |mask * w|_1`` for each row of ``w0`` (B, p). ``grad_fn`` maps (B, p)
    parameters to their (B, p) smooth gradients; ``lipschitz`` and ``l1``
    are (B,) tensors or scalars; ``l1_mask`` (p,) excludes entries (the
    intercept) from the penalty.

    ``tol <= 0`` runs exactly ``max_iter`` iterations and never reads a
    value back. ``tol > 0`` reproduces the JAX package's ``while_loop``:
    a candidate's state freezes after the first iteration whose step
    ``|w_next - w|`` falls below ``tol``, so each row is that loop's
    iterate; every 16 iterations one flag is read back to stop once all
    rows are frozen. Returns (w (B, p), iterations (B,))."""
    B, p = w0.shape
    dev = w0.device
    lip = torch.as_tensor(lipschitz, dtype=w0.dtype, device=dev)
    step = (1.0 / torch.clamp(lip, min=1e-12)).reshape(-1, 1)
    thr = step * torch.as_tensor(l1, dtype=w0.dtype, device=dev
                                 ).reshape(-1, 1)
    mask = (torch.ones(p, dtype=torch.bool, device=dev) if l1_mask is None
            else torch.as_tensor(l1_mask, device=dev) > 0)

    def prox(v):
        shrunk = torch.sign(v) * torch.clamp(torch.abs(v) - thr, min=0.0)
        return torch.where(mask, shrunk, v)

    w, z, t = w0, w0, 1.0
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    for it in range(max_iter):
        w_next = prox(z - step * grad_fn(z))
        t_next = (1.0 + math.sqrt(1.0 + 4.0 * t * t)) / 2.0
        z_next = w_next + ((t - 1.0) / t_next) * (w_next - w)
        t = t_next
        if tol <= 0:
            w, z = w_next, z_next
            continue
        delta = torch.linalg.vector_norm(w_next - w, dim=1)
        keep = active[:, None]
        w = torch.where(keep, w_next, w)
        z = torch.where(keep, z_next, z)
        iters += active
        active = active & (delta >= tol)
        if (it + 1) % _CHECK_EVERY == 0 and not bool(active.any()):
            break
    if tol <= 0:
        iters += max_iter
    return w, iters


# ---------------------------------------------------------------------------
# L-BFGS (optax.lbfgs) with its zoom line search
# ---------------------------------------------------------------------------

#: optax.lbfgs defaults, and those of its scale_by_zoom_linesearch
_MEMORY = 10
_LS_STEPS = 20
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
_INTERVAL_THRESHOLD = 1e-5
_INCREASE = 2.0

_f = np.float64


def _nan_to_inf(x):
    return _f(np.inf) if np.isnan(x) else x


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo error, relaxed by Hager and Zhang's approximate decrease
    (``zoom_linesearch._compute_decrease_error``)."""
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - _APPROX_DEC_RTOL * np.abs(value_init)
    approx = np.maximum(approx, delta_values)
    err = np.maximum(np.minimum(approx, err), 0.0)
    return _nan_to_inf(err)


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(slope_init), 0.0)
    return _nan_to_inf(err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when it has none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    x0 = fb - fa - C * db
    x1 = fc - fa - C * dc
    A = (dc * dc * x0 + -(db * db) * x1) / denom
    B = (-(dc * dc * dc) * x0 + db * db * db * x1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _Trial:
    """One point of the line search: stepsize, value, slope (host
    floats) and gradient (a tensor on the parameters' device)."""
    __slots__ = ("stepsize", "value", "grad", "slope")

    def __init__(self, stepsize, value, grad, slope):
        self.stepsize, self.value, self.grad, self.slope = (
            stepsize, value, grad, slope)


def _zoom_linesearch(value_and_grad, params, updates, value, grad, slope):
    """optax's zoom line search (Nocedal and Wright Algorithms 3.5 and
    3.6, with Hager and Zhang's approximate decrease) from ``params``
    along ``updates``: returns the final (stepsize, value, grad, grad
    norm). Branches decide on host floats exactly as optax's traced
    ``where``s do."""
    value_init, slope_init = value, slope

    def on_line(stepsize):
        val, g = value_and_grad(params + stepsize * updates)
        sl = torch.sum(g * updates)
        host = torch.stack([val, sl, torch.linalg.vector_norm(g)]).tolist()
        return _Trial(_f(stepsize), _f(host[0]), g, _f(host[1])), _f(host[2])

    gnorm = _f(torch.linalg.vector_norm(grad).item())
    cur = _Trial(_f(0.0), value, grad, slope)
    low = high = cubic_ref = _Trial(_f(0.0), value, grad, slope)
    safe, safe_gnorm = _Trial(_f(0.0), value, grad, slope), gnorm
    cur_gnorm = gnorm
    decrease_error = _f(np.inf)
    interval_found = done = failed = False
    count = 0
    while not (done or failed):
        if not interval_found:
            # search an interval (Algorithm 3.5)
            new_stepsize = _f(1.0) if count == 0 else _INCREASE * cur.stepsize
            new, new_gnorm = on_line(new_stepsize)
            decrease_error = _decrease_error(new.stepsize, new.value,
                                             new.slope, value_init,
                                             slope_init)
            new_error = np.maximum(decrease_error,
                                   _curvature_error(new.slope, slope_init))
            if decrease_error <= 0.0:
                safe, safe_gnorm = new, new_gnorm
            set_high = (decrease_error > 0.0) or (
                new.value >= cur.value and count > 0)
            set_low = new.slope >= 0.0 and not set_high
            if set_low:
                low, high = new, cur
            else:
                low, high = cur, new
            cubic_ref = low
            interval_found = set_high or set_low or new_error <= 0.0
            done = bool(new_error <= 0.0)
            failed = count + 1 >= _LS_STEPS and not done
            cur, cur_gnorm = new, new_gnorm
        else:
            # zoom into the interval (Algorithm 3.6)
            delta = np.abs(high.stepsize - low.stepsize)
            left = np.minimum(high.stepsize, low.stepsize)
            right = np.maximum(high.stepsize, low.stepsize)
            too_small_int = delta <= _INTERVAL_THRESHOLD
            with np.errstate(all="ignore"):
                mid_cubic = _cubicmin(low.stepsize, low.value, low.slope,
                                      high.stepsize, high.value,
                                      cubic_ref.stepsize, cubic_ref.value)
                mid_quad = _quadmin(low.stepsize, low.value, low.slope,
                                    high.stepsize, high.value)
            if left + 0.2 * delta < mid_cubic < right - 0.2 * delta:
                middle = mid_cubic
            elif left + 0.1 * delta < mid_quad < right - 0.1 * delta:
                middle = mid_quad
            else:
                middle = (low.stepsize + high.stepsize) / 2.0
            new, new_gnorm = on_line(middle)
            decrease_error = _decrease_error(new.stepsize, new.value,
                                             new.slope, value_init,
                                             slope_init)
            new_error = np.maximum(decrease_error,
                                   _curvature_error(new.slope, slope_init))
            if decrease_error <= 0.0 and new.value < safe.value:
                safe, safe_gnorm = new, new_gnorm
            done = bool(new_error <= 0.0)
            set_high_to_mid = (decrease_error > 0.0) or (
                new.value >= low.value)
            set_high_to_low = (new.slope * (high.stepsize - low.stepsize)
                               >= 0.0) and not set_high_to_mid
            old_low, old_high = low, high
            if set_high_to_mid:
                high = new
            elif set_high_to_low:
                high = old_low
            if not set_high_to_mid:
                low = new
            cubic_ref = (old_high if set_high_to_mid or set_high_to_low
                         else old_low)
            failed = (count + 1 >= _LS_STEPS
                      or (too_small_int and safe.stepsize > 0.0)) and not done
            cur, cur_gnorm = new, new_gnorm
        count += 1
        if failed and (safe.stepsize > 0.0 or np.isinf(decrease_error)):
            # fall back to the best step with sufficient decrease (or, out
            # of the domain, to no step)
            cur, cur_gnorm = safe, safe_gnorm
    return cur.stepsize, cur.value, cur.grad, cur_gnorm


def lbfgs_minimize(value_and_grad: Callable, w0: torch.Tensor,
                   max_iter: int = 100, tol: float = 1e-6
                   ) -> Tuple[torch.Tensor, int]:
    """Minimize a smooth loss from ``w0`` (p,) with optax's L-BFGS:
    ``value_and_grad(w) -> (0-dim value, (p,) gradient)``. Iterates while
    the count is 0, or below ``max_iter`` with the line search's last
    gradient norm at least ``tol`` (the JAX package's ``while_loop``).
    Returns (params, iterations)."""
    p = w0.shape[0]
    dtype, dev = w0.dtype, w0.device
    dW = torch.zeros((_MEMORY, p), dtype=dtype, device=dev)
    dU = torch.zeros((_MEMORY, p), dtype=dtype, device=dev)
    rho = torch.zeros(_MEMORY, dtype=dtype, device=dev)
    prev_params = torch.zeros_like(w0)
    prev_grad = torch.zeros_like(w0)
    params = w0
    ls_value, ls_grad, ls_gnorm = _f(np.inf), torch.zeros_like(w0), _f(0.0)
    count = 0
    while count == 0 or (count < max_iter and ls_gnorm >= tol):
        if np.isfinite(ls_value):
            value, grad = ls_value, ls_grad
        else:
            v, grad = value_and_grad(params)
            value = _f(v.item())
        # scale_by_lbfgs: update the memory, then precondition
        memory_idx = count % _MEMORY
        prev_idx = (count - 1) % _MEMORY
        if count > 0:
            diff_params = params - prev_params
            diff_updates = grad - prev_grad
            vdot = torch.sum(diff_updates * diff_params)
            weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
            denominator = torch.sum(diff_updates * diff_updates)
            identity_scale = torch.where(denominator > 0.0,
                                         vdot / denominator, 1.0)
        else:
            diff_params = diff_updates = torch.zeros_like(w0)
            weight = torch.zeros((), dtype=dtype, device=dev)
            identity_scale = torch.clamp(
                1.0 / torch.linalg.vector_norm(grad), max=1.0)
        dW[prev_idx] = diff_params
        dU[prev_idx] = diff_updates
        rho[prev_idx] = weight
        order = [(memory_idx + i) % _MEMORY for i in range(_MEMORY)]
        vec = grad
        alphas = {}
        for idx in reversed(order):
            alphas[idx] = rho[idx] * torch.sum(dW[idx] * vec)
            vec = vec + (-alphas[idx]) * dU[idx]
        vec = identity_scale * vec
        for idx in order:
            beta = rho[idx] * torch.sum(dU[idx] * vec)
            vec = vec + (alphas[idx] - beta) * dW[idx]
        prev_params, prev_grad = params, grad
        count += 1
        updates = -1.0 * vec
        slope = _f(torch.sum(updates * grad).item())
        stepsize, ls_value, ls_grad, ls_gnorm = _zoom_linesearch(
            value_and_grad, params, updates, value, grad, slope)
        params = params + stepsize * updates
    return params, count
