"""ODE and SDE integrators (port of ``mdgen_tpu/transport/integrators.py``).

Each solver integrates dx/dt = f(x, t) from t0 to t1 with t passed as a [B]
vector. PyTorch runs the loop eagerly from the host, one drift call per
stage. The fixed-grid solvers (Euler, Heun, and the SDE solvers on the same
grid) follow the JAX scans step for step. The adaptive Dormand-Prince 5(4)
solver keeps the JAX ``lax.while_loop``'s controller in float32 on the host
(``np.float32``: t, dt, the error history and the tableau), so it takes the
same steps as JAX; the stage sums run in f32 on the device, and the accept
test reads one scalar per attempt.

The ODE solvers take a state that is a tensor or a tuple of tensors (the
drift returns the same structure), as the JAX solvers take any pytree: the
likelihood integrates the pair (x, log p). dopri5's error norm is then the
RMS over every element of every member. The SDE solvers draw their
per-step N(0, I) noise from ``generator``, or take it whole as ``noise``
[num_steps - 1, *x.shape].

``stats``, where a solver takes it, is a dict the solver fills: attempts,
accepted, rejected, drift evaluations, the final t and whether t1 was
reached.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _leaves(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _map(fn, *states):
    """``fn`` over the members of matching states (tensors or tuples)."""
    if isinstance(states[0], tuple):
        return tuple(fn(*members) for members in zip(*states))
    return fn(*states)


def _tvec(x, t) -> torch.Tensor:
    x = _leaves(x)[0]
    return torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)


def _grid(x0, t0, t1, num_steps):
    dt = (t1 - t0) / (num_steps - 1)
    device = _leaves(x0)[0].device
    return dt, t0 + dt * torch.arange(num_steps - 1, dtype=torch.float32, device=device)


def _fixed_stats(stats, steps, evals, t1):
    if stats is not None:
        stats.update(attempts=steps, accepted=steps, rejected=0, evals=evals,
                     t_final=float(np.float32(t1)), reached_t1=True)


def ode_euler(drift: Callable, x0, t0: float, t1: float, num_steps: int,
              stats: Optional[dict] = None):
    """Euler on the grid t0 + i*dt, i < num_steps - 1, dt = (t1-t0)/(num_steps-1):
    num_steps - 1 drift evaluations. Returns the final state."""
    dt, ts = _grid(x0, t0, t1, num_steps)
    x = x0
    B = _leaves(x)[0].shape[0]
    for i in range(num_steps - 1):
        x = _map(lambda a, k: a + dt * k, x, drift(x, ts[i].expand(B)))
    _fixed_stats(stats, num_steps - 1, num_steps - 1, t1)
    return x


def ode_heun(drift: Callable, x0, t0: float, t1: float, num_steps: int,
             stats: Optional[dict] = None):
    """Explicit trapezoidal (Heun) rollout on Euler's grid: two drift
    evaluations per step."""
    dt, ts = _grid(x0, t0, t1, num_steps)
    x = x0
    B = _leaves(x)[0].shape[0]
    for i in range(num_steps - 1):
        k1 = drift(x, ts[i].expand(B))
        k2 = drift(_map(lambda a, k: a + dt * k, x, k1), (ts[i] + dt).expand(B))
        x = _map(lambda a, p, q: a + (dt * 0.5) * (p + q), x, k1, k2)
    _fixed_stats(stats, num_steps - 1, 2 * (num_steps - 1), t1)
    return x


# Butcher tableau, rounded to f32 as the JAX package's jnp arrays are
_F = np.float32
_C = [_F(c) for c in (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)]
_A = [
    [_F(a) for a in row] for row in (
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    )
]
_B5 = [_F(b) for b in (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)]
_B4 = [_F(b) for b in (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
                       187 / 2100, 1 / 40)]


def _combine(x, dt, coeffs, ks):
    """x + dt * sum_j coeffs[j] * ks[j], summed left to right in f32 as the
    JAX solver's Python ``sum`` does (zero coefficients included)."""
    acc = float(coeffs[0]) * ks[0]
    for c, k in zip(coeffs[1:], ks[1:]):
        acc = acc + float(c) * k
    return x + float(dt) * acc


def ode_dopri5(drift: Callable, x0, t0: float, t1: float,
               rtol: float = 1e-3, atol: float = 1e-6, max_steps: int = 1000,
               safety: float = 0.9, stats: Optional[dict] = None,
               row_weight: Optional[torch.Tensor] = None,
               all_reduce: Optional[Callable] = None):
    """Adaptive Dormand-Prince 5(4) with FSAL and a PI step-size controller,
    as the JAX ``ode_dopri5``: the error norm is the RMS over every element
    of the batch (of every member of a tuple state) of err / (atol + rtol *
    max(|x|, |x_new|)); dt starts at
    0.01 * (t1 - t0) and is clamped so no step passes t1; the loop runs while
    |t - t1| > 1e-12 and fewer than ``max_steps`` attempts (rejected ones
    included) were made. When the attempts run out, x at t < t1 is returned,
    as JAX returns it; ``stats["reached_t1"]`` is then False.

    On data-parallel ranks, each holding some rows of a batch: ``row_weight``
    [B] is 1 for a row of the global batch and 0 for a pad, and
    ``all_reduce`` sums a tensor over the ranks. The error norm then sums
    the rows' squares and element counts over the ranks before the host
    reads it, so every rank accepts and rejects the steps one rank would."""
    t1f = _F(t1)
    t = _F(t0)
    dt = _F((t1 - t0) * 0.01)
    err_prev = _F(1.0)
    safety, e_acc, e_prev = _F(safety), _F(-0.7 / 5.0), _F(0.4 / 5.0)
    n_elem = sum(leaf.numel() for leaf in _leaves(x0))
    x = x0
    f0 = drift(x, _tvec(x, t))
    attempts = accepted = 0
    while abs(t - t1f) > _F(1e-12) and attempts < max_steps:
        remaining = _F(t1f - t)
        if abs(dt) > abs(remaining):
            dt = remaining
        ks = [f0]
        for i, row in enumerate(_A):
            xi = _map(lambda a, *k: _combine(a, dt, row, k), x, *ks[: len(row)])
            ks.append(drift(xi, _tvec(x, _F(t + _F(dt * _C[i + 1])))))
        x5 = _map(lambda a, *k: _combine(a, dt, _B5, k), x, *ks)
        x4 = _map(lambda a, *k: _combine(a, dt, _B4, k), x, *ks)
        sq = [((b5 - b4) / (atol + rtol * torch.maximum(a.abs(), b5.abs()))).square()
              for a, b5, b4 in zip(_leaves(x), _leaves(x5), _leaves(x4))]
        if row_weight is None and all_reduce is None:
            en = _F(torch.sqrt(sum(s.sum() for s in sq) / n_elem).item())
        else:
            en = _F(_ranks_error(sq, row_weight, all_reduce).item())
        accept = bool(en <= _F(1.0))

        en = max(en, _F(1e-10))
        factor = _F(_F(safety * _F(en ** e_acc)) * _F(err_prev ** e_prev))
        factor = _F(min(max(factor, _F(0.2)), _F(10.0)))
        step_dt = dt
        dt = _F(dt * (factor if accept else min(factor, _F(1.0))))
        attempts += 1
        if accept:
            t = _F(t + step_dt)
            x, f0 = x5, ks[-1]  # FSAL: the last stage is f at x5
            err_prev = en
            accepted += 1
    if stats is not None:
        stats.update(attempts=attempts, accepted=accepted, rejected=attempts - accepted,
                     evals=1 + 6 * attempts, t_final=float(t),
                     reached_t1=bool(abs(t - t1f) <= _F(1e-12)))
    return x


def _ranks_error(sq, row_weight, all_reduce):
    """sqrt(sum / count) of per-element squares ``sq`` (each leaf [B, ...])
    over the weighted rows of every rank."""
    w = row_weight if row_weight is not None else sq[0].new_ones(sq[0].shape[0])
    total = sum((s.reshape(s.shape[0], -1).sum(1) * w).sum() for s in sq)
    count = w.sum() * sum(s[0].numel() for s in sq)
    acc = torch.stack([total.float(), count.float()])
    if all_reduce is not None:
        acc = all_reduce(acc)
    return torch.sqrt(acc[0] / acc[1])


def sde_euler_maruyama(drift: Callable, diffusion: Callable, x0: torch.Tensor, t0: float,
                       t1: float, num_steps: int, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None, stats: Optional[dict] = None):
    """Euler-Maruyama on Euler's grid (dt = (t1-t0)/(num_steps-1), landing on
    t1; the caller's last step does the rest): x += f dt + sqrt(2 g dt) w,
    with w the step's N(0, I) draw."""
    dt, ts = _grid(x0, t0, t1, num_steps)
    x = x0
    for i in range(num_steps - 1):
        w = _draw(x, i, generator, noise)
        tv = ts[i].expand(x.shape[0])
        d = diffusion(x, tv)
        x = x + drift(x, tv) * dt + torch.sqrt(2 * d * dt) * w
    _fixed_stats(stats, num_steps - 1, num_steps - 1, t1)
    return x


def sde_heun(drift: Callable, diffusion: Callable, x0: torch.Tensor, t0: float, t1: float,
             num_steps: int, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None, stats: Optional[dict] = None):
    """Stochastic Heun on the same grid: the noise first (x^ = x + sqrt(2 g
    dt) w), then a trapezoidal drift step from x^; two drift evaluations per
    step."""
    dt, ts = _grid(x0, t0, t1, num_steps)
    x = x0
    B = x.shape[0]
    for i in range(num_steps - 1):
        w = _draw(x, i, generator, noise)
        tv = ts[i].expand(B)
        xhat = x + torch.sqrt(2 * diffusion(x, tv) * dt) * w
        k1 = drift(xhat, tv)
        k2 = drift(xhat + dt * k1, (ts[i] + dt).expand(B))
        x = xhat + dt * 0.5 * (k1 + k2)
    _fixed_stats(stats, num_steps - 1, 2 * (num_steps - 1), t1)
    return x


def _draw(x, i, generator, noise):
    if noise is not None:
        return noise[i]
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
