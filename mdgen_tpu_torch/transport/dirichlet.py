"""Dirichlet conditional flow for the 20 sequence-design channels (port of
``mdgen_tpu/transport/dirichlet.py``), on the device.

The table of -dI/dalpha (I the regularized incomplete beta function) over a
grid of (alpha, b) is built once per process and key on the host with
SciPy, as the JAX package builds it, and lives on the model's device as a
non-persistent buffer: inside the sampling loop the conditional-flow factor
is a row gather and a linear interpolation, with no host round trip.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch
from torch import nn


@functools.lru_cache(maxsize=None)
def _cfactor_table(K: int, alpha_min: float, alpha_max: float, alpha_spacing: float,
                   n_b: int):
    """(bs [n_b] f32, table [n_alpha - 1, n_b] f32) on the JAX package's grids."""
    import scipy.special  # host-only, build time only

    alphas = np.arange(alpha_min, alpha_max + alpha_spacing, alpha_spacing)
    bs = np.linspace(0, 1, n_b)
    cdfs = scipy.special.betainc(alphas[:, None], K - 1, bs[None, :])
    deriv = np.diff(cdfs, axis=0) / alpha_spacing
    return bs.astype(np.float32), deriv.astype(np.float32)


# the least normal f32: XLA flushes smaller magnitudes to zero (on the CPU
# and the TPU), as inputs and as results
_F32_TINY = float(np.finfo(np.float32).tiny)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values -> 0, as XLA computes them."""
    return torch.where(x.abs() < _F32_TINY, torch.zeros_like(x), x)


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by binary exponentiation, the products in the order XLA's
    ``integer_pow`` takes them and each flushed as XLA flushes it (so the f32
    roundings and underflows agree)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else _ftz(acc * x)
        n >>= 1
        if n > 0:
            x = _ftz(x * x)
    return acc


def _interp_uniform(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for an increasing grid ``xp`` of uniformly
    spaced points on [0, 1]: the interval index comes from ``x * (n - 1)``
    and is moved by one where the stored grid point disagrees, so it is
    ``searchsorted(xp, x, side='right')`` clipped to [1, n - 1]; the values
    outside the grid are clamped to the end values."""
    n = xp.shape[0]
    i = (torch.nan_to_num(x) * (n - 1)).floor().clamp(-1, n - 1).long() + 1
    i = torch.where((i >= 1) & (xp[(i - 1).clamp(0, n - 1)] > x), i - 1, i)
    i = torch.where((i < n) & (xp[i.clamp(0, n - 1)] <= x), i + 1, i)
    i = i.clamp(1, n - 1)
    lo, df = fp[i - 1], fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    step = _ftz((delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(dx0, lo, lo + step)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class DirichletConditionalFlow(nn.Module):
    """The precomputed -dI/dalpha table over (alpha, b) for simplex flow
    matching; ``K`` is the simplex dimension (20 amino acids).

    The table and its b grid are buffers that are not saved (``persistent=
    False``): they stay out of the state dict, the optimizer and the EMA,
    and ``inference_param_cast`` (parameters only) leaves them in f32. A
    deep copy of the module (the EMA copy, the serving copy) shares them."""

    def __init__(self, K=20, alpha_min=1.0, alpha_max=100.0, alpha_spacing=0.01, n_b=1000):
        super().__init__()
        self.K, self.alpha_min, self.alpha_spacing = K, alpha_min, alpha_spacing
        bs, table = _cfactor_table(K, float(alpha_min), float(alpha_max), float(alpha_spacing),
                                   n_b)
        self.register_buffer("bs", torch.from_numpy(bs), persistent=False)
        self.register_buffer("table", torch.from_numpy(table), persistent=False)

    def __deepcopy__(self, memo):
        new = copy.copy(self)
        new._parameters, new._buffers, new._modules = {}, dict(self._buffers), {}
        memo[id(self)] = new
        return new

    def c_factor(self, bs: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        """Conditional-flow factor: ``bs`` of any shape in [0, 1] (f32),
        ``alpha`` a 0-d f32 tensor on the same device. The edges of the
        simplex give the JAX package's 0, inf and nan (the ``1e-30`` clamps
        and the two ``where``s as there, subnormal values flushed to zero as
        XLA flushes them)."""
        K = self.K
        alpha = alpha.float()
        bs = _ftz(bs)
        k1 = torch.tensor(K - 1.0, dtype=torch.float32, device=bs.device)
        beta = torch.exp(torch.lgamma(alpha) + torch.lgamma(k1) - torch.lgamma(alpha + (K - 1.0)))
        zero = torch.zeros((), dtype=bs.dtype, device=bs.device)
        beta_div = torch.where(bs < 1, beta / _integer_pow((1 - bs).clamp_min(1e-30), K - 1), zero)
        pow_term = _ftz(bs ** (alpha - 1))
        beta_div_full = torch.where(pow_term > 0, beta_div / pow_term.clamp_min(1e-30), zero)
        idx = torch.round((alpha - self.alpha_min) / self.alpha_spacing).to(torch.int32)
        row = _ftz(self.table[idx.clamp(0, self.table.shape[0] - 1).long()])
        return _ftz(-_interp_uniform(bs, self.bs, row) * beta_div_full)


def simplex_proj(seq: torch.Tensor) -> torch.Tensor:
    """Euclidean projection onto the probability simplex over the last axis
    (Wang & Carreira-Perpinan 2013)."""
    K = seq.shape[-1]
    x_sorted = torch.sort(seq, dim=-1, descending=True).values
    cand = (x_sorted.cumsum(-1) - 1) / torch.arange(1, K + 1, dtype=seq.dtype, device=seq.device)
    n_greater = (x_sorted > cand).sum(-1, keepdim=True)
    # a row with no candidate (nan input) takes the last one, as a -1 index does in JAX
    tau = cand.gather(-1, torch.where(n_greater > 0, n_greater - 1, K - 1))
    return (seq - tau).clamp_min(0.0)


# each round accepts a draw with probability above 0.95 for conc >= 1
_GAMMA_ROUNDS = 64


def _sample_gamma(conc: torch.Tensor, generator=None) -> torch.Tensor:
    """Gamma(conc, 1) draws for ``conc >= 1`` by Marsaglia and Tsang's
    method, from ``generator``: each round draws a normal and a uniform for
    every element and keeps the first accepted value of each. The rounds
    (and so the draw) depend only on the generator's state and the shape."""
    d = conc - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(conc)
    done = torch.zeros(conc.shape, dtype=torch.bool, device=conc.device)
    for _ in range(_GAMMA_ROUNDS):
        x = torch.randn(conc.shape, generator=generator, device=conc.device, dtype=conc.dtype)
        u = torch.rand(conc.shape, generator=generator, device=conc.device, dtype=conc.dtype)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
        if bool(done.all()):
            return out
    raise RuntimeError(f"gamma sampler: {int((~done).sum())} draws not accepted in "
                       f"{_GAMMA_ROUNDS} rounds (concentrations must be >= 1)")


def sample_dirichlet(conc: torch.Tensor, generator=None) -> torch.Tensor:
    """Dirichlet(conc) over the last axis, ``conc >= 1``, from ``generator``."""
    g = _sample_gamma(conc.float(), generator)
    return g / g.sum(-1, keepdim=True)

