"""Stochastic-interpolant coupling plans (port of ``mdgen_tpu/transport/paths.py``).

x_t = alpha_t * x1 + sigma_t * x0, x0 ~ N(0, I) noise, x1 data; alpha grows
from 0 to 1 as t goes 0 -> 1. Ported: what the probability-flow ODE drift
needs (sigma, d(alpha)/alpha, the forward drift) and what the training loss
needs (alpha, interpolate).
"""
from __future__ import annotations

import math

import torch


def expand_t(t, x):
    """Broadcast a [B] time vector against [B, ...] data."""
    return t.reshape(x.shape[0], *([1] * (x.ndim - 1)))


class LinearPlan:
    """alpha_t = t, sigma_t = 1 - t."""

    def alpha(self, t):
        return t, torch.ones_like(t)

    def sigma(self, t):
        return 1 - t, -torch.ones_like(t)

    def d_alpha_over_alpha(self, t):
        return 1 / t

    def drift(self, x, t):
        """Score-parametrized forward drift: returns (-mean, diffusion)."""
        t = expand_t(t, x)
        ratio = self.d_alpha_over_alpha(t)
        sigma_t, d_sigma_t = self.sigma(t)
        return -(ratio * x), ratio * sigma_t**2 - sigma_t * d_sigma_t

    def interpolate(self, t, x0, x1):
        """Returns (x_t, u_t): the noisy sample and the target velocity."""
        te = expand_t(t, x1)
        alpha_t, d_alpha_t = self.alpha(te)
        sigma_t, d_sigma_t = self.sigma(te)
        return alpha_t * x1 + sigma_t * x0, d_alpha_t * x1 + d_sigma_t * x0


class GVPPlan(LinearPlan):
    """alpha_t = sin(pi t / 2), sigma_t = cos(pi t / 2) (the default)."""

    def alpha(self, t):
        return torch.sin(t * math.pi / 2), math.pi / 2 * torch.cos(t * math.pi / 2)

    def sigma(self, t):
        return torch.cos(t * math.pi / 2), -math.pi / 2 * torch.sin(t * math.pi / 2)

    def d_alpha_over_alpha(self, t):
        return math.pi / (2 * torch.tan(t * math.pi / 2))


class VPPlan(LinearPlan):
    """VP-SDE schedule in the t: 0 -> 1 = noise -> data direction."""

    def __init__(self, sigma_min=0.1, sigma_max=20.0):
        self.sigma_min, self.sigma_max = sigma_min, sigma_max

    def _log_mean(self, t):
        return (-0.25 * (1 - t) ** 2 * (self.sigma_max - self.sigma_min)
                - 0.5 * (1 - t) * self.sigma_min)

    def _d_log_mean(self, t):
        return 0.5 * (1 - t) * (self.sigma_max - self.sigma_min) + 0.5 * self.sigma_min

    def alpha(self, t):
        alpha_t = torch.exp(self._log_mean(t))
        return alpha_t, alpha_t * self._d_log_mean(t)

    def sigma(self, t):
        p = 2 * self._log_mean(t)
        sigma_t = torch.sqrt(1 - torch.exp(p))
        return sigma_t, torch.exp(p) * (2 * self._d_log_mean(t)) / (-2 * sigma_t)

    def drift(self, x, t):
        t = expand_t(t, x)
        beta_t = self.sigma_min + (1 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2


PLANS = {"Linear": LinearPlan, "GVP": GVPPlan, "VP": VPPlan}


def make_plan(path_type: str):
    return PLANS[path_type]()
