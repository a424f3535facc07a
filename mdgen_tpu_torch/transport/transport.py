"""Flow-matching transport (port of ``mdgen_tpu/transport/transport.py``):
the training loss, the sampling interval, the probability-flow drift and
ODE sampling."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from . import integrators
from .paths import expand_t, make_plan


def mean_flat(x, mask):
    """Masked mean over all non-batch axes -> [B]."""
    axes = tuple(range(1, x.ndim))
    return (x * mask).sum(axes) / mask.sum(axes)


@dataclass(frozen=True)
class TransportConfig:
    path_type: str = "GVP"  # Linear | GVP | VP
    prediction: str = "velocity"  # velocity | score | noise
    loss_weight: Optional[str] = None  # None | velocity | likelihood
    train_eps: Optional[float] = None
    sample_eps: Optional[float] = None

    def resolved_eps(self):
        """Default eps per path/prediction combination."""
        train_eps, sample_eps = self.train_eps, self.sample_eps
        if self.path_type == "VP":
            default = (1e-5, 1e-3)
        elif self.prediction != "velocity":
            default = (1e-3, 1e-3)
        else:
            default = (0.0, 0.0)
        return (default[0] if train_eps is None else train_eps,
                default[1] if sample_eps is None else sample_eps)


class Transport:
    def __init__(self, cfg: TransportConfig):
        self.cfg = cfg
        self.plan = make_plan(cfg.path_type)
        self.train_eps, self.sample_eps = cfg.resolved_eps()

    def check_interval(self, *, sde=False, eval=False, reverse=False,
                       diffusion_form="SBDM", last_step_size=0.0):
        t0, t1 = 0.0, 1.0
        eps = self.sample_eps if eval else self.train_eps
        if self.cfg.path_type == "VP":
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        elif self.cfg.prediction != "velocity" or sde:
            t0 = (
                eps
                if (diffusion_form == "SBDM" and sde) or self.cfg.prediction != "velocity"
                else 0.0
            )
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        if reverse:
            t0, t1 = 1 - t0, 1 - t1
        return t0, t1

    def training_losses(self, model_fn: Callable, x1: torch.Tensor, mask: torch.Tensor,
                        model_kwargs: Optional[dict] = None,
                        generator: Optional[torch.Generator] = None,
                        t: Optional[torch.Tensor] = None,
                        x0: Optional[torch.Tensor] = None) -> dict:
        """Flow-matching loss. ``model_fn(xt, t, **model_kwargs)`` is the
        denoiser; ``x1`` [B, T, L, D] the data, ``mask`` the per-element
        loss mask. t ~ U[t0, t1) and x0 ~ N(0, I) are drawn from
        ``generator`` unless given. Returns {"t", "pred", "loss" [B]}."""
        B = x1.shape[0]
        if t is None:
            t0, t1 = self.check_interval()
            t = torch.rand((B,), generator=generator, device=x1.device) * (t1 - t0) + t0
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
        xt, ut = self.plan.interpolate(t, x0, x1)
        pred = model_fn(xt, t, **(model_kwargs or {}))
        terms = {"t": t, "pred": pred}
        if self.cfg.prediction == "velocity":
            terms["loss"] = mean_flat((pred - ut) ** 2, mask)
            return terms
        _, drift_var = self.plan.drift(xt, t)
        sigma_t, _ = self.plan.sigma(expand_t(t, xt))
        if self.cfg.loss_weight == "velocity":
            weight = (drift_var / sigma_t) ** 2
        elif self.cfg.loss_weight == "likelihood":
            weight = drift_var / sigma_t**2
        else:
            weight = 1.0
        if self.cfg.prediction == "noise":
            terms["loss"] = mean_flat(weight * (pred - x0) ** 2, mask)
        else:
            terms["loss"] = mean_flat(weight * (pred * sigma_t + x0) ** 2, mask)
        return terms

    def drift_fn(self, model_fn: Callable) -> Callable:
        """Probability-flow ODE drift under the configured parametrization."""
        pred = self.cfg.prediction
        plan = self.plan

        def velocity_ode(x, t, **kw):
            return model_fn(x, t, **kw)

        def score_ode(x, t, **kw):
            drift_mean, drift_var = plan.drift(x, t)
            return -drift_mean + drift_var * model_fn(x, t, **kw)

        def noise_ode(x, t, **kw):
            drift_mean, drift_var = plan.drift(x, t)
            sigma_t, _ = plan.sigma(expand_t(t, x))
            return -drift_mean + drift_var * (model_fn(x, t, **kw) / -sigma_t)

        return {"velocity": velocity_ode, "score": score_ode, "noise": noise_ode}[pred]


class Sampler:
    def __init__(self, transport: Transport):
        self.transport = transport

    def sample_ode(self, model_fn: Callable, *, sampling_method: str = "dopri5",
                   num_steps: int = 50, reverse: bool = False) -> Callable:
        """Returns ``sample(x_init, **model_kwargs) -> x_final``."""
        if sampling_method != "euler":
            raise NotImplementedError(
                f"sampling_method={sampling_method!r} is not ported yet "
                "(ROADMAP: remaining samplers); use euler"
            )
        drift = self.transport.drift_fn(model_fn)
        if reverse:
            base = drift
            drift = lambda x, t, **kw: base(x, 1 - t, **kw)  # noqa: E731
        t0, t1 = self.transport.check_interval(sde=False, eval=True, reverse=reverse)

        def sample(x, **model_kwargs):
            return integrators.ode_euler(
                lambda xx, tt: drift(xx, tt, **model_kwargs), x, t0, t1, num_steps
            )

        return sample
