"""Flow-matching transport (port of ``mdgen_tpu/transport/transport.py``):
the training loss (with the Dirichlet flow of the 20 sequence-design
channels, ``dirichlet.py``), the sampling interval, the probability-flow
drift and ODE sampling."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import integrators
from .dirichlet import sample_dirichlet
from .paths import expand_t, make_plan


def t_to_alpha(t, alpha_max: float):
    """Flow time -> Dirichlet concentration, and d(alpha)/dt."""
    return (1 - t) + t * alpha_max, (alpha_max - 1)


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
    # design: the 20 simplex channels (Dirichlet flow; the mpnn modes predict
    # the sequence at t = 1 from zero simplex channels)
    design: bool = False
    dynamic_mpnn: bool = False
    mpnn: bool = False
    alpha_max: float = 8.0
    discrete_loss_weight: float = 0.5

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
                        x0: Optional[torch.Tensor] = None,
                        aatype1: Optional[torch.Tensor] = None,
                        x_d: Optional[torch.Tensor] = None) -> dict:
        """Flow-matching loss. ``model_fn(xt, t, **model_kwargs)`` is the
        denoiser; ``x1`` [B, T, L, D] the data, ``mask`` the per-element
        loss mask. t ~ U[t0, t1), x0 ~ N(0, I) and, under ``design``, the
        simplex point x_d [B, L, 20] ~ Dirichlet(1 + onehot(aatype1) (alpha_t
        - 1)) are drawn from ``generator`` (in that order) unless given.
        Returns {"t", "pred", "loss" [B]}; under ``design`` also
        "loss_continuous", "loss_discrete" and "logits"."""
        cfg = self.cfg
        mpnn = cfg.dynamic_mpnn or cfg.mpnn
        B = x1.shape[0]
        if t is None:
            t0, t1 = self.check_interval()
            t = torch.rand((B,), generator=generator, device=x1.device) * (t1 - t0) + t0
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
        xt, ut = self.plan.interpolate(t, x0, x1)
        if cfg.design:
            if cfg.prediction != "velocity":
                raise NotImplementedError("design trains the velocity prediction only")
            B, T, L = x1.shape[:3]
            if mpnn:
                t = torch.ones_like(t)
                x_d = torch.zeros((B, L, 20), dtype=x1.dtype, device=x1.device)
            elif x_d is None:
                alphas, _ = t_to_alpha(t, cfg.alpha_max)
                one_hot = F.one_hot(aatype1.long(), 20).to(x1.dtype)
                x_d = sample_dirichlet(1 + one_hot * (alphas[:, None, None] - 1), generator)
            xt = torch.cat([xt, x_d[:, None].expand(B, T, L, 20).to(xt.dtype)], dim=-1)
        pred = model_fn(xt, t, **(model_kwargs or {}))
        logits = None
        if cfg.design and not mpnn:
            pred, logits = pred[..., :-20], pred[..., -20:]
        terms = {"t": t, "pred": pred}
        if not mpnn:
            terms["loss"] = self._continuous_loss(pred, xt, t, x0, ut, mask)
        if cfg.design:
            if mpnn:
                logits = pred  # [B, 1, L, 20]
                terms["loss_continuous"] = torch.full((B,), float("nan"), device=x1.device)
                loss_d = _cross_entropy(logits[:, 0], aatype1)
                terms["loss"] = loss_d
            else:
                terms["loss_continuous"] = terms["loss"]
                loss_d = _cross_entropy(logits, aatype1[:, None])
                w = cfg.discrete_loss_weight
                terms["loss"] = loss_d * w + (1 - w) * terms["loss"]
            terms["loss_discrete"] = loss_d
            terms["logits"] = logits
        return terms

    def _continuous_loss(self, pred, xt, t, x0, ut, mask):
        if self.cfg.prediction == "velocity":
            return mean_flat((pred - ut) ** 2, mask)
        _, drift_var = self.plan.drift(xt, t)
        sigma_t, _ = self.plan.sigma(expand_t(t, xt))
        if self.cfg.loss_weight == "velocity":
            weight = (drift_var / sigma_t) ** 2
        elif self.cfg.loss_weight == "likelihood":
            weight = drift_var / sigma_t**2
        else:
            weight = 1.0
        if self.cfg.prediction == "noise":
            return mean_flat(weight * (pred - x0) ** 2, mask)
        return mean_flat(weight * (pred * sigma_t + x0) ** 2, mask)

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


def _cross_entropy(logits, labels):
    """Token-mean cross entropy over 20 classes; ``labels`` broadcast
    against the logits' leading axes."""
    labels = labels.long().expand(logits.shape[:-1])
    return F.cross_entropy(logits.reshape(-1, 20).float(), labels.reshape(-1))


class Sampler:
    def __init__(self, transport: Transport):
        self.transport = transport

    def sample_ode(self, model_fn: Callable, *, sampling_method: str = "dopri5",
                   num_steps: int = 50, atol: float = 1e-6, rtol: float = 1e-3,
                   reverse: bool = False, stats: Optional[dict] = None) -> Callable:
        """Returns ``sample(x_init, **model_kwargs) -> x_final`` integrating
        with ``euler`` or ``heun`` (``num_steps`` grid points) or ``dopri5``
        (adaptive, ``atol``/``rtol``); any other method raises. Each solve
        fills ``stats`` (``integrators``) when it is given."""
        t0, t1 = self.transport.check_interval(sde=False, eval=True, reverse=reverse)
        solvers = {
            "euler": lambda f, x: integrators.ode_euler(f, x, t0, t1, num_steps, stats=stats),
            "heun": lambda f, x: integrators.ode_heun(f, x, t0, t1, num_steps, stats=stats),
            "dopri5": lambda f, x: integrators.ode_dopri5(f, x, t0, t1, rtol=rtol, atol=atol,
                                                          stats=stats),
        }
        if sampling_method not in solvers:
            raise NotImplementedError(f"sampling_method={sampling_method!r}: the ODE "
                                      f"samplers are {', '.join(solvers)}")
        solve = solvers[sampling_method]
        drift = self.transport.drift_fn(model_fn)
        if reverse:
            base = drift
            drift = lambda x, t, **kw: base(x, 1 - t, **kw)  # noqa: E731

        def sample(x, **model_kwargs):
            return solve(lambda xx, tt: drift(xx, tt, **model_kwargs), x)

        return sample
