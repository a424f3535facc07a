"""Flow-matching transport (port of ``mdgen_tpu/transport/transport.py``):
the training loss (with the Dirichlet flow of the 20 sequence-design
channels, ``dirichlet.py``), the sampling interval, the probability-flow
drift and score, ODE and SDE sampling, and the ODE log-likelihood."""
from __future__ import annotations

import math
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


def mean_flat(x, mask, reduce=None):
    """Masked mean over all non-batch axes -> [B]. ``reduce`` (a callable
    summing a tensor over the ranks that hold the other frames of T, under
    sequence parallelism) makes it the mean over every frame: numerator and
    denominator are summed over them."""
    axes = tuple(range(1, x.ndim))
    num, den = (x * mask).sum(axes), mask.sum(axes)
    if reduce is not None:
        num, den = reduce(num), reduce(den)
    return num / den


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
                        x_d: Optional[torch.Tensor] = None, reduce=None) -> dict:
        """Flow-matching loss. ``model_fn(xt, t, **model_kwargs)`` is the
        denoiser; ``x1`` [B, T, L, D] the data, ``mask`` the per-element
        loss mask. t ~ U[t0, t1), x0 ~ N(0, I) and, under ``design``, the
        simplex point x_d [B, L, 20] ~ Dirichlet(1 + onehot(aatype1) (alpha_t
        - 1)) are drawn from ``generator`` (in that order) unless given.
        Returns {"t", "pred", "loss" [B]}; under ``design`` also
        "loss_continuous", "loss_discrete" and "logits". ``reduce``: x1 holds
        one rank's frames of T, and ``reduce`` sums a tensor over the ranks
        that hold the others (``mean_flat``); the losses are then every
        frame's."""
        cfg = self.cfg
        mpnn = cfg.dynamic_mpnn or cfg.mpnn
        B = x1.shape[0]
        if t is None:
            t = self.sample_t(B, generator, x1.device)
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
                x_d = self.sample_x_d(t, aatype1, generator)
            xt = torch.cat([xt, x_d[:, None].expand(B, T, L, 20).to(xt.dtype)], dim=-1)
        pred = model_fn(xt, t, **(model_kwargs or {}))
        logits = None
        if cfg.design and not mpnn:
            pred, logits = pred[..., :-20], pred[..., -20:]
        terms = {"t": t, "pred": pred}
        if not mpnn:
            terms["loss"] = self._continuous_loss(pred, xt, t, x0, ut, mask, reduce)
        if cfg.design:
            if mpnn:
                logits = pred  # [B, 1, L, 20]
                terms["loss_continuous"] = torch.full((B,), float("nan"), device=x1.device)
                loss_d = _cross_entropy(logits[:, 0], aatype1)
                terms["loss"] = loss_d
            else:
                terms["loss_continuous"] = terms["loss"]
                loss_d = _cross_entropy(logits, aatype1[:, None], reduce)
                w = cfg.discrete_loss_weight
                terms["loss"] = loss_d * w + (1 - w) * terms["loss"]
            terms["loss_discrete"] = loss_d
            terms["logits"] = logits
        return terms

    def sample_t(self, B: int, generator=None, device=None) -> torch.Tensor:
        """t ~ U[t0, t1) [B], ``training_losses``' first draw."""
        t0, t1 = self.check_interval()
        return torch.rand((B,), generator=generator, device=device) * (t1 - t0) + t0

    def sample_x_d(self, t: torch.Tensor, aatype1: torch.Tensor, generator=None) -> torch.Tensor:
        """The design simplex point [B, L, 20] ~ Dirichlet(1 + onehot(aatype1)
        (alpha_t - 1)), ``training_losses``' last draw."""
        alphas, _ = t_to_alpha(t, self.cfg.alpha_max)
        one_hot = F.one_hot(aatype1.long(), 20).to(t.dtype)
        return sample_dirichlet(1 + one_hot * (alphas[:, None, None] - 1), generator)

    def _continuous_loss(self, pred, xt, t, x0, ut, mask, reduce=None):
        if self.cfg.prediction == "velocity":
            return mean_flat((pred - ut) ** 2, mask, reduce)
        _, drift_var = self.plan.drift(xt, t)
        sigma_t, _ = self.plan.sigma(expand_t(t, xt))
        if self.cfg.loss_weight == "velocity":
            weight = (drift_var / sigma_t) ** 2
        elif self.cfg.loss_weight == "likelihood":
            weight = drift_var / sigma_t**2
        else:
            weight = 1.0
        if self.cfg.prediction == "noise":
            return mean_flat(weight * (pred - x0) ** 2, mask, reduce)
        return mean_flat(weight * (pred * sigma_t + x0) ** 2, mask, reduce)

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

    def score_fn(self, model_fn: Callable) -> Callable:
        """The score under the configured parametrization."""
        pred, plan = self.cfg.prediction, self.plan
        if pred == "noise":
            return lambda x, t, **kw: model_fn(x, t, **kw) / -plan.sigma(expand_t(t, x))[0]
        if pred == "score":
            return model_fn
        return lambda x, t, **kw: plan.score_from_velocity(model_fn(x, t, **kw), x, t)


def _cross_entropy(logits, labels, reduce=None):
    """Token-mean cross entropy over 20 classes; ``labels`` broadcast
    against the logits' leading axes. ``reduce`` as ``mean_flat``'s: the
    mean over every rank's tokens."""
    labels = labels.long().expand(logits.shape[:-1])
    if reduce is None:
        return F.cross_entropy(logits.reshape(-1, 20).float(), labels.reshape(-1))
    total = F.cross_entropy(logits.reshape(-1, 20).float(), labels.reshape(-1), reduction="sum")
    count = torch.tensor(float(labels.numel()), device=logits.device)
    return reduce(total) / reduce(count)


class Sampler:
    def __init__(self, transport: Transport):
        self.transport = transport

    def sample_ode(self, model_fn: Callable, *, sampling_method: str = "dopri5",
                   num_steps: int = 50, atol: float = 1e-6, rtol: float = 1e-3,
                   reverse: bool = False, stats: Optional[dict] = None,
                   error_weight: Optional[torch.Tensor] = None,
                   error_sum: Optional[Callable] = None) -> Callable:
        """Returns ``sample(x_init, **model_kwargs) -> x_final`` integrating
        with ``euler`` or ``heun`` (``num_steps`` grid points) or ``dopri5``
        (adaptive, ``atol``/``rtol``; ``error_weight`` and ``error_sum`` as
        ``integrators.ode_dopri5``'s ``row_weight`` and ``all_reduce``); any
        other method raises. Each solve fills ``stats`` (``integrators``)
        when it is given."""
        t0, t1 = self.transport.check_interval(sde=False, eval=True, reverse=reverse)
        solvers = {
            "euler": lambda f, x: integrators.ode_euler(f, x, t0, t1, num_steps, stats=stats),
            "heun": lambda f, x: integrators.ode_heun(f, x, t0, t1, num_steps, stats=stats),
            "dopri5": lambda f, x: integrators.ode_dopri5(f, x, t0, t1, rtol=rtol, atol=atol,
                                                          stats=stats, row_weight=error_weight,
                                                          all_reduce=error_sum),
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

    def sample_sde(self, model_fn: Callable, *, sampling_method: str = "Euler",
                   diffusion_form: str = "SBDM", diffusion_norm: float = 1.0,
                   last_step: Optional[str] = "Mean", last_step_size: float = 0.04,
                   num_steps: int = 250, stats: Optional[dict] = None) -> Callable:
        """Returns ``sample(x_init, generator=None, noise=None, **model_kwargs)
        -> x_final``: Euler-Maruyama (``Euler``) or stochastic Heun
        (``Heun``) over the SDE drift f + g * score, then the last step
        ``Mean`` (x + (f + g score) * last_step_size), ``Tweedie`` (x /
        alpha(t1) + sigma(t1)^2 / alpha(t1) * score), ``Euler`` (x + f *
        last_step_size) or None (no last step, and t1 = 1). ``noise`` [num_steps
        - 1, *x.shape] replaces the per-step draws from ``generator``. Each
        SDE drift evaluates the model once. An unknown method or last step
        raises."""
        if sampling_method not in ("Euler", "Heun"):
            raise NotImplementedError(f"SDE sampling_method={sampling_method!r}: the SDE "
                                      "samplers are Euler, Heun")
        if last_step not in (None, "Mean", "Tweedie", "Euler"):
            raise NotImplementedError(f"last_step={last_step!r}: Mean, Tweedie, Euler or None")
        transport, plan = self.transport, self.transport.plan
        drift = transport.drift_fn(model_fn)
        score = transport.score_fn(model_fn)

        def diffusion(x, t):
            return plan.diffusion(x, t, form=diffusion_form, norm=diffusion_norm)

        def sde_drift(x, t, **kw):
            # one model evaluation feeds both the drift and the score (the
            # JAX expression calls the model twice with the same inputs)
            out = model_fn(x, t, **kw)
            once = lambda *_, **__: out  # noqa: E731
            return (transport.drift_fn(once)(x, t)
                    + diffusion(x, t) * transport.score_fn(once)(x, t))

        if last_step is None:
            last_step_size = 0.0
        t0, t1 = transport.check_interval(sde=True, eval=True, diffusion_form=diffusion_form,
                                          last_step_size=last_step_size)
        solve = integrators.sde_euler_maruyama if sampling_method == "Euler" else \
            integrators.sde_heun

        def last_step_fn(x, t, **kw):
            if last_step == "Mean":
                return x + sde_drift(x, t, **kw) * last_step_size
            if last_step == "Tweedie":
                t1v = torch.tensor(t1, dtype=torch.float32, device=x.device)
                a, s = plan.alpha(t1v)[0], plan.sigma(t1v)[0]
                return x / a + (s**2 / a) * score(x, t, **kw)
            if last_step == "Euler":
                return x + drift(x, t, **kw) * last_step_size
            return x

        def sample(x, generator=None, noise=None, **model_kwargs):
            xs = solve(lambda xx, tt: sde_drift(xx, tt, **model_kwargs), diffusion, x, t0, t1,
                       num_steps, generator=generator, noise=noise, stats=stats)
            tvec = torch.full((x.shape[0],), t1, dtype=torch.float32, device=x.device)
            return last_step_fn(xs, tvec, **model_kwargs)

        return sample

    def sample_ode_likelihood(self, model_fn: Callable, *, sampling_method: str = "dopri5",
                              num_steps: int = 50, atol: float = 1e-6, rtol: float = 1e-3,
                              stats: Optional[dict] = None) -> Callable:
        """Returns ``sample(x_data, generator=None, eps=None, **model_kwargs)
        -> (log p [B], z)``: the Hutchinson estimate with a Rademacher ``eps``
        (drawn from ``generator`` unless given), integrating the pair (x,
        log p) from the data to the noise with dopri5, euler or heun; the
        divergence is eps . (J eps) by ``torch.func.jvp``. Forward-mode AD
        does not pass the hand-written kernels (their wrappers refuse a
        tangent): run the model with ``fused_block`` off and attention over
        at most 512 keys, where a tangent takes the dense route on any
        device."""
        t0, t1 = self.transport.check_interval(sde=False, eval=True)
        solvers = {
            "euler": lambda f, s: integrators.ode_euler(f, s, t0, t1, num_steps, stats=stats),
            "heun": lambda f, s: integrators.ode_heun(f, s, t0, t1, num_steps, stats=stats),
            "dopri5": lambda f, s: integrators.ode_dopri5(f, s, t0, t1, rtol=rtol, atol=atol,
                                                          stats=stats),
        }
        if sampling_method not in solvers:
            raise NotImplementedError(f"sampling_method={sampling_method!r}: the likelihood "
                                      f"solvers are {', '.join(solvers)}")
        solve = solvers[sampling_method]
        drift = self.transport.drift_fn(model_fn)

        def sample(x_data, generator=None, eps=None, **model_kwargs):
            if eps is None:
                eps = torch.randint(0, 2, x_data.shape, generator=generator,
                                    device=x_data.device).to(x_data.dtype) * 2 - 1
            dims = tuple(range(1, x_data.ndim))

            def aug_drift(state, t):
                x, _ = state
                rev_t = 1 - t
                fx, jvp = torch.func.jvp(lambda xx: drift(xx, rev_t, **model_kwargs), (x,),
                                         (eps,))
                return -fx, (jvp * eps).sum(dims)

            init = (x_data, x_data.new_zeros(x_data.shape[0]))
            z, delta_logp = solve(aug_drift, init)
            prior_logp = -0.5 * z[0].numel() * math.log(2 * math.pi) - 0.5 * z.square().sum(dims)
            return prior_logp - delta_logp, z

        return sample
