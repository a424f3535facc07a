"""Parity of the port's transport (plans, sampling interval, probability-flow
drift and the Euler, Heun and dopri5 samplers) with the JAX package, for
every path type and prediction, on a fixed linear vector field given to both
as the model.

Tolerance 1e-5: f32 elementwise math in the same order over 5 Euler steps;
the score and noise drifts divide by tan and sigma near the interval's ends,
which amplifies the last-digit differences of the two frameworks' sin, cos
and tan. The adaptive dopri5 solver must also take the same steps: the JAX
solver runs under ``jax.disable_jit()``, where its ``lax.while_loop`` runs
eagerly, so a Python counter in its drift counts its evaluations, which
must equal the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_tpu.transport import integrators as jax_integrators
from mdgen_tpu.transport.transport import Sampler as JaxSampler
from mdgen_tpu.transport.transport import Transport as JaxTransport
from mdgen_tpu.transport.transport import TransportConfig as JaxTransportConfig
from mdgen_tpu_torch.transport import Sampler, Transport, TransportConfig
from mdgen_tpu_torch.transport import integrators

PATHS = ["Linear", "GVP", "VP"]
PREDICTIONS = ["velocity", "score", "noise"]


def _fields():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    a = np.float32(-0.7)
    b = rng.normal(size=(5,)).astype(np.float32) * 0.1
    jax_fn = lambda x, t: a * x + t[:, None, None, None] * jnp.asarray(b)  # noqa: E731
    torch_fn = lambda x, t: a * x + t[:, None, None, None] * torch.from_numpy(b)  # noqa: E731
    return x0, jax_fn, torch_fn


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("prediction", PREDICTIONS)
@pytest.mark.parametrize("path_type", PATHS)
def test_euler_sample_matches_jax(path_type, prediction, reverse):
    x0, jax_fn, torch_fn = _fields()
    jt = JaxTransport(JaxTransportConfig(path_type=path_type, prediction=prediction))
    tt = Transport(TransportConfig(path_type=path_type, prediction=prediction))
    kw = dict(sampling_method="euler", num_steps=6, reverse=reverse)
    ref = np.asarray(JaxSampler(jt).sample_ode(jax_fn, **kw)(jnp.asarray(x0)))
    out = Sampler(tt).sample_ode(torch_fn, **kw)(torch.from_numpy(x0)).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prediction", PREDICTIONS)
@pytest.mark.parametrize("path_type", PATHS)
def test_check_interval_matches_jax(path_type, prediction):
    jt = JaxTransport(JaxTransportConfig(path_type=path_type, prediction=prediction))
    tt = Transport(TransportConfig(path_type=path_type, prediction=prediction))
    for kw in (dict(), dict(eval=True), dict(sde=True), dict(sde=True, eval=True),
               dict(sde=True, diffusion_form="sigma", last_step_size=0.04),
               dict(eval=True, reverse=True)):
        assert tt.check_interval(**kw) == pytest.approx(jt.check_interval(**kw)), kw


def test_unported_samplers_raise():
    """Euler, Heun and dopri5 are the ODE samplers; any other method raises
    and never falls back to one of them."""
    tt = Transport(TransportConfig())
    for method in ("rk4", "Euler", "dopri8"):
        with pytest.raises(NotImplementedError, match="samplers are euler, heun, dopri5"):
            Sampler(tt).sample_ode(lambda x, t: x, sampling_method=method)


def _counted(fn):
    """fn with a call counter (``fn.calls``)."""
    def wrapped(x, t):
        wrapped.calls += 1
        return fn(x, t)

    wrapped.calls = 0
    return wrapped


# (rate, forcing, t0, t1): dx/dt = rate * x + sin(forcing * t) * b. "linear"
# takes the first dt (0.01 of the span) and grows it; "rejected" is stiff
# enough that its first attempts fail (rate * dt = -3) and dt shrinks
DOPRI_CASES = {"linear": (-0.7, 3.0, 0.0, 1.0), "rejected": (-300.0, 20.0, 0.0, 1.0),
               "reverse_span": (-0.7, 3.0, 1.0, 0.0)}


def _solver_fields(rate, forcing):
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    a, f = np.float32(rate), np.float32(forcing)
    b = rng.normal(size=(5,)).astype(np.float32)
    jax_fn = lambda x, t: a * x + jnp.sin(f * t)[:, None, None, None] * jnp.asarray(b)  # noqa: E731
    torch_fn = lambda x, t: a * x + torch.sin(f * t)[:, None, None, None] * torch.from_numpy(b)  # noqa: E731
    return x0, jax_fn, torch_fn


def _run_both(solver, case, **kw):
    rate, forcing, t0, t1 = DOPRI_CASES[case]
    x0, jax_fn, torch_fn = _solver_fields(rate, forcing)
    jf = _counted(jax_fn)
    with jax.disable_jit():
        ref = np.asarray(getattr(jax_integrators, solver)(jf, jnp.asarray(x0), t0, t1, **kw))
    tf, stats = _counted(torch_fn), {}
    out = getattr(integrators, solver)(tf, torch.from_numpy(x0), t0, t1, stats=stats, **kw)
    return ref, out.numpy(), jf.calls, tf.calls, stats


@pytest.mark.parametrize("case", list(DOPRI_CASES))
def test_dopri5_matches_jax(case):
    ref, out, jax_calls, calls, stats = _run_both("ode_dopri5", case)
    assert np.isfinite(ref).all()
    assert calls == jax_calls == stats["evals"] == 1 + 6 * stats["attempts"]
    assert stats["reached_t1"] and stats["t_final"] == DOPRI_CASES[case][3]
    assert stats["accepted"] + stats["rejected"] == stats["attempts"]
    assert (stats["rejected"] > 0) == (case == "rejected"), stats
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["linear", "reverse_span"])
def test_heun_matches_jax(case):
    ref, out, jax_calls, calls, stats = _run_both("ode_heun", case, num_steps=6)
    assert calls == jax_calls == stats["evals"] == 10
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_dopri5_max_steps_exhaustion_is_flagged():
    """With the attempts spent before t1, both return x at t < t1; the port's
    stats say so."""
    ref, out, jax_calls, calls, stats = _run_both("ode_dopri5", "rejected", max_steps=4)
    assert calls == jax_calls == 1 + 6 * 4
    assert stats["attempts"] == 4 and not stats["reached_t1"] and stats["t_final"] < 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("method", ["heun", "dopri5"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_sampler_ode_methods_match_jax(method, reverse):
    """Heun and dopri5 through ``Sampler.sample_ode`` (GVP, velocity), the
    drift counted on both sides."""
    x0, jax_fn, torch_fn = _fields()
    jf, tf, stats = _counted(jax_fn), _counted(torch_fn), {}
    kw = dict(sampling_method=method, num_steps=6, reverse=reverse)
    with jax.disable_jit():
        ref = np.asarray(JaxSampler(JaxTransport(JaxTransportConfig())).sample_ode(jf, **kw)(
            jnp.asarray(x0)))
    out = Sampler(Transport(TransportConfig())).sample_ode(tf, stats=stats, **kw)(
        torch.from_numpy(x0)).numpy()
    assert tf.calls == jf.calls == stats["evals"]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
