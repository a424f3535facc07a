"""The port's SDE and likelihood samplers against the JAX package's, on the
CPU: every ``diffusion`` form, the parametrization converters and
``Transport.score_fn`` on each path; Euler-Maruyama and stochastic Heun
through ``Sampler.sample_sde`` with each last step (Mean, Tweedie, Euler,
None), given the JAX sampler's own noise (its ``jax.random.split`` chain,
redrawn here); and ``Sampler.sample_ode_likelihood`` under dopri5, euler
and heun, given JAX's Rademacher eps, with the drift evaluations counted on
both sides (JAX under ``jax.disable_jit()``). Last, forward-mode AD and the
hand-written kernels: every kernel wrapper refuses a tangent (here on the
CPU, where it would take the plain twin), and the likelihood of the tiny
denoiser runs on the dense route and matches JAX's.

Tolerances, set from the dtype and held by a margin over what was
measured here: the schedules and converters 1e-6 relative (f32 elementwise
math; measured bit-equal); the samplers 1e-5 relative to the largest entry,
as the ODE samplers (``test_torch_transport.py``): SBDM's diffusion is
about 600 at t0 = 1e-3, so the first steps amplify last-digit differences
of the two frameworks' sin, cos and tan (measured at most 3.1e-7 of the
largest entry); the likelihood 1e-5 (measured 4.8e-7 in z, log p equal);
the tiny model's likelihood 1e-4 (a model's f32 sums in another order and
its JVP; measured 2.4e-7 in z, log p equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from mdgen_tpu.transport.transport import Sampler as JaxSampler
from mdgen_tpu.transport.transport import Transport as JaxTransport
from mdgen_tpu.transport.transport import TransportConfig as JaxTransportConfig
from mdgen_tpu_torch import ops
from mdgen_tpu_torch.transport import Sampler, Transport, TransportConfig

PATHS = ["Linear", "GVP", "VP"]
FORMS = ["constant", "SBDM", "sigma", "linear", "decreasing", "increasing-decreasing"]


def _both(path="GVP", prediction="velocity", **kw):
    return (JaxTransport(JaxTransportConfig(path_type=path, prediction=prediction, **kw)),
            Transport(TransportConfig(path_type=path, prediction=prediction, **kw)))


def _x_t(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, 4, 5)).astype(np.float32),
            np.asarray([0.1, 0.5, 0.93], np.float32))


@pytest.mark.parametrize("path", PATHS)
def test_diffusion_forms_match_jax(path):
    jt, tt = _both(path)
    x, t = _x_t()
    for form in FORMS:
        for norm in (1.0, 0.7):
            want = np.asarray(jt.plan.diffusion(jnp.asarray(x), jnp.asarray(t), form, norm))
            got = tt.plan.diffusion(torch.from_numpy(x), torch.from_numpy(t), form, norm)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{form} {norm}")
    with pytest.raises(NotImplementedError, match="diffusion form"):
        tt.plan.diffusion(torch.from_numpy(x), torch.from_numpy(t), "cosine")


@pytest.mark.parametrize("path", PATHS)
def test_converters_and_score_fn_match_jax(path):
    x, t = _x_t(1)
    v = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jt, tt = _both(path)
    jx, jtt, jv = jnp.asarray(x), jnp.asarray(t), jnp.asarray(v)
    tx, ttt, tv = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(v)
    for name in ("score_from_velocity", "noise_from_velocity", "velocity_from_score"):
        want = np.asarray(getattr(jt.plan, name)(jv, jx, jtt))
        got = getattr(tt.plan, name)(tv, tx, ttt).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    for prediction in ("velocity", "score", "noise"):
        jt, tt = _both(path, prediction)
        want = np.asarray(jt.score_fn(lambda x, t: 0.5 * x + jv)(jx, jtt))
        got = tt.score_fn(lambda x, t: 0.5 * x + tv)(tx, ttt).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                   err_msg=prediction)


def _counted(fn):
    def wrapped(x, t):
        wrapped.calls += 1
        return fn(x, t)

    wrapped.calls = 0
    return wrapped


def _linear_fields():
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    b = (rng.normal(size=(5,)) * 0.1).astype(np.float32)
    a = np.float32(-0.7)
    return (x0, _counted(lambda x, t: a * x + t[:, None, None, None] * jnp.asarray(b)),
            _counted(lambda x, t: a * x + t[:, None, None, None] * torch.from_numpy(b)))


def _jax_sde_noise(key, num_steps, shape):
    """The per-step draws of the JAX SDE scan: key, sub = split(key)."""
    out = []
    for _ in range(num_steps - 1):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return torch.from_numpy(np.stack(out))


SDE_CASES = [("GVP", "velocity", "SBDM", method, last)
             for method in ("Euler", "Heun") for last in ("Mean", "Tweedie", "Euler", None)]
SDE_CASES += [("Linear", "noise", "sigma", "Euler", "Mean"),
              ("VP", "score", "SBDM", "Heun", "Tweedie"),
              ("GVP", "velocity", "increasing-decreasing", "Euler", "Euler")]


@pytest.mark.parametrize("path,prediction,form,method,last", SDE_CASES,
                         ids=["-".join(map(str, c)) for c in SDE_CASES])
def test_sde_sampler_matches_jax(path, prediction, form, method, last):
    x0, jf, tf = _linear_fields()
    jt, tt = _both(path, prediction, sample_eps=1e-3)
    kw = dict(sampling_method=method, diffusion_form=form, last_step=last, num_steps=6)
    key = jax.random.PRNGKey(5)
    with jax.disable_jit():
        ref = np.asarray(JaxSampler(jt).sample_sde(jf, **kw)(key, jnp.asarray(x0)))
    stats = {}
    out = Sampler(tt).sample_sde(tf, stats=stats, **kw)(
        torch.from_numpy(x0), noise=_jax_sde_noise(key, 6, x0.shape)).numpy()
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0.1
    # the grid's SDE drifts (Heun: two a step) and the last step: the port
    # evaluates the model once a drift, where the JAX expression calls it for
    # the drift and again for the score
    assert stats["evals"] == (5 if method == "Euler" else 10)
    assert tf.calls == stats["evals"] + (last is not None)
    assert jf.calls == 2 * stats["evals"] + {"Mean": 2, "Tweedie": 1, "Euler": 1, None: 0}[last]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_sde_sampler_draws_from_its_generator():
    x0, _, tf = _linear_fields()
    _, tt = _both(sample_eps=1e-3)
    fn = Sampler(tt).sample_sde(tf, num_steps=5)
    a, b = (fn(torch.from_numpy(x0), generator=torch.Generator().manual_seed(s)) for s in (0, 0))
    c = fn(torch.from_numpy(x0), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_unknown_sde_options_raise():
    _, tt = _both()
    with pytest.raises(NotImplementedError, match="SDE samplers are Euler, Heun"):
        Sampler(tt).sample_sde(lambda x, t: x, sampling_method="euler")
    with pytest.raises(NotImplementedError, match="last_step"):
        Sampler(tt).sample_sde(lambda x, t: x, last_step="Heun")
    with pytest.raises(NotImplementedError, match="likelihood solvers are euler, heun, dopri5"):
        Sampler(tt).sample_ode_likelihood(lambda x, t: x, sampling_method="rk4")


def _tanh_fields():
    """A nonlinear field (its divergence depends on x): tanh(x W) + t."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 5)).astype(np.float32)
    W = (rng.normal(size=(5, 5)) * 0.5).astype(np.float32)
    jW, tW = jnp.asarray(W), torch.from_numpy(W)
    return (x, _counted(lambda x, t: jnp.tanh(x @ jW) + t[:, None, None]),
            _counted(lambda x, t: torch.tanh(x @ tW) + t[:, None, None]))


def _jax_eps(key, shape):
    return np.array(jax.random.randint(key, shape, 0, 2).astype(jnp.float32) * 2 - 1)


@pytest.mark.parametrize("method", ["dopri5", "euler", "heun"])
def test_likelihood_matches_jax(method):
    x, jf, tf = _tanh_fields()
    jt, tt = _both()
    key = jax.random.PRNGKey(9)
    with jax.disable_jit():
        logp_j, z_j = JaxSampler(jt).sample_ode_likelihood(
            jf, sampling_method=method, num_steps=8)(key, jnp.asarray(x))
    stats = {}
    logp, z = Sampler(tt).sample_ode_likelihood(tf, sampling_method=method, num_steps=8,
                                                stats=stats)(
        torch.from_numpy(x), eps=torch.from_numpy(_jax_eps(key, x.shape)))
    assert tf.calls == jf.calls == stats["evals"] and stats["reached_t1"]
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), rtol=1e-5)


def test_likelihood_draws_rademacher_eps():
    x, _, tf = _tanh_fields()
    _, tt = _both()
    fn = Sampler(tt).sample_ode_likelihood(tf, sampling_method="euler", num_steps=3)
    a = fn(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))[0]
    b = fn(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))[0]
    assert torch.equal(a, b) and torch.isfinite(a).all()


def _kernel_calls(dual):
    """Each kernel wrapper called with ``dual`` in the place of its first
    tensor (the CPU shapes of the twins)."""
    h = torch.randn(1, 2, 3, 8)
    m = torch.zeros(1, 1, 8)
    w, b, kv = torch.randn(24, 8), torch.zeros(24), torch.zeros(8)
    ow, ob = torch.randn(8, 8), torch.zeros(8)
    f1, f2 = torch.randn(32, 8), torch.randn(8, 32)
    q = torch.randn(2, 5, 4)
    bias, lse, delta = torch.zeros(2, 5), torch.zeros(2, 5), torch.zeros(2, 5)
    attn = dict(num_heads=2, compute_dtype=torch.float32)
    return {
        "fused_l_sublayer": lambda: ops.fused_l_sublayer(dual(h), m, m, m, torch.ones(1, 3), w, b,
                                                         kv, kv, ow, ob, **attn),
        "fused_t_sublayer": lambda: ops.fused_t_sublayer(dual(h), m, m, m, torch.ones(1, 3), w, b,
                                                         kv, kv, ow, ob, **attn),
        "fused_ffn_sublayer": lambda: ops.fused_ffn_sublayer(dual(h), m, m, m, f1, torch.zeros(32),
                                                             f2, kv, compute_dtype=torch.float32),
        "flash_fwd": lambda: ops.flash_fwd(dual(q), q, q, bias),
        "flash_fwd_lse": lambda: ops.flash_fwd_lse(dual(q), q, q, bias),
        "flash_bwd_dq": lambda: ops.flash_bwd_dq(dual(q), q, q, bias, q, lse, delta),
        "flash_bwd_dkv": lambda: ops.flash_bwd_dkv(dual(q), q, q, bias, q, lse, delta),
        "flash_attention": lambda: ops.flash_attention(dual(q), q, q, bias),
    }


def test_kernel_wrappers_refuse_a_forward_mode_tangent():
    """Under ``torch.func.jvp`` and with a ``forward_ad`` dual tensor each of
    the seven kernels' wrappers (and the flash dispatcher) raises, on the CPU
    too; outside, the same calls run."""
    for name, call in _kernel_calls(lambda t: t).items():
        out = call()
        assert torch.isfinite(out[0] if isinstance(out, tuple) else out).all(), name
    for name in _kernel_calls(lambda t: t):
        primal = torch.randn(1, 2, 3, 8) if name.startswith("fused") else torch.randn(2, 5, 4)
        with pytest.raises(RuntimeError, match="no forward-mode derivative"):
            torch.func.jvp(lambda t, _n=name: _kernel_calls(lambda _: t)[_n](), (primal,),
                           (torch.ones_like(primal),))
    with forward_ad.dual_level():
        for name, call in _kernel_calls(
                lambda t: forward_ad.make_dual(t, torch.ones_like(t))).items():
            with pytest.raises(RuntimeError, match="no forward-mode derivative"):
                call()


def test_tangent_probes_fail_loudly_without_torch_internals():
    """The refusal's private torch internals are resolved once, at import: a
    torch that lacks one raises an ImportError naming them, not an
    AttributeError in a kernel call."""
    from types import SimpleNamespace

    from mdgen_tpu_torch.ops import _common

    fc = torch._C._functorch
    peek, wrapped = _common.tangent_probes()
    assert peek is fc.peek_interpreter_stack and wrapped is fc.is_functorch_wrapped_tensor
    complete = dict(peek_interpreter_stack=peek, is_functorch_wrapped_tensor=wrapped)
    for missing in complete:
        partial = SimpleNamespace(**{k: v for k, v in complete.items() if k != missing})
        with pytest.raises(ImportError, match="refuse forward-mode AD"):
            _common.tangent_probes(fc=partial)
    with pytest.raises(ImportError, match="_current_level"):
        _common.tangent_probes(fwd=SimpleNamespace())


def test_model_likelihood_runs_dense_and_matches_jax():
    """The tiny denoiser's log-likelihood (euler, 3 steps, JAX's eps): the
    dense model matches JAX's; with fused_block the fused twins refuse the
    tangent instead of dropping it."""
    from mdgen_tpu.models import LatentMDGenModel as JaxModel
    from tests.test_torch_model import TINY, _port, _setup

    cfg, params, prep_j, prep, x, _ = _setup(dict(TINY, num_layers=1))
    key = jax.random.PRNGKey(2)
    model = JaxModel(cfg, cfg.latent_dim)

    def jax_lik(key, x):
        fn = lambda xx, tt, **kw: model.apply({"params": params}, xx, tt, **kw)  # noqa: E731
        return JaxSampler(JaxTransport(JaxTransportConfig())).sample_ode_likelihood(
            fn, sampling_method="euler", num_steps=3)(key, x, **prep_j.model_kwargs)

    with jax.default_matmul_precision("highest"):
        logp_j, z_j = jax.jit(jax_lik)(key, jnp.asarray(x))
    eps = torch.from_numpy(_jax_eps(key, x.shape))
    lik = Sampler(Transport(TransportConfig())).sample_ode_likelihood
    port = _port(cfg, params)
    with torch.no_grad():
        logp, z = lik(port, sampling_method="euler", num_steps=3)(
            torch.from_numpy(x), eps=eps, **prep.model_kwargs)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), rtol=1e-4)
    fused = _port(cfg.replace(fused_block=True), params)
    with torch.no_grad(), pytest.raises(RuntimeError, match="no forward-mode derivative"):
        lik(fused, sampling_method="euler", num_steps=3)(
            torch.from_numpy(x), eps=eps, **prep.model_kwargs)
