"""The port's Hyena frame mixer (``mdgen_tpu_torch/models/hyena.py``) against
the JAX package's, on the CPU: ``fftconv``, the implicit filter, the
operator, the tiny denoiser with ``--hyena`` (dense and with the fused
twins, f32 and the bf16 serving cast), the weight converter on its
parameter tree (its train steps: ``test_torch_train.py``, case
``T8_dense_hyena``).

Tolerances, from the errors measured here (JAX's CPU FFT and torch's
pocketfft round the f32 transforms differently): ``fftconv`` 1e-5 absolute
on outputs up to 12.4 (measured 1.9e-6; a bf16 input comes back bit-equal),
the operator 1e-5 (measured 1.7e-6 on outputs up to 4.8), the filter 1e-6
(no FFT; measured 1.2e-7); the model 2e-4 as the other model tests (five
residual layers of sums in another order; measured 2.4e-7), 0.05 under the
bf16 serving cast (measured 4.6e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_tpu.config import MDGenConfig
from mdgen_tpu.models import hyena as jax_hyena
from mdgen_tpu.runtime.wrapper import _inference_param_cast
from mdgen_tpu_torch import ops
from mdgen_tpu_torch.interop import jax_params_to_state_dict
from mdgen_tpu_torch.models import hyena
from mdgen_tpu_torch.models import latent_model
from mdgen_tpu_torch.runtime.wrapper import inference_param_cast
from tests.test_torch_model import TINY, _jax_forward, _port, _port_forward, _setup

HYENA = dict(TINY, hyena=True, num_frames=12)


def _noised(params, seed):
    noise = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * noise.normal(size=p.shape).astype(np.float32), params)


@pytest.mark.parametrize("L", [16, 13, 1])
def test_fftconv_matches_jax(L):
    rng = np.random.default_rng(L)
    u = rng.normal(size=(2, 8, L)).astype(np.float32)
    k = rng.normal(size=(8, L)).astype(np.float32)
    D = rng.normal(size=(8,)).astype(np.float32)
    want = np.asarray(jax_hyena.fftconv(jnp.asarray(u), jnp.asarray(k), jnp.asarray(D)))
    got = hyena.fftconv(torch.from_numpy(u), torch.from_numpy(k), torch.from_numpy(D))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # a bf16 input is transformed in f32 and comes back in bf16, as in JAX
    ub = torch.from_numpy(u).bfloat16()
    want_b = jax_hyena.fftconv(jnp.asarray(ub.float().numpy()).astype(jnp.bfloat16),
                               jnp.asarray(k), jnp.asarray(D))
    got_b = hyena.fftconv(ub, torch.from_numpy(k), torch.from_numpy(D))
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(), np.asarray(want_b, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_positional_embedding_is_the_jax_table():
    for emb, n in ((3, 24), (5, 7)):
        for got, want in zip(hyena.positional_embedding(emb, n),
                             jax_hyena.positional_embedding(emb, n)):
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def operator():
    """A JAX HyenaOperator (C 32, l_max 24, filter width 16) with noised
    parameters and the port's operator loaded from them."""
    C, l_max = 32, 24
    x = np.random.default_rng(0).normal(size=(3, l_max, C)).astype(np.float32)
    jop = jax_hyena.HyenaOperator(d_model=C, l_max=l_max, order=2, filter_order=16)
    params = _noised(jax.jit(jop.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    op = hyena.HyenaOperator(C, l_max=l_max, order=2, filter_order=16)
    op.load_state_dict(jax_params_to_state_dict(params))  # strict: every name maps
    return jop, params, op


@pytest.mark.parametrize("T", [24, 17])
def test_filter_and_operator_match_jax(operator, T):
    jop, params, op = operator
    x = np.random.default_rng(T).normal(size=(3, T, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jop.apply)({"params": params}, jnp.asarray(x)))
        filt = jax_hyena.HyenaFilter(d_model=32, order=16, seq_len=24)
        k_want = np.asarray(jax.jit(lambda p: filt.apply({"params": p}, T, method=filt.filter))(
            params["filter_fn"]))
    with torch.no_grad():
        k_got = op.filter_fn.filter(T).numpy()
        got = op(torch.from_numpy(x)).numpy()
    assert k_got.shape == (1, T, 32)
    np.testing.assert_allclose(k_got, k_want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_converter_carries_the_hyena_tree(operator):
    _, params, op = operator
    sd = jax_params_to_state_dict(params)
    assert set(sd) == set(op.state_dict())
    kernel = np.asarray(params["short_filter"]["kernel"])  # flax Conv [3, 1, inner]
    assert kernel.shape == (3, 1, 96)
    np.testing.assert_array_equal(sd["short_filter.weight"].numpy(), kernel.T)
    assert tuple(op.short_filter.weight.shape) == (96, 1, 3)  # conv1d [out, in/groups, k]
    for i in range(3):
        assert sd[f"filter_fn.sin_freq_{i}"].shape == (1, 16)
    assert sd["filter_fn.mlp_0.weight"].shape == (16, 3)
    assert "filter_fn.mlp_out.bias" not in sd and sd["filter_fn.bias"].shape == (32,)


@pytest.fixture(scope="module")
def model_case():
    return _setup(HYENA)


def test_model_matches_jax_dense_and_fused(model_case, monkeypatch):
    """The tiny denoiser with --hyena, with the same weights: dense, and with
    fused_block, where the residue and MLP sublayers take the fused twins
    and the frame sublayer stays the Hyena operator (no frame kernel)."""
    cfg, params, prep_j, prep, x, t = model_case
    ref = _jax_forward(cfg, params, prep_j, x, t)
    assert np.abs(ref).max() > 1e-2
    calls = []
    for name in ("fused_l_sublayer", "fused_t_sublayer", "fused_ffn_sublayer"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    for fused in (False, True):
        calls.clear()
        model = _port(cfg.replace(fused_block=fused), params)
        assert isinstance(model.layers[0].mha_t, hyena.HyenaOperator)
        out = _port_forward(model, prep, x, t)
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4, err_msg=f"fused={fused}")
        want = ["fused_l_sublayer", "fused_ffn_sublayer"] * cfg.num_layers if fused else []
        assert calls == want


def test_serving_precision_matches_jax(model_case):
    cfg, params, prep_j, prep, x, t = model_case
    cfg = cfg.replace(precision="bf16-mixed")
    ref = _jax_forward(cfg, _inference_param_cast(cfg, params), prep_j, x, t)
    model = inference_param_cast(cfg, _port(cfg, params))
    out = _port_forward(model, prep, x, t)
    np.testing.assert_allclose(out, ref, rtol=0.05, atol=0.05)


def test_model_converter_round_trip(model_case):
    cfg, params, *_ = model_case
    sd = jax_params_to_state_dict(params)
    assert set(sd) == set(latent_model.LatentMDGenModel(cfg, cfg.latent_dim).state_dict())
    assert sd["layers.1.mha_t.in_proj.weight"].shape == (3 * 64, 64)
    assert not any(k.startswith("layers.0.mha_t.qkv_proj") for k in sd)

