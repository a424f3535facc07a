"""The last model options of the JAX package in the port, on the CPU.

* ``interleave_ipa`` (an IPA and its ``ipa_norm`` in every trunk layer,
  over the key frames broadcast along T): the tiny denoiser against JAX's
  with the same weights, dense and with the fused twins (2e-4, as the
  model tests), its flow-matching loss for JAX's draws (1e-5 relative),
  and the converter on its tree.
* ``no_frames`` (the raw-atom37 ablation, 111 latent channels, no frames):
  ``tokenize_no_frames`` and ``prep_batch_no_frames`` (exact, and atoms to
  1e-6), the denoiser dense and fused (2e-4), the loss (1e-5 relative), and
  ``MDGenRuntime.inference``'s atom37 -> atom14 decode after a 3-step
  Euler solve from JAX's own noise (1e-4 A; coordinates of a few A, three
  evaluations of the model).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_tpu.config import MDGenConfig
from mdgen_tpu.models import LatentMDGenModel as JaxModel
from mdgen_tpu.runtime import MDGenRuntime as JaxRuntime
from mdgen_tpu.runtime.wrapper import tokenize_no_frames as jax_tokenize_no_frames
from mdgen_tpu.tasks import prep_batch as jax_prep
from mdgen_tpu.transport import Transport as JaxTransport
from mdgen_tpu.transport import TransportConfig as JaxTransportConfig
from mdgen_tpu_torch.interop import jax_params_to_state_dict
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.runtime import MDGenRuntime, batch_to_device, tokenize
from mdgen_tpu_torch.tasks import prep_batch
from mdgen_tpu_torch.transport import Transport, TransportConfig
from tests.test_torch_model import TINY, _jax_forward, _port, _port_forward, _setup
from tests.test_torch_train import _draws, _raw_batch


def _losses_match(cfg, params, prep_j, prep, seed):
    """The flow-matching loss of both models for JAX's draws of t and x0."""
    key = jax.random.PRNGKey(seed)
    model = JaxModel(cfg, cfg.latent_dim)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda k: JaxTransport(JaxTransportConfig()).training_losses(
            k, lambda x, t, **kw: model.apply({"params": params}, x, t, **kw),
            prep_j.latents, mask=prep_j.loss_mask, model_kwargs=prep_j.model_kwargs)["loss"])(key)
    t, x0 = _draws(key, tuple(prep.latents.shape))
    with torch.no_grad():
        out = Transport(TransportConfig()).training_losses(
            _port(cfg, params), prep.latents, prep.loss_mask, prep.model_kwargs, t=t, x0=x0)
    assert np.all(np.asarray(ref) > 0)
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(ref), rtol=1e-5)


@pytest.fixture(scope="module")
def interleave_case():
    return _setup(dict(TINY, interleave_ipa=True), seed=2)


def test_interleave_ipa_matches_jax_dense_and_fused(interleave_case):
    cfg, params, prep_j, prep, x, t = interleave_case
    ref = _jax_forward(cfg, params, prep_j, x, t)
    assert np.abs(ref).max() > 1e-2
    for fused in (False, True):
        out = _port_forward(_port(cfg.replace(fused_block=fused), params), prep, x, t)
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4, err_msg=f"fused={fused}")


def test_interleave_ipa_loss_and_converter(interleave_case):
    cfg, params, prep_j, prep, *_ = interleave_case
    sd = jax_params_to_state_dict(params)
    assert set(sd) == set(LatentMDGenModel(cfg, cfg.latent_dim).state_dict())
    for i in range(cfg.num_layers):
        assert sd[f"layers.{i}.ipa_norm.weight"].shape == (64,)
        assert sd[f"layers.{i}.ipa.linear_qkv.weight"].shape == (3 * 2 * 8, 64)
    _losses_match(cfg, params, prep_j, prep, seed=3)


NO_FRAMES = dict(sim_condition=True, no_frames=True, abs_pos_emb=True, abs_time_emb=True,
                 num_layers=2, embed_dim=64, mha_heads=4, num_frames=6, crop=4,
                 sampling_method="euler", inference_steps=3)


@pytest.fixture(scope="module")
def no_frames_case():
    cfg = MDGenConfig(**NO_FRAMES)
    raw = _raw_batch(cfg.num_frames)  # 2 tetrapeptides, one padded residue
    tok_j = jax_tokenize_no_frames({k: jnp.asarray(v) for k, v in raw.items()})
    prep_j = jax_prep(cfg, tok_j)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 4, 111)).astype(np.float32)
    t = np.asarray([0.3, 0.7], np.float32)
    params = jax.jit(JaxModel(cfg, cfg.latent_dim).init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), **prep_j.model_kwargs)["params"]
    noise = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.03 * noise.normal(size=p.shape).astype(np.float32), params)
    batch = batch_to_device(raw, "cpu")
    tok = tokenize(cfg, batch)
    return cfg, raw, batch, tok_j, tok, params, prep_j, prep_batch(cfg, tok), x, t


def test_no_frames_tokens_and_prep_match_jax(no_frames_case):
    cfg, raw, batch, tok_j, tok, params, prep_j, prep, *_ = no_frames_case
    assert cfg.latent_dim == 111 and set(tok) == {"atom37", "seqres", "mask"}
    np.testing.assert_allclose(tok["atom37"].numpy(), np.asarray(tok_j["atom37"]), atol=1e-6)
    np.testing.assert_array_equal(tok["mask"].numpy(), np.asarray(tok_j["mask"]))
    assert prep.rigids is None and prep.latents.shape == (2, 6, 4, 111)
    np.testing.assert_allclose(prep.latents.numpy(), np.asarray(prep_j.latents), atol=1e-6)
    np.testing.assert_array_equal(prep.loss_mask.numpy(), np.asarray(prep_j.loss_mask))
    for key in ("mask", "aatype", "x_cond_mask"):
        np.testing.assert_array_equal(prep.model_kwargs[key].numpy(),
                                      np.asarray(prep_j.model_kwargs[key]), err_msg=key)
    np.testing.assert_allclose(prep.model_kwargs["x_cond"].numpy(),
                               np.asarray(prep_j.model_kwargs["x_cond"]), atol=1e-6)
    assert set(prep.model_kwargs) == set(prep_j.model_kwargs)


def test_no_frames_model_and_loss_match_jax(no_frames_case):
    cfg, raw, batch, tok_j, tok, params, prep_j, prep, x, t = no_frames_case
    ref = _jax_forward(cfg, params, prep_j, x, t)
    assert ref.shape == (2, 6, 4, 111) and np.abs(ref).max() > 1e-2
    for fused in (False, True):
        out = _port_forward(_port(cfg.replace(fused_block=fused), params), prep, x, t)
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4, err_msg=f"fused={fused}")
    _losses_match(cfg, params, prep_j, prep, seed=6)


def test_no_frames_inference_decodes_atom37_like_jax(no_frames_case):
    cfg, raw, batch, tok_j, tok, params, *_ = no_frames_case
    key = jax.random.PRNGKey(7)
    jrt = JaxRuntime(cfg)
    with jax.default_matmul_precision("highest"):
        want, aa_j = jrt.inference(params, {k: jnp.asarray(v) for k, v in raw.items()}, key)
    k_cont, _ = jax.random.split(key)
    noise = torch.from_numpy(np.asarray(jax.random.normal(k_cont, (2, 6, 4, 111))).copy())
    got, aa = MDGenRuntime(cfg, _port(cfg, params)).inference(batch, noise=noise)
    assert got.shape == (2, 6, 4, 14, 3)
    np.testing.assert_array_equal(aa.numpy(), np.asarray(aa_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
