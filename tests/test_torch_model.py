"""Whole-denoiser parity: the JAX LatentMDGenModel and the port's, with the
same weights (converted by ``interop.jax_params_to_state_dict``) and the same
inputs, on the CPU. The port runs unfused (dense attention) and fused (the
three sublayers' plain versions).

Tolerance 2e-4 in f32, as the JAX package's own fused-vs-unfused model test:
five residual layers of sums taken in another order. The serving-precision
case (bf16-mixed, weights rounded to bf16 once) is held at 0.05: bf16
rounding happens at the same places, but the two frameworks' bf16 kernels
sum and round intermediate results differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_tpu.config import MDGenConfig
from mdgen_tpu.geometry.rigid import quat_to_rotmat
from mdgen_tpu.models import LatentMDGenModel as JaxModel
from mdgen_tpu.runtime.wrapper import _inference_param_cast
from mdgen_tpu.tasks import prep_batch as jax_prep
from mdgen_tpu_torch.interop import jax_params_to_state_dict
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.runtime.wrapper import inference_param_cast
from mdgen_tpu_torch.tasks import prep_batch

SIM = dict(sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True)
TINY = dict(num_layers=2, embed_dim=64, mha_heads=4, ipa_heads=2, ipa_head_dim=8,
            ipa_qk=2, ipa_v=2, num_frames=6, crop=4, **SIM)
# the bench.py widths (5 x 384 x 16 heads, default IPA), cut to T=16 frames
FULL = dict(num_layers=5, embed_dim=384, mha_heads=16, num_frames=16, crop=4, **SIM)
SIZES = {
    "tiny": TINY,
    "full_width": FULL,
    # the model options the sim configuration can turn off
    "tiny_no_rope_no_aa_emb": dict(TINY, no_rope=True, no_aa_emb=True, abs_time_emb=False),
    "tiny_no_ipa": dict(TINY, prepend_ipa=False, abs_pos_emb=False),
}


def _batch(rng, cfg, B=2):
    T, L = cfg.num_frames, cfg.crop
    q = rng.normal(size=(B, T, L, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mask = np.ones((B, L), np.float32)
    mask[1, -1] = 0.0  # one padded residue
    return {
        "torsions": rng.normal(size=(B, T, L, 7, 2)).astype(np.float32),
        "torsion_mask": np.ones((B, L, 7), np.float32),
        "trans": rng.normal(size=(B, T, L, 3)).astype(np.float32),
        "rots": np.array(quat_to_rotmat(jnp.asarray(q.astype(np.float32)))),
        "seqres": rng.integers(0, 20, size=(B, L)).astype(np.int32),
        "mask": mask,
    }


def _setup(kw, seed=0):
    """Seeded JAX params with noise on every leaf (adaLN-zero would otherwise
    zero every gate and the output head), and matching inputs."""
    cfg = MDGenConfig(**kw)
    rng = np.random.default_rng(seed)
    batch = _batch(rng, cfg)
    prep_j = jax_prep(cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    B, T, L = 2, cfg.num_frames, cfg.crop
    x = rng.normal(size=(B, T, L, cfg.latent_dim)).astype(np.float32)
    t = np.asarray([0.3, 0.7], np.float32)
    params = jax.jit(JaxModel(cfg, cfg.latent_dim).init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), **prep_j.model_kwargs
    )["params"]
    noise = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.03 * noise.normal(size=p.shape).astype(np.float32), params
    )
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["seqres"] = tb["seqres"].long()
    prep = prep_batch(cfg, tb)
    return cfg, params, prep_j, prep, x, t


def _jax_forward(cfg, params, prep_j, x, t):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(JaxModel(cfg, cfg.latent_dim).apply)(
            {"params": params}, jnp.asarray(x), jnp.asarray(t), **prep_j.model_kwargs
        ))


def _port(cfg, params):
    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.load_state_dict(jax_params_to_state_dict(params))  # strict: every name maps
    return model.eval()


def _port_forward(model, prep, x, t):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t), **prep.model_kwargs).numpy()


@pytest.mark.parametrize("size", list(SIZES))
def test_forward_matches_jax_fused_and_unfused(size):
    cfg, params, prep_j, prep, x, t = _setup(SIZES[size])
    ref = _jax_forward(cfg, params, prep_j, x, t)
    assert np.abs(ref).max() > 1e-2  # non-degenerate
    for fused in (False, True):
        c = cfg.replace(fused_block=fused)
        out = _port_forward(_port(c, params), prep, x, t)
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4, err_msg=f"fused={fused}")


def test_serving_precision_matches_jax():
    cfg, params, prep_j, prep, x, t = _setup(TINY, seed=3)
    cfg = cfg.replace(precision="bf16-mixed")
    ref = _jax_forward(cfg, _inference_param_cast(cfg, params), prep_j, x, t)
    model = inference_param_cast(cfg, _port(cfg, params))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.pos_embed.dtype == torch.float32
    out = _port_forward(model, prep, x, t)
    np.testing.assert_allclose(out, ref, rtol=0.05, atol=0.05)


def test_converter_round_trip_names():
    """Every JAX leaf lands on a port parameter of the same size, transposed
    for Dense kernels."""
    cfg, params, *_ = _setup(TINY)
    sd = jax_params_to_state_dict(params)
    model = LatentMDGenModel(cfg, cfg.latent_dim)
    assert set(sd) == set(model.state_dict())
    k = np.asarray(params["layers_0"]["mha_l"]["qkv_proj"]["kernel"])
    np.testing.assert_array_equal(sd["layers.0.mha_l.qkv_proj.weight"].numpy(), k.T)
    assert sd["t_embedder.dense_1.weight"].shape == (64, 64)
    assert sd["layers.1.mha_t.bias_k"].shape == (1, 1, 64)
