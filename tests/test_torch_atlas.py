"""The ATLAS protein recipe in the port against the JAX package, on the CPU.

* The dataset: for the same generator state both datasets draw the same
  replica ``_R1..3``, frame start and crop start, and give the same item:
  a random crop of a chain longer than ``crop`` (from its start: a zero,
  mask-0 left-context column; from inside: the previous residue), and a
  shorter chain padded to ``crop`` behind its context column. Exact.
* The tokens of such items with the context column dropped
  (``tokenize_atom14(drop_left_context=True)``, chosen by the runtime when
  an ATLAS batch is ``crop + 1`` wide): frames and torsion masks to 1e-5
  (geometry, as ``test_torch_geometry.py``), the torsions where defined
  (the first residue keeps its phi and omega when a real context residue
  precedes it, and loses them at the chain's start).
* Gradient checkpointing and dropout: one ATLAS train step with
  ``grad_checkpointing`` equals the plain one for the same draws (t, x0,
  the dropout seed), loss and every gradient bit for bit, with dropout 0.1
  and without; the recompute draws the same masks.
* Dropout against JAX: with no dropout seed (validation, serving) the
  model equals JAX's model applied without a dropout rng (2e-4, as the
  model tests); with one, it equals JAX's model applied with its Bernoulli
  draws replaced by the port's masks, in call order: the JAX formula
  ``p * mask / keep`` on the port's masks (2e-4).
* The residue-axis attention past 512 keys (sampling a long protein) takes
  the flash route with contiguous rows and a masked padding residue, and
  equals the dense route (1e-5).
* A config with dropout and grad_checkpointing serves as it trains.
* The flash route in a checkpointed ATLAS train step (forced here by the
  CPU rule's crossover, which the card's replaces): every residue and frame
  attention of the trunk calls the forward twin twice (the forward and the
  recompute) and the backward twins once, the tower's residue attention
  once each; loss and gradients equal the dense route's (1e-5, 1e-5
  relative to each gradient's largest entry: f32 sums in another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_tpu.config import MDGenConfig as JaxConfig
from mdgen_tpu.data.dataset import MDGenDataset as JaxDataset
from mdgen_tpu.models import LatentMDGenModel as JaxModel
from mdgen_tpu.runtime.wrapper import tokenize_atom14 as jax_tokenize
from mdgen_tpu_torch.config import MDGenConfig
from mdgen_tpu_torch.data import MDGenDataset, synthetic_trajectory
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.models import layers
from mdgen_tpu_torch.runtime import (MDGenRuntime, TrainRuntime, batch_to_device, tokenize,
                                     tokenize_atom14)
from mdgen_tpu_torch.tasks import prep_batch
from tests.test_torch_model import _port, _port_forward, _setup

CHAINS = {"long": "ACDEFGHIKL", "short": "MKW"}
ATLAS = dict(atlas=True, sim_condition=True, prepend_ipa=True, abs_pos_emb=True,
             abs_time_emb=True, num_frames=5, crop=6, num_layers=2, embed_dim=32, mha_heads=4,
             ipa_heads=2, ipa_head_dim=8, ipa_qk=2, ipa_v=2, batch_size=2)


@pytest.fixture(scope="module")
def atlas_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("atlas")
    for i, (name, seq) in enumerate(CHAINS.items()):
        for r in (1, 2, 3):
            np.save(d / f"{name}_R{r}.npy", synthetic_trajectory(seq, 8, seed=10 * i + r))
    (d / "split.csv").write_text("name,seqres\n" + "".join(f"{n},{s}\n" for n, s in CHAINS.items()))
    return d


def _items(atlas_dir, seed, n=2):
    """n items of each dataset from generators in the same state."""
    split = os.path.join(atlas_dir, "split.csv")
    jds = JaxDataset(JaxConfig(**ATLAS), split, str(atlas_dir))
    jds.rng = np.random.default_rng(seed)
    ds = MDGenDataset(MDGenConfig(**ATLAS), split, str(atlas_dir), seed=seed)
    return [(jds[i], ds[i]) for i in range(n)]


def test_dataset_items_match_jax(atlas_dir):
    kinds = set()
    for seed in range(12):
        for want, got in _items(atlas_dir, seed):
            assert set(got) == set(want) and got["name"] == want["name"]
            assert got["name"].rsplit("_R", 1)[1] in "123"
            assert got["frame_start"] == want["frame_start"]
            for key in ("atom14", "seqres", "mask"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got["atom14"].shape == (5, 7, 14, 3) and got["atom14"].dtype == np.float32
            if got["name"].startswith("short"):
                kinds.add("padded")
                assert got["mask"].tolist() == [0, 1, 1, 1, 0, 0, 0]
            else:
                kinds.add("context" if got["mask"][0] else "chain_start")
                assert got["mask"][1:].all()
    assert kinds == {"padded", "context", "chain_start"}


@pytest.mark.parametrize("kind", ["context", "chain_start", "padded"])
def test_tokens_after_dropping_the_context_column_match_jax(atlas_dir, kind):
    for seed in range(40):
        item = _items(atlas_dir, seed, n=2)[0 if kind != "padded" else 1][1]
        found = {0: "chain_start", 1: "context"}[int(item["mask"][0])]
        if item["name"].startswith("short"):
            found = "padded"
        if found == kind:
            break
    batch = {k: item[k][None] for k in ("atom14", "seqres", "mask")}
    tok_j = jax_tokenize({k: jnp.asarray(v) for k, v in batch.items()}, drop_left_context=True)
    cfg = MDGenConfig(**ATLAS)
    tok = tokenize(cfg, batch_to_device(batch, "cpu"))
    assert tok["rots"].shape == (1, 5, 6, 3, 3)  # the context column is gone
    for key in ("trans", "rots", "torsion_mask", "mask"):
        np.testing.assert_allclose(tok[key].numpy(), np.asarray(tok_j[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(tok["seqres"].numpy(), np.asarray(tok_j["seqres"]))
    defined = tok["torsion_mask"][:, None, :, :, None].expand_as(tok["torsions"]) > 0
    np.testing.assert_allclose(tok["torsions"][defined].numpy(),
                               np.asarray(tok_j["torsions"])[defined.numpy()], rtol=1e-5,
                               atol=1e-5)
    first = tok["torsion_mask"][0, 0, :2].tolist()  # omega, phi of the first residue
    assert first == ([1.0, 1.0] if kind == "context" else [0.0, 0.0])
    # a batch as wide as the crop carries no context column: nothing dropped
    narrow = {k: v[:, :, 1:] if k == "atom14" else v[:, 1:] for k, v in batch.items()}
    assert tokenize(cfg, batch_to_device(narrow, "cpu"))["rots"].shape == (1, 5, 6, 3, 3)


def _atlas_batch(atlas_dir):
    items = [it for _, it in _items(atlas_dir, 3)]
    return batch_to_device({k: np.stack([it[k] for it in items])
                            for k in ("atom14", "seqres", "mask")}, "cpu")


@pytest.mark.parametrize("dropout", [0.1, 0.0])
def test_checkpointed_train_step_equals_the_plain_one(atlas_dir, dropout, monkeypatch):
    batch = _atlas_batch(atlas_dir)
    g = torch.Generator().manual_seed(4)
    t, x0 = torch.rand(2, generator=g), torch.randn(2, 5, 6, 21, generator=g)
    runs, real_mask = {}, layers.Dropout.mask
    for remat in (False, True):
        cfg = MDGenConfig(**ATLAS, dropout=dropout, grad_checkpointing=remat)
        rt = TrainRuntime(cfg)
        model = rt.init(torch.Generator().manual_seed(0)).model
        with torch.no_grad():  # open the adaLN-zero gates and the output head
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
        calls = []
        monkeypatch.setattr(layers.Dropout, "mask",
                            lambda self, *a: calls.append(a[0]) or real_mask(self, *a))
        _, grads, metrics = rt._grads(model, batch, t=t, x0=x0, dropout_seed=123)
        runs[remat] = (float(metrics["loss"]), grads, calls)
    (loss, grads, calls), (loss_r, grads_r, calls_r) = runs[False], runs[True]
    assert np.isfinite(loss) and loss == loss_r
    # the IPA tower (ipa, mha_l) and the trunk (mha_l, mha_t) draw per layer;
    # the checkpointed trunk draws again in the recompute
    n_tower, n_trunk = (4, 4) if dropout else (0, 0)
    assert len(calls) == n_tower + n_trunk and len(calls_r) == n_tower + 2 * n_trunk
    for a, b in zip(grads, grads_r):
        assert torch.equal(a, b)
    assert sum(float(g.norm()) for g in grads) > 0


def test_checkpointed_train_step_on_the_flash_route(atlas_dir, monkeypatch):
    import importlib

    from mdgen_tpu_torch.models import attention

    fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")

    batch = _atlas_batch(atlas_dir)
    g = torch.Generator().manual_seed(4)
    t, x0 = torch.rand(2, generator=g), torch.randn(2, 5, 6, 21, generator=g)
    cfg = MDGenConfig(**ATLAS, grad_checkpointing=True)
    counts = {}
    for name in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"):
        def counted(*a, _name=name, _real=getattr(fa, name)):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a)
        monkeypatch.setattr(fa, name, counted)
    runs = {}
    for route, least in (("dense", attention.FLASH_MIN_KEYS), ("flash", 2)):
        monkeypatch.setattr(attention, "FLASH_MIN_KEYS", least)
        rt = TrainRuntime(cfg)
        model = rt.init(torch.Generator().manual_seed(0)).model
        with torch.no_grad():  # open the adaLN-zero gates and the output head
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
        _, grads, metrics = rt._grads(model, batch, t=t, x0=x0)
        runs[route] = (float(metrics["loss"]), grads, dict(counts))
        counts.clear()
    (loss_d, grads_d, counts_d), (loss_f, grads_f, counts_f) = runs["dense"], runs["flash"]
    layers_ = ATLAS["num_layers"]  # each has a trunk layer and a tower layer
    assert counts_d == {}
    assert counts_f == {"flash_fwd_lse": 2 * 2 * layers_ + layers_,
                        "flash_bwd_dq": 3 * layers_, "flash_bwd_dkv": 3 * layers_}
    assert np.isfinite(loss_f) and abs(loss_f - loss_d) <= 1e-5 * abs(loss_d)
    for a, b in zip(grads_f, grads_d):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-12)
    assert sum(float(g.norm()) for g in grads_f) > 0


@pytest.fixture(scope="module")
def dropout_case():
    kw = dict(sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True,
              num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
              ipa_v=2, num_frames=6, crop=4, dropout=0.25)
    return _setup(kw, seed=5)


def test_dropout_eval_equals_jax(dropout_case):
    cfg, params, prep_j, prep, x, t = dropout_case
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(JaxModel(cfg, cfg.latent_dim).apply)(
            {"params": params}, jnp.asarray(x), jnp.asarray(t), **prep_j.model_kwargs))
    out = _port_forward(_port(cfg, params), prep, x, t)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_dropout_train_equals_the_jax_formula_on_the_ports_masks(dropout_case, monkeypatch):
    cfg, params, prep_j, prep, x, t = dropout_case
    masks = []
    real_mask = layers.Dropout.mask
    monkeypatch.setattr(layers.Dropout, "mask",
                        lambda self, *a: masks.append(real_mask(self, *a)) or masks[-1])
    model = _port(cfg, params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), dropout_seed=7,
                    **prep.model_kwargs).numpy()
        again = model(torch.from_numpy(x), torch.from_numpy(t), dropout_seed=7,
                      **prep.model_kwargs).numpy()
        other = model(torch.from_numpy(x), torch.from_numpy(t), dropout_seed=8,
                      **prep.model_kwargs).numpy()
    np.testing.assert_array_equal(out, again)  # the seed fixes the masks
    assert np.abs(out - other).max() > 1e-3
    # IPA tower: ipa, mha_l per layer; trunk: mha_l, mha_t per layer
    drawn = [m.numpy() for m in masks[:8]]
    assert len(drawn) == 8 and 0.6 < np.mean([m.mean() for m in drawn]) < 0.9
    queue = list(drawn)

    def bernoulli(key, p, shape):
        m = queue.pop(0)
        assert tuple(shape) == m.shape and p == pytest.approx(0.75)
        return jnp.asarray(m)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    with jax.default_matmul_precision("highest"):  # traced once: the masks in call order
        ref = np.asarray(jax.jit(JaxModel(cfg, cfg.latent_dim).apply)(
            {"params": params}, jnp.asarray(x), jnp.asarray(t),
            rngs={"dropout": jax.random.PRNGKey(0)}, **prep_j.model_kwargs))
    assert not queue
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_residue_attention_past_512_keys_takes_flash_and_equals_dense(monkeypatch):
    """A protein of 600 residues (B = 1, T = 2): the residue axis folds
    [B*T*H, L, hd] rows for the flash route (kernel 4 on the card), which
    must be contiguous; a padding residue is masked."""
    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.models.attention import RoPEAttention

    seen = []

    def flash(q, k, v, bias):
        seen.append((all(a.is_contiguous() for a in (q, k, v, bias)), tuple(q.shape)))
        return ops.flash_attention_plain(q, k, v, bias)[0]

    x = torch.randn(1, 2, 600, 32, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(1, 2, 600)
    mask[:, :, -1] = 0.0
    outs = {}
    for impl in ("auto", "dense"):
        attn = RoPEAttention(32, 4, impl=impl)
        attn.reset_parameters(torch.Generator().manual_seed(0))
        monkeypatch.setattr(ops, "flash_attention", flash)
        with torch.no_grad():
            outs[impl] = attn(x, mask, axis=2)
    assert seen == [(True, (8, 600, 8))]
    np.testing.assert_allclose(outs["auto"].numpy(), outs["dense"].numpy(), rtol=1e-5, atol=1e-5)


def test_dropout_and_checkpointing_configs_serve(atlas_dir):
    """Neither option acts at inference: the serving runtime accepts such a
    config and samples as the model without them does."""
    cfg = MDGenConfig(**ATLAS, dropout=0.1, grad_checkpointing=True, sampling_method="euler",
                      inference_steps=3)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(torch.Generator().manual_seed(0))
    plain = LatentMDGenModel(cfg.replace(dropout=0.0, grad_checkpointing=False), cfg.latent_dim)
    plain.load_state_dict(model.state_dict())
    batch = _atlas_batch(atlas_dir)
    noise = torch.randn(2, 5, 6, 21, generator=torch.Generator().manual_seed(2))
    a, _ = MDGenRuntime(cfg, model).inference(batch, noise=noise)
    b, _ = MDGenRuntime(cfg.replace(dropout=0.0, grad_checkpointing=False), plain).inference(
        batch, noise=noise)
    assert a.shape == (2, 5, 6, 14, 3) and torch.equal(a, b)
    tok = tokenize_atom14(batch, drop_left_context=True)
    assert prep_batch(cfg, tok).latents.shape == (2, 5, 6, 21)
