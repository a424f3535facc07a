"""Reference (Lightning) checkpoints on the port, with no jax:
``mdgen_tpu_torch.interop`` (the copied reference map and its inverse) and
``python -m mdgen_tpu_torch.port_checkpoint``.

The repository holds no reference checkpoint, so the reference layout is
made by ``interop.state_dict_to_reference`` from a seeded port model with
noise on every entry. On it:
  * the port's copy of the map is element-equal (``np.array_equal`` per
    leaf) to ``mdgen_tpu.interop.port_reference_state_dict`` for the 4AA
    sim, TPS, design (inpainting + design) and ``interleave_ipa`` configs,
    and the inverse round-trips the port's state dict exactly;
  * the ported model's forward matches the JAX model's on JAX's port of the
    same reference weights within 2e-4, the tolerance of
    ``tests/test_torch_model.py``;
  * a ``.ckpt`` with ``ema`` ports through the CLI into a run directory that
    ``sim_inference --device cpu`` samples from and ``train --ckpt``
    resumes.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from mdgen_tpu import config as jax_config
from mdgen_tpu.interop import jax_tree
from mdgen_tpu.interop import port_reference_state_dict as jax_port_reference
from mdgen_tpu_torch import interop, port_checkpoint, sim_inference, train
from mdgen_tpu_torch.config import MDGenConfig
from mdgen_tpu_torch.data import synthetic_trajectory
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.runtime import checkpoint

SIM = dict(sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True)
TINY = dict(num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
            ipa_v=3, num_frames=4, crop=4)
CONFIGS = {
    "sim": dict(TINY, **SIM),
    "tps_condition": dict(TINY, tps_condition=True, prepend_ipa=True, abs_pos_emb=True),
    "design": dict(TINY, inpainting=True, design=True, no_aa_emb=True, no_torsion=True,
                   prepend_ipa=True),
    "interleave_ipa": dict(TINY, sim_condition=True, interleave_ipa=True),
}


def _seeded_state_dict(cfg, seed=0):
    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    noise = torch.Generator().manual_seed(seed + 1)
    return {k: v + 0.03 * torch.randn(v.shape, generator=noise)
            for k, v in model.state_dict().items()}


def _jax_cfg(cfg):
    return jax_config.MDGenConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_map_is_element_equal_to_jax(name):
    cfg = MDGenConfig(**CONFIGS[name])
    sd = _seeded_state_dict(cfg)
    ref = interop.state_dict_to_reference(sd, cfg)
    for reference in (ref, {k: v.numpy() for k, v in ref.items()}):  # tensors or numpy
        got = dict(interop._flatten(interop.port_reference_state_dict(reference, cfg,
                                                                      cfg.latent_dim)))
        want = dict(interop._flatten(jax_port_reference(reference, _jax_cfg(cfg),
                                                        cfg.latent_dim)))
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert isinstance(got[k], np.ndarray) and np.array_equal(got[k], np.asarray(w)), k
    back = interop.reference_to_state_dict(ref, cfg)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_hyena_has_no_reference_layout():
    cfg = MDGenConfig(**CONFIGS["sim"], hyena=True)
    with pytest.raises(NotImplementedError, match="hyena"):
        interop.state_dict_to_reference({}, cfg)
    ref = interop.state_dict_to_reference(_seeded_state_dict(MDGenConfig(**CONFIGS["sim"])),
                                          MDGenConfig(**CONFIGS["sim"]))
    with pytest.raises(NotImplementedError, match="hyena"):
        interop.reference_to_state_dict(ref, cfg)


def test_ported_model_forward_matches_jax_model():
    """The 4AA sim model at the widths of ``test_torch_model.py``'s tiny case:
    the port loads ``reference_to_state_dict`` strictly, JAX applies its own
    port of the same reference weights."""
    from test_torch_model import TINY as MODEL_TINY
    from test_torch_model import _jax_forward, _port_forward, _setup

    jcfg, params, prep_j, prep, x, t = _setup(MODEL_TINY, seed=5)
    cfg = MDGenConfig(**dataclasses.asdict(jcfg))
    ref = interop.state_dict_to_reference(interop.jax_params_to_state_dict(params), cfg)
    want = _jax_forward(jcfg, jax_tree(jax_port_reference(ref, jcfg, cfg.latent_dim)),
                        prep_j, x, t)
    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.load_state_dict(interop.reference_to_state_dict(ref, cfg), strict=True)
    got = _port_forward(model.eval(), prep, x, t)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _write_ckpt(path, cfg, ema=True, step=7):
    sd = _seeded_state_dict(cfg, seed=3)
    ema_sd = {k: v + 0.25 for k, v in sd.items()} if ema else None
    interop.write_lightning_checkpoint(str(path), cfg, sd, ema_sd, global_step=step,
                                       precision="16-mixed")
    return sd, ema_sd


def test_port_checkpoint_cli_round_trip(tmp_path):
    """.ckpt (Lightning precision "16-mixed", EMA offset by 0.25) -> the CLI
    -> a run directory: config with bf16-mixed, step_N, the model and EMA
    weights exactly, a fresh optimizer; ``sim_inference --device cpu`` samples
    from it with the EMA weights, and ``train --ckpt`` resumes from it."""
    cfg = MDGenConfig(**CONFIGS["sim"], ema=True)
    sd, ema_sd = _write_ckpt(tmp_path / "ref.ckpt", cfg, step=2)
    out = tmp_path / "ported"
    path = port_checkpoint.main(["--ckpt", str(tmp_path / "ref.ckpt"), "--out", str(out)])
    assert os.path.basename(path) == "step_2" and checkpoint.latest_step(str(out)) == 2
    assert checkpoint.load_config(str(out)) == cfg.replace(precision="bf16-mixed")
    blob = torch.load(os.path.join(path, "model.pt"), weights_only=True)
    assert blob["step"] == 2 and blob["optimizer"]["count"] == 0
    assert all(torch.equal(blob["model"][k], sd[k]) for k in sd)
    assert all(torch.equal(blob["ema"][k], ema_sd[k]) for k in sd)
    model, step = checkpoint.load_model(str(out))
    assert step == 2
    assert all(torch.equal(v, ema_sd[k]) for k, v in model.state_dict().items())

    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "ACDE.npy", synthetic_trajectory("ACDE", 4, seed=0))
    (data / "split.csv").write_text("name,seqres\nACDE,ACDE\n")
    rec = sim_inference.main(["--sim_ckpt", str(out), "--data_dir", str(data), "--split",
                              str(data / "split.csv"), "--num_rollouts", "2", "--out_dir",
                              str(tmp_path / "samples"), "--device", "cpu"])
    assert rec[0]["frames"] == 2 * cfg.num_frames
    with open(rec[0]["paths"][0]) as fh:
        coords = [float(line[30:38]) for line in fh if line.startswith("ATOM")]
    assert len(coords) > 0 and np.isfinite(coords).all()

    res = train.main(["--ckpt", str(out), "--device", "cpu", *[f"--{k}" for k in SIM],
                      "--ema", "--crop", "4", "--num_frames", "4", "--num_layers", "2",
                      "--embed_dim", "32", "--mha_heads", "4", "--ipa_heads", "2",
                      "--ipa_head_dim", "8", "--ipa_qk", "2", "--ipa_v", "3", "--batch_size", "1", "--epochs", "3", "--no_validate",
                      "--train_split", str(data / "split.csv"), "--val_split",
                      str(data / "split.csv"), "--data_dir", str(data), "--workdir",
                      str(tmp_path / "workdir"), "--run_name", "resumed"])
    assert res["step"] == 3 and len(res["losses"]) == 1 and np.isfinite(res["losses"]).all()


def test_port_checkpoint_requires_ema_entry(tmp_path):
    cfg = MDGenConfig(**CONFIGS["sim"], ema=True)
    _write_ckpt(tmp_path / "ref.ckpt", cfg, ema=False)
    with pytest.raises(ValueError, match="ema"):
        port_checkpoint.main(["--ckpt", str(tmp_path / "ref.ckpt"), "--out",
                              str(tmp_path / "out")])
