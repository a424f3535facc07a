"""Trajectory upsampling in the port against the JAX package, on the CPU.

* ``tasks.build_upsampling_windows`` and ``pad_window_groups`` against the
  JAX package's, array for array (identity rotations and zero translations
  between the kept frames; the padded tail group).
* ``MDGenRuntime.inference`` on a batch of token windows (the token dict
  passes through, as in JAX's ``_tokenize``) against JAX's jitted
  ``inference`` on the same windows with JAX's own noise, passed in: Euler
  within 1e-4 A, dopri5 within 1e-3 A with the same number of drift
  evaluations (``tests/test_torch_rollout.py`` says why). The windows hold
  the port's tokens in both: the empty slots' identity frames sit far from
  frame 0, and the comparison takes exactly these inputs.
* ``python -m mdgen_tpu_torch.upsampling_inference`` on the CPU writes kept
  frames x ``cond_interval`` frames, with a padded last window group.
* ``python -m mdgen_tpu_torch.analyze_upsampling`` against
  ``scripts/analyze_upsampling.py`` run in a subprocess on the same files:
  the same keys, and float16 curves within one float16 ulp (the torsions
  come from f32 geometry in another framework, within 1e-5 rad).
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_tpu.config import MDGenConfig
from mdgen_tpu.data import synthetic_rotamer_trajectory, synthetic_trajectory
from mdgen_tpu.geometry import constants as rc
from mdgen_tpu.runtime import MDGenRuntime as JaxRuntime
from mdgen_tpu.tasks import build_upsampling_windows as jax_windows
from mdgen_tpu.tasks import pad_window_groups as jax_groups
from mdgen_tpu_torch import analyze_upsampling, upsampling_inference
from mdgen_tpu_torch.config import MDGenConfig as TorchConfig
from mdgen_tpu_torch.interop import jax_params_to_state_dict
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.protein import load_trajectory, save_trajectory
from mdgen_tpu_torch.runtime import MDGenRuntime, checkpoint, tokenize_atom14
from mdgen_tpu_torch.tasks import build_upsampling_windows, pad_window_groups
from tests.test_torch_rollout import _count_drift_calls
from tests.test_torch_tps import _params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = "ACDE"
UPS = dict(sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True)
TINY = dict(num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
            ipa_v=2, num_frames=6, crop=4, cond_interval=2, **UPS)


def _kept_tokens(n_kept, seed=0):
    """The port's tokens of ``n_kept`` frames of a synthetic trajectory, as
    one trajectory's numpy dict (the upsampling CLI's input)."""
    arr = synthetic_trajectory(SEQ, n_kept, seed=seed).astype(np.float32)
    tok = tokenize_atom14({"atom14": torch.from_numpy(arr[None]),
                           "seqres": torch.from_numpy(rc.str_sequence_to_aatype(SEQ)[None]).long(),
                           "mask": torch.ones(1, 4)})
    return {k: v[0].numpy() for k, v in tok.items()}


@pytest.mark.parametrize("num_frames,cond_interval,n_kept", [(6, 2, 7), (50, 10, 20), (8, 8, 3)])
def test_windows_match_jax(num_frames, cond_interval, n_kept):
    tok = _kept_tokens(n_kept)
    got = build_upsampling_windows(tok, num_frames, cond_interval)
    want = jax_windows(tok, num_frames, cond_interval)
    assert len(got) == len(want) == n_kept // (num_frames // cond_interval)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3))
    if cond_interval > 1:
        assert np.array_equal(got[0]["rots"][1], eye) and not got[0]["trans"][1].any()
    np.testing.assert_array_equal(got[-1]["trans"][::cond_interval],
                                  tok["trans"][(len(got) - 1) * (num_frames // cond_interval):
                                               len(got) * (num_frames // cond_interval)])


@pytest.mark.parametrize("n,batch_size", [(7, 3), (6, 3), (1, 4), (5, 1)])
def test_window_groups_match_jax(n, batch_size):
    windows = list(range(n))
    got, want = list(pad_window_groups(windows, batch_size)), list(jax_groups(windows, batch_size))
    assert got == want
    assert sum(n_real for _, n_real in got) == n and all(len(g) == batch_size for g, _ in got)


@pytest.mark.parametrize("sampling_method", ["euler", "dopri5"])
def test_window_inference_matches_jax_with_jax_noise(sampling_method):
    cfg = MDGenConfig(**TINY, sampling_method=sampling_method, inference_steps=4)
    windows = build_upsampling_windows(_kept_tokens(6), cfg.num_frames, cfg.cond_interval)
    batch = {k: np.stack([w[k] for w in windows]) for k in windows[0]}
    assert batch["trans"].shape[:2] == (2, cfg.num_frames)
    rt = JaxRuntime(cfg)
    prep_j = rt._tokenize({k: jnp.asarray(v) for k, v in batch.items()})  # passes through
    from mdgen_tpu.tasks import prep_batch as jax_prep

    params = _params(cfg, jax_prep(cfg, prep_j).model_kwargs)
    key = jax.random.PRNGKey(7)
    jax_calls = _count_drift_calls(rt)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(rt.inference(params, batch, key)[0])
    jax.effects_barrier()
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                         (2, cfg.num_frames, 4, cfg.latent_dim)))

    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.load_state_dict(jax_params_to_state_dict(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["seqres"] = tb["seqres"].long()
    solve = {}
    out = MDGenRuntime(cfg, model).inference(tb, noise=torch.from_numpy(noise.copy()),
                                             stats=solve)[0].numpy()
    assert out.shape == ref.shape == (2, cfg.num_frames, 4, 14, 3) and np.isfinite(out).all()
    tol = 1e-3 if sampling_method == "dopri5" else 1e-4
    assert np.abs(out - ref).max() < tol, np.abs(out - ref).max()
    assert solve["reached_t1"] and solve["evals"] == len(jax_calls), (solve, len(jax_calls))


def test_upsampling_cli_writes_every_frame(tmp_path):
    """6 kept frames, 2 per window of 4 frames: 3 windows in groups of 2
    (the last padded), 12 frames written."""
    cfg = TorchConfig(**dict(TINY, num_layers=1, num_frames=4), sampling_method="euler",
                      inference_steps=3)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(torch.Generator().manual_seed(0))
    checkpoint.save_checkpoint(str(tmp_path / "ckpt"), cfg, model.state_dict())
    np.save(tmp_path / f"{SEQ}_i2.npy", synthetic_trajectory(SEQ, 6, seed=0))
    (tmp_path / "split.csv").write_text(f"name,seqres\n{SEQ},{SEQ}\n")
    argv = ["--ckpt", str(tmp_path / "ckpt"), "--data_dir", str(tmp_path), "--split",
            str(tmp_path / "split.csv"), "--suffix", "_i2", "--out_dir", str(tmp_path / "out"),
            "--batch_size", "2", "--xtc", "--fused_block"]
    rec = upsampling_inference.main(argv + ["--device", "cpu"])[0]
    assert rec["frames"] == 12 and rec["windows"] == 3 and len(rec["solves"]) == 2
    atoms, aatype = load_trajectory(str(tmp_path / "out" / f"{SEQ}.pdb"))
    assert atoms.shape == (12, 4, 14, 3) and np.isfinite(atoms).all()
    assert np.array_equal(aatype, rc.str_sequence_to_aatype(SEQ))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            upsampling_inference.main(argv)


def test_analyze_upsampling_matches_jax_script(tmp_path):
    md = synthetic_rotamer_trajectory(SEQ, 300, seed=0).astype(np.float32)
    gen = synthetic_rotamer_trajectory(SEQ, 300, seed=0, path_seed=3,
                                       replay_frames=300).astype(np.float32)
    np.save(tmp_path / f"{SEQ}.npy", md)
    save_trajectory(gen, rc.str_sequence_to_aatype(SEQ), str(tmp_path / f"{SEQ}.pdb"),
                    xtc_path=str(tmp_path / f"{SEQ}.xtc"))
    flags = ["--mddir", str(tmp_path), "--pdbdir", str(tmp_path), "--cond_interval", "10",
             "--nlag", "50", "--save"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "analyze_upsampling.py"),
                           *flags, "--save_name", "jax.pkl"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "ERROR" not in proc.stdout, proc.stdout + proc.stderr
    got = analyze_upsampling.main([*flags, "--save_name", "port.pkl"])
    with open(tmp_path / "jax.pkl", "rb") as fh:
        want = pickle.load(fh)
    with open(tmp_path / "port.pkl", "rb") as fh:
        assert pickle.load(fh).keys() == got.keys() == want.keys() == {SEQ}
    g, w = got[SEQ], want[SEQ]
    assert g.keys() == w.keys() == {"backbone", "sidechain"}
    n = 0
    for section in w:
        assert g[section].keys() == w[section].keys()
        for key, curves in w[section].items():
            assert g[section][key].keys() == curves.keys() == {"truth", "gen", "naive"}
            for c, ref in curves.items():
                out = g[section][key][c]
                assert out.dtype == ref.dtype == np.float16 and out.shape == ref.shape
                ulp = np.spacing(np.maximum(np.abs(out), np.abs(ref))).astype(np.float32)
                diff = np.abs(out.astype(np.float32) - ref.astype(np.float32))
                assert (np.isnan(out) == np.isnan(ref)).all(), (section, key, c)
                assert (diff[~np.isnan(ref)] <= ulp[~np.isnan(ref)]).all(), (section, key, c)
                n += 1
    assert n >= 3 * 10
    analyze_upsampling.main([*flags[:-1], "--plot"])
    assert (tmp_path / f"{SEQ}_decorr.pdf").stat().st_size > 0


@pytest.mark.parametrize("batch", [1, 2])
def test_frame_attention_hands_the_kernel_contiguous_rows(batch, monkeypatch):
    """At B = 1 the folded [B*L*H, T, hd] rows of the frame attention are a
    view of the projections, not a copy; the flash kernels take contiguous
    tensors and refuse others on the card, which the dense side of an
    upsampling window (T = 1000, one window) met. The rows handed over must
    be contiguous at any batch."""
    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.models.attention import RoPEAttention

    seen = []

    def flash(q, k, v, bias):
        seen.append(all(t.is_contiguous() for t in (q, k, v, bias)))
        return ops.flash_attention_plain(q, k, v, bias)[0]

    monkeypatch.setattr(ops, "flash_attention", flash)
    attn = RoPEAttention(32, 4, impl="flash")
    attn.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(batch, 520, 3, 32, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(batch, 520, 3)
    with torch.no_grad():
        out = attn(x, mask, axis=1)
    assert seen == [True] and out.shape == x.shape and torch.isfinite(out).all()
