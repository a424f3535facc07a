"""Transition-path sampling in the port against the JAX package, on the CPU.

* The TPS denoiser (``tps_condition``: the IPA tower run from both
  endpoints, ``latent_to_emb_f/r``) with the same weights (converted by
  ``interop.jax_params_to_state_dict``) and inputs, unfused and fused (the
  sublayers' plain versions): rtol = atol = 2e-4, as the sim model's test.
  The inputs are tokens of synthetic trajectories, not hand-made rotations:
  the endpoint transforms go through Shepperd's quaternion conversion,
  whose branch choice (and so the quaternion's sign) a near tie of two
  candidates would let f32 rounding pick (``tests/test_model_golden.py``).
* ``MDGenRuntime.inference`` on an endpoint batch (start frame repeated,
  end frame last, as the TPS CLI builds it) against JAX's jitted
  ``inference`` with JAX's own noise, passed in: Euler within 1e-4 A,
  dopri5 within 1e-3 A with the same number of drift evaluations (the
  tolerances of ``tests/test_torch_rollout.py``, which says why). The first
  residue's omega and phi are undefined (zero-padding atoms) and tokenize to
  rounding noise that differs between the packages; the test zeroes the
  ``cond_to_emb`` rows of those four channels (14:18 of the 28-channel TPS
  latent), as the rollout test does for the sim latent.
* One training loss and its gradients with ``t`` and ``x0`` given.
* The TPS CLI: the MSM's endpoint states and the drawn start and end frames
  against the JAX CLI's logic on one synthetic peptide; a cache written by
  the JAX package is refused.
* ``python -m mdgen_tpu_torch.analyze_peptide_tps`` against
  ``scripts/analyze_peptide_tps.py`` run in a subprocess on the same files.
* The TPS CLI needs a card unless ``--device cpu`` is given; with
  ``--dp_size 2`` two gloo ranks on the CPU write the one-rank paths.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_tpu.analysis import reference_msm as jax_reference_msm
from mdgen_tpu.config import MDGenConfig
from mdgen_tpu.data import synthetic_rotamer_trajectory, synthetic_trajectory
from mdgen_tpu.geometry import constants as rc
from mdgen_tpu.models import LatentMDGenModel as JaxModel
from mdgen_tpu.runtime import MDGenRuntime as JaxRuntime
from mdgen_tpu.tasks import prep_batch as jax_prep
from mdgen_tpu_torch import analyze_peptide_tps, tps_inference
from mdgen_tpu_torch.analysis import reference_msm
from mdgen_tpu_torch.config import MDGenConfig as TorchConfig
from mdgen_tpu_torch.interop import jax_params_to_state_dict
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.runtime import (MDGenRuntime, TrainRuntime, batch_to_device, checkpoint,
                                     tokenize_atom14)
from mdgen_tpu_torch.tasks import prep_batch
from tests.test_torch_rollout import _count_drift_calls
from tests.test_torch_train import _draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPS = dict(tps_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True)
TINY = dict(num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
            ipa_v=2, num_frames=8, crop=4, **TPS)
SEQS = ("ACDE", "KLMW")


def _endpoint_batch(T, start=2, end=9):
    """Raw atom14 endpoint batch of two peptides: each row the start frame
    repeated and the end frame last (tps_inference's layout); one padded
    residue."""
    atom14 = np.empty((len(SEQS), T, 4, 14, 3), np.float32)
    for i, s in enumerate(SEQS):
        traj = synthetic_trajectory(s, max(start, end) + 1, seed=i)
        atom14[i, :] = traj[start]
        atom14[i, -1] = traj[end]
    mask = np.ones((len(SEQS), 4), np.float32)
    mask[1, -1] = 0.0
    return {"atom14": atom14, "mask": mask,
            "seqres": np.stack([rc.str_sequence_to_aatype(s) for s in SEQS]).astype(np.int32)}


def _params(cfg, kwargs, seed=0):
    """Seeded JAX parameters with noise on every leaf (adaLN-zero would
    otherwise zero every gate and the output head)."""
    B, T, L = kwargs["mask"].shape
    params = jax.jit(JaxModel(cfg, cfg.latent_dim).init)(
        jax.random.PRNGKey(seed), jnp.zeros((B, T, L, cfg.latent_dim)), jnp.zeros((B,)),
        **kwargs)["params"]
    noise = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.03 * noise.normal(size=p.shape).astype(np.float32), params)


def _tokens(raw):
    tok = tokenize_atom14(batch_to_device(raw, "cpu"))
    return tok, {k: v.numpy() for k, v in tok.items()}


@pytest.fixture(scope="module")
def tps_forward():
    """Tokens of an endpoint batch, seeded parameters, inputs and JAX's
    output for them."""
    cfg = MDGenConfig(**TINY)
    tok, tok_np = _tokens(_endpoint_batch(cfg.num_frames))
    prep_j = jax_prep(cfg, {k: jnp.asarray(v) for k, v in tok_np.items()})
    params = _params(cfg, prep_j.model_kwargs)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, cfg.num_frames, 4, cfg.latent_dim)).astype(np.float32)
    t = np.asarray([0.3, 0.7], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(JaxModel(cfg, cfg.latent_dim).apply)(
            {"params": params}, jnp.asarray(x), jnp.asarray(t), **prep_j.model_kwargs))
    return cfg, tok, params, x, t, ref


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_tps_forward_matches_jax(tps_forward, fused):
    cfg, tok, params, x, t, ref = tps_forward
    assert cfg.latent_dim == 28 and np.abs(ref).max() > 1e-2

    model = LatentMDGenModel(cfg.replace(fused_block=fused), cfg.latent_dim)
    model.load_state_dict(jax_params_to_state_dict(params))  # strict: every name maps
    assert model.latent_to_emb_f.weight.shape == (32, 7)
    kwargs = prep_batch(cfg, tok).model_kwargs
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x), torch.from_numpy(t), **kwargs).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)

    # the tower's pairing matters: with the endpoints' frames swapped in the
    # IPA (the forward stream with the start frames) the output moves
    swapped = dict(kwargs, start_frames=kwargs["end_frames"], end_frames=kwargs["start_frames"])
    with torch.no_grad():
        moved = model(torch.from_numpy(x), torch.from_numpy(t), **swapped).numpy()
    assert np.abs(moved - ref).max() > 1e-2


@pytest.mark.parametrize("sampling_method", ["euler", "dopri5"])
def test_tps_inference_matches_jax_with_jax_noise(sampling_method):
    cfg = MDGenConfig(**TINY, sampling_method=sampling_method, inference_steps=4)
    raw = _endpoint_batch(cfg.num_frames)
    rt = JaxRuntime(cfg)
    prep_j = jax_prep(cfg, rt._tokenize({k: jnp.asarray(v) for k, v in raw.items()}))
    params = _params(cfg, prep_j.model_kwargs)
    params["cond_to_emb"]["kernel"][14:18] = 0.0  # residue 0's omega/phi sin-cos
    key = jax.random.PRNGKey(5)
    jax_calls = _count_drift_calls(rt)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(rt.inference(params, raw, key)[0])
    jax.effects_barrier()
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                         (2, cfg.num_frames, 4, cfg.latent_dim)))

    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.load_state_dict(jax_params_to_state_dict(params))
    solve = {}
    out, aa = MDGenRuntime(cfg, model).inference(batch_to_device(raw, "cpu"),
                                                 noise=torch.from_numpy(noise.copy()),
                                                 stats=solve)
    out = out.numpy()
    assert out.shape == ref.shape == (2, cfg.num_frames, 4, 14, 3) and np.isfinite(out).all()
    tol = 1e-3 if sampling_method == "dopri5" else 1e-4
    err = np.abs(out - ref).max()
    assert err < tol, err
    assert solve["reached_t1"] and solve["evals"] == len(jax_calls), (solve, len(jax_calls))
    assert np.array_equal(aa.numpy(), np.broadcast_to(raw["seqres"][:, None], aa.shape))


def test_tps_training_loss_and_gradients_match_jax():
    cfg = MDGenConfig(**TINY, batch_size=2)
    tok, tok_np = _tokens(_endpoint_batch(cfg.num_frames))
    jrt = JaxRuntime(cfg)
    prep_j = jax_prep(cfg, {k: jnp.asarray(v) for k, v in tok_np.items()})
    params = _params(cfg, prep_j.model_kwargs, seed=4)
    key = jax.random.PRNGKey(9)
    with jax.default_matmul_precision("highest"):
        (loss_j, _), grads_j = jax.jit(jax.value_and_grad(jrt._loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), key, tok_np)
    t, x0 = _draws(key, (2, cfg.num_frames, 4, cfg.latent_dim))

    rt = TrainRuntime(TorchConfig(**TINY, batch_size=2))
    model = rt.init(state_dict=jax_params_to_state_dict(params)).model
    names = [n for n, _ in model.named_parameters()]
    _, grads, metrics = rt._grads(model, tok, t=t, x0=x0)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=1e-5)
    want = jax_params_to_state_dict(jax.device_get(grads_j))
    assert set(want) == set(names)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in zip(names, grads):
        assert g.shape == want[name].shape, name
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
    assert float(want["latent_to_emb_f.weight"].abs().max()) > 0  # the tower is trained


# -- the CLI and the analysis --------------------------------------------------

CLI_FRAMES, TICA_LAG, MSM_LAG, BATCHES, BATCH = 600, 10, 2, 2, 3


@pytest.fixture(scope="module")
def tps_run(tmp_path_factory):
    """A tiny TPS checkpoint, one rotamer peptide's MD, and the port CLI's
    outputs for them on the CPU."""
    work = tmp_path_factory.mktemp("tps")
    seq = "ACDE"
    arr = synthetic_rotamer_trajectory(seq, CLI_FRAMES, seed=0)
    np.save(work / f"{seq}.npy", arr)
    split = work / "split.csv"
    split.write_text(f"name,seqres\n{seq},{seq}\n")
    cfg = TorchConfig(**dict(TINY, num_layers=1), sampling_method="euler", inference_steps=3)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(
        torch.Generator().manual_seed(0))
    checkpoint.save_checkpoint(str(work / "ckpt"), cfg, model.state_dict())
    out = work / "out"
    records = tps_inference.main([
        "--sim_ckpt", str(work / "ckpt"), "--data_dir", str(work), "--split", str(split),
        "--out_dir", str(out), "--num_batches", str(BATCHES), "--batch_size", str(BATCH),
        "--tica_lag", str(TICA_LAG), "--msm_lag", str(MSM_LAG), "--xtc", "--fused_block",
        "--device", "cpu"])
    return {"work": work, "out": out, "seq": seq, "arr": arr, "records": records,
            "T": cfg.num_frames}


def test_tps_cli_draws_the_jax_cli_frames(tps_run):
    """The MSM's endpoint states and the drawn frames of the JAX CLI
    (``tps_inference.py:84-102``) on the same data and seed."""
    seq, arr = tps_run["seq"], tps_run["arr"]
    aatype = rc.str_sequence_to_aatype(seq)
    meta = jax_reference_msm.build_reference_msm(arr, aatype, tica_lag=TICA_LAG,
                                                 msm_lag=MSM_LAG, seed=137)
    start_state, end_state = jax_reference_msm.lowest_flux_states(meta["cmsm"])
    port_meta = reference_msm.load_msm_cache(str(tps_run["out"] / f"{seq}_metadata.pkl"))
    assert np.array_equal(port_meta["ref_discrete"], meta["ref_discrete"])
    rng = np.random.default_rng(137)
    want = []
    for _ in range(BATCHES):
        si = rng.choice(np.where(meta["ref_discrete"] == start_state)[0], BATCH)
        ei = rng.choice(np.where(meta["ref_discrete"] == end_state)[0], BATCH)
        want += list(zip(si.tolist(), ei.tolist()))
    got = json.loads((tps_run["out"] / f"{seq}_metadata.json").read_text())
    assert [(m["start_idx"], m["end_idx"]) for m in got] == want
    assert {(m["start_state"], m["end_state"]) for m in got} == {(start_state, end_state)}
    assert start_state != end_state
    from mdgen_tpu_torch.protein import load_trajectory

    for i, m in enumerate(got):
        atoms, aat = load_trajectory(m["path"])  # the frame-0 PDB and its XTC
        assert m["path"].endswith(f"{seq}_{i}.pdb") and atoms.shape == (tps_run["T"], 4, 14, 3)
        assert np.array_equal(aat, aatype) and np.isfinite(atoms).all()
    assert all(r["solves"][0]["evals"] == 2 for r in tps_run["records"])


def test_tps_cli_refuses_a_cache_of_the_jax_package(tmp_path):
    seq = "ACDE"
    from mdgen_tpu.analysis.msm import TICA

    path = str(tmp_path / f"{seq}_metadata.pkl")
    with open(path, "wb") as fh:  # the JAX CLI's cache pickles its own classes
        pickle.dump({"tica": TICA(lag=TICA_LAG), "ref_discrete": np.zeros(3, int)}, fh)
    with pytest.raises(ValueError, match="written by the JAX package"):
        reference_msm.load_or_build_msm(path, None, None)


def test_analyze_peptide_tps_matches_jax_script(tps_run):
    """The same tps_out.pkl keys and values, with the replica baselines
    (``--repdir`` on the MD itself, truncated to 300 and 100 frames)."""
    out, work = tps_run["out"], tps_run["work"]
    flags = ["--mddir", str(work), "--pdbdir", str(out), "--repdir", str(work), "--rep_lens",
             "300,100", "--rep_names", "a,b", "--rep_msm_lag", "2", "--n_bridge_samples", "200",
             "--save"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "analyze_peptide_tps.py"),
                           *flags, "--save_name", "jax.pkl"], cwd=work, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "ERROR" not in proc.stdout, proc.stdout + proc.stderr
    got = analyze_peptide_tps.main([*flags, "--save_name", "port.pkl"])
    with open(out / "jax.pkl", "rb") as fh:
        want = pickle.load(fh)
    with open(out / "port.pkl", "rb") as fh:
        assert pickle.load(fh).keys() == got.keys() == want.keys() == {tps_run["seq"]}
    g, w = got[tps_run["seq"]], want[tps_run["seq"]]
    assert set(g) == set(w) and {"gen_valid_rate", "gen_JSD", "a_rep_JSD"} <= set(g)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-9, err_msg=k)
    analyze_peptide_tps.main(["--mddir", str(work), "--pdbdir", str(out), "--n_bridge_samples",
                              "200", "--plot"])
    assert (out / f"{tps_run['seq']}_tps.pdf").stat().st_size > 0


def test_tps_cli_needs_cuda_unless_cpu_is_asked_for(tps_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tps_inference.main(["--sim_ckpt", str(tps_run["work"] / "ckpt"), "--data_dir", "."])
    # --dp_size 2: each rank samples 2 of the 3 paths (one a pad of path 0);
    # rank 0 writes the one-rank run's first batch (Euler: the same sums)
    work, out = tps_run["work"], tps_run["work"] / "dp2"
    out.mkdir()
    shutil.copy(tps_run["out"] / f"{tps_run['seq']}_metadata.pkl", out)
    records = tps_inference.main([
        "--sim_ckpt", str(work / "ckpt"), "--data_dir", str(work), "--split",
        str(work / "split.csv"), "--out_dir", str(out), "--num_batches", "1", "--batch_size",
        str(BATCH), "--tica_lag", str(TICA_LAG), "--msm_lag", str(MSM_LAG), "--xtc",
        "--fused_block", "--device", "cpu", "--dp_size", "2"])
    one = tps_run["records"][0]
    assert np.array_equal(records[0]["start_idx"], one["start_idx"])
    assert records[0]["solves"] == one["solves"]
    from mdgen_tpu_torch.protein import load_trajectory

    for j in range(BATCH):
        a, _ = load_trajectory(one["paths"][j])
        b, _ = load_trajectory(records[0]["paths"][j])
        np.testing.assert_allclose(b, a, atol=2e-2)  # the XTC's 0.01 A grid
