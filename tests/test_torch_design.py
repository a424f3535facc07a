"""Inpainting and sequence design in the port against the JAX package, on the CPU.

* The Dirichlet conditional flow: the c-factor table and its b grid
  element for element; ``c_factor`` over a grid of b with the simplex's
  edges (b = 0, 1, 1 - 2^-24 and the values whose (1 - b)^19 is subnormal,
  which XLA flushes to zero) at several alpha: the same pattern of 0, inf
  and nan, and the finite entries within rtol 2e-5. The difference is the
  scalar B(alpha, 19): JAX's f32 ``gammaln`` puts it up to 1.5e-5 from the
  exact value (8.5e-6 at alpha = 4, where the exact value is 6 / 175560),
  the port's ``torch.lgamma`` within 5e-6; ``simplex_proj`` within 1e-6.
* The Dirichlet sampler: the same draw for the same generator seed, and
  mean and variance against the distribution's within 5 standard errors.
* The design denoiser (the recipe: ``inpainting design no_aa_emb
  no_torsion``) and the two mpnn modes with the same weights (converted by
  ``interop.jax_params_to_state_dict``, loaded strictly) and inputs,
  unfused and fused (the sublayers' plain versions): ``forward``,
  ``forward_inference`` (the Dirichlet flow field; one t shared by the
  batch, as JAX reads ``t[0]``) and the mpnn logits [B, 1, L, 20], at rtol
  = atol = 2e-4, as the sim model's test.
* One design training loss (and one mpnn loss) with its metrics and
  gradients, with t, x0 and the simplex draw given.
* ``MDGenRuntime.inference`` against JAX's jitted ``inference`` with JAX's
  continuous and Dirichlet noise passed in: Euler within 1e-4 A and dopri5
  within 1e-3 A with the same number of drift evaluations (the tolerances
  of ``tests/test_torch_rollout.py``, which says why), the same designed
  sequence; the mpnn inference's sequence.
* The design CLI: the MSM's states and the drawn start indices against the
  JAX CLI's logic on one synthetic peptide (transition windows and
  ``--random_start_idx``); ``python -m mdgen_tpu_torch.analyze_peptide_design``
  prints the lines of ``scripts/analyze_peptide_design.py`` on the same
  metadata; the trainer's designability probe writes its metrics.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from mdgen_tpu.analysis import reference_msm as jax_reference_msm
from mdgen_tpu.config import MDGenConfig
from mdgen_tpu.data import synthetic_rotamer_trajectory, synthetic_trajectory
from mdgen_tpu.geometry import constants as rc
from mdgen_tpu.models import LatentMDGenModel as JaxModel
from mdgen_tpu.runtime import MDGenRuntime as JaxRuntime
from mdgen_tpu.tasks import prep_batch as jax_prep
from mdgen_tpu.transport import dirichlet as jax_dirichlet
from mdgen_tpu_torch import analyze_peptide_design, design_inference, train
from mdgen_tpu_torch.analysis import reference_msm
from mdgen_tpu_torch.config import MDGenConfig as TorchConfig
from mdgen_tpu_torch.interop import jax_params_to_state_dict
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.runtime import MDGenRuntime, TrainRuntime, batch_to_device, checkpoint
from mdgen_tpu_torch.tasks import prep_batch
from mdgen_tpu_torch.transport import dirichlet
from tests.test_torch_rollout import _count_drift_calls
from tests.test_torch_tps import _tokens
from tests.test_torch_train import _draws, _to_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
              ipa_v=2, num_frames=8, crop=4, prepend_ipa=True, abs_pos_emb=True,
              abs_time_emb=True)
# the reference design recipe, and the two mpnn modes
MODES = {
    "design": dict(inpainting=True, design=True, no_aa_emb=True, no_torsion=True),
    "mpnn": dict(sim_condition=True, mpnn=True, design=True),
    "dynamic_mpnn": dict(inpainting=True, dynamic_mpnn=True, design=True),
}
SEQS = ("ACDE", "KLMW")
ALPHA_MAX, SPACING = 8.0, 0.001


@pytest.fixture(scope="module", autouse=True)
def _betainc_once():
    """The JAX model builds its c-factor table with SciPy in ``setup``, at
    every trace (about 5 s); the values are a pure function of the grids,
    so this module computes each grid's once."""
    cache, betainc = {}, scipy.special.betainc

    def cached(a, b, x):
        key = (np.asarray(a).tobytes(), float(b), np.asarray(x).tobytes())
        if key not in cache:
            cache[key] = betainc(a, b, x)
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scipy.special, "betainc", cached)
        yield


def _cfg(mode, **kw):
    return MDGenConfig(**{**WIDTHS, **MODES[mode], **kw})


def _params(cfg, kwargs, seed=0):
    """Seeded parameters as a flax tree (numpy leaves): the port's init with
    N(0, 0.03) noise on every entry (adaLN-zero would otherwise zero every
    gate and the output head), laid out on the JAX model's tree, which
    ``jax.eval_shape`` gives without compiling its init."""
    B, T, L = kwargs["mask"].shape
    template = jax.eval_shape(JaxModel(cfg, cfg.latent_dim).init, jax.random.PRNGKey(0),
                              jnp.zeros((B, T, L, cfg.latent_dim)), jnp.zeros((B,)),
                              **kwargs)["params"]
    g = torch.Generator().manual_seed(seed)
    sd = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(g).state_dict()
    sd = {k: v + 0.03 * torch.randn(v.shape, generator=g) for k, v in sd.items()}
    return jax.tree_util.tree_map(np.asarray, _to_jax_params(template, sd))


def _windows(T, start=2):
    """Raw atom14 windows of two peptides (T consecutive frames of a
    synthetic trajectory each), one padded residue."""
    atom14 = np.stack([synthetic_trajectory(s, start + T, seed=i)[start:]
                       for i, s in enumerate(SEQS)]).astype(np.float32)
    mask = np.ones((len(SEQS), 4), np.float32)
    mask[1, -1] = 0.0
    return {"atom14": atom14, "mask": mask,
            "seqres": np.stack([rc.str_sequence_to_aatype(s) for s in SEQS]).astype(np.int32)}


# -- the Dirichlet conditional flow --------------------------------------------


@pytest.fixture(scope="module")
def flows():
    return (jax_dirichlet.DirichletConditionalFlow(K=20, alpha_spacing=SPACING, alpha_max=ALPHA_MAX),
            dirichlet.DirichletConditionalFlow(K=20, alpha_spacing=SPACING, alpha_max=ALPHA_MAX))


def test_cfactor_table_matches_jax(flows):
    jf, pf = flows
    assert pf.table.dtype == torch.float32 and pf.table.shape == (7000, 1000)
    assert np.array_equal(pf.table.numpy(), np.asarray(jf.table))
    assert np.array_equal(pf.bs.numpy(), np.asarray(jf.bs))
    # a buffer, not a parameter: not saved, and shared by a deep copy
    model = LatentMDGenModel(TorchConfig(**WIDTHS, **MODES["design"]), 48)
    assert not any("condflow" in k for k in model.state_dict())
    assert not any("condflow" in n for n, _ in model.named_parameters())
    import copy

    twin = copy.deepcopy(model)
    assert twin.condflow.table.data_ptr() == model.condflow.table.data_ptr()


EDGES = np.asarray([0.0, 1.0, 1 - 2.0**-24, 2.0**-24, 1e-40, 0.5, 0.999, 1 - 1e-4], np.float32)


@pytest.mark.parametrize("alpha", [1.0, 2.5, 4.0, ALPHA_MAX - SPACING])
def test_c_factor_matches_jax(flows, alpha):
    jf, pf = flows
    rng = np.random.default_rng(int(alpha * 1000))
    b = np.concatenate([EDGES, np.linspace(0, 1, 2001), rng.random(2000),
                        1 - 0.02 * rng.random(1000), 1e-3 * rng.random(500)]).astype(np.float32)
    a = np.float32(alpha)
    want = np.asarray(jax.jit(jf.c_factor)(jnp.asarray(b), jnp.float32(a)))
    got = pf.c_factor(torch.from_numpy(b), torch.tensor(a)).numpy()
    for kind in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(kind(got), kind(want)), kind.__name__
    assert np.array_equal(got[:3] == 0, want[:3] == 0)
    assert (~np.isfinite(got)).sum() > 0  # the edges are reached
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=0)

    # the difference is the constant B(alpha, 19): exact from math.lgamma in f64
    import math

    exact = math.exp(math.lgamma(a) + math.lgamma(19) - math.lgamma(a + 19))
    k1 = torch.tensor(19.0)
    port = float(torch.exp(torch.lgamma(torch.tensor(a)) + torch.lgamma(k1)
                           - torch.lgamma(torch.tensor(a) + 19.0)))
    assert abs(port / exact - 1) < 5e-6


def test_simplex_proj_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 20)).astype(np.float32) * 2
    for xx in (x, np.array(jax.nn.softmax(jnp.asarray(x), -1))):
        want = np.asarray(jax.jit(jax_dirichlet.simplex_proj)(jnp.asarray(xx)))
        got = dirichlet.simplex_proj(torch.from_numpy(xx)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_dirichlet_sampler_is_seeded_and_has_the_moments():
    conc = torch.ones(20000, 20)
    conc[:, 3] = 5.0  # a design draw: 1 + onehot (alpha - 1)
    draws = [dirichlet.sample_dirichlet(conc, torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    x = draws[0].double()
    a = conc[0].double()
    a0 = a.sum()
    mean, var = a / a0, a * (a0 - a) / (a0**2 * (a0 + 1))
    n = x.shape[0]
    assert torch.allclose(x.sum(-1), torch.ones(n, dtype=torch.float64), atol=1e-5)
    # 5 standard errors: of the mean, sqrt(var / n); of the variance,
    # sqrt((m4 - var^2) / n) with the sample's fourth central moment
    assert ((x.mean(0) - mean).abs() <= 5 * (var / n).sqrt()).all()
    m4 = ((x - x.mean(0)) ** 4).mean(0)
    assert ((x.var(0) - var).abs() <= 5 * ((m4 - var**2) / n).sqrt()).all()


# -- the denoiser --------------------------------------------------------------


@pytest.fixture(scope="module", params=list(MODES))
def mode_forward(request):
    """Tokens of two windows, seeded parameters, inputs (the simplex
    channels a Dirichlet point broadcast over T) and JAX's forward and
    forward_inference for them."""
    mode = request.param
    cfg = _cfg(mode)
    tok, tok_np = _tokens(_windows(cfg.num_frames))
    prep_j = jax_prep(cfg, {k: jnp.asarray(v) for k, v in tok_np.items()})
    params = _params(cfg, prep_j.model_kwargs)
    rng = np.random.default_rng(3)
    B, T, L = 2, cfg.num_frames, 4
    x = rng.normal(size=(B, T, L, cfg.latent_dim)).astype(np.float32)
    x[..., -20:] = rng.dirichlet(np.ones(20), size=(B, 1, L)).astype(np.float32)
    t = np.asarray([0.35, 0.35], np.float32)
    model = JaxModel(cfg, cfg.latent_dim)

    def both(p, x, t, kw):  # one program: the mpnn modes' forward_inference is their forward
        out = model.apply({"params": p}, x, t, **kw)
        return out, (model.apply({"params": p}, x, t, method="forward_inference", **kw)
                     if mode == "design" else out)

    with jax.default_matmul_precision("highest"):
        ref = dict(zip(("__call__", "forward_inference"), (np.asarray(a) for a in jax.jit(both)(
            params, jnp.asarray(x), jnp.asarray(t), prep_j.model_kwargs))))
    return mode, cfg, tok, params, x, t, ref


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_design_forward_matches_jax(mode_forward, fused):
    mode, cfg, tok, params, x, t, ref = mode_forward
    model = LatentMDGenModel(cfg.replace(fused_block=fused), cfg.latent_dim)
    model.load_state_dict(jax_params_to_state_dict(params))  # strict: every name maps
    assert model.cond_to_emb.weight.shape[1] == cfg.latent_dim - 20
    assert hasattr(model, "emb_to_latent") == (mode == "design")
    kwargs = prep_batch(cfg, tok).model_kwargs
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x), torch.from_numpy(t), **kwargs).numpy()
        flow = model.forward_inference(torch.from_numpy(x), torch.from_numpy(t), **kwargs).numpy()
    if mode != "design":
        assert out.shape == (2, 1, 4, 20) and np.array_equal(flow, out)
    assert np.abs(ref["__call__"]).max() > 1e-2
    np.testing.assert_allclose(out, ref["__call__"], rtol=2e-4, atol=2e-4)
    assert np.isfinite(ref["forward_inference"]).all()
    np.testing.assert_allclose(flow, ref["forward_inference"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", ["design", "mpnn"])
def test_design_training_loss_and_gradients_match_jax(mode):
    cfg = _cfg(mode, batch_size=2, num_layers=1)
    tok, tok_np = _tokens(_windows(cfg.num_frames))
    jrt = JaxRuntime(cfg)
    prep_j = jax_prep(cfg, {k: jnp.asarray(v) for k, v in tok_np.items()})
    params = _params(cfg, prep_j.model_kwargs, seed=4)
    key = jax.random.PRNGKey(9)
    with jax.default_matmul_precision("highest"):
        (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(jrt._loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), key, tok_np)
    D = cfg.latent_dim - 20
    t, x0 = _draws(key, (2, cfg.num_frames, 4, D))
    # the simplex draw of JAX's step: Dirichlet(1 + onehot (alpha_t - 1))
    alphas = 1 - jnp.asarray(t.numpy()) + jnp.asarray(t.numpy()) * cfg.alpha_max
    conc = 1 + jax.nn.one_hot(tok_np["seqres"], 20) * (alphas[:, None, None] - 1)
    x_d = torch.from_numpy(np.asarray(jax.random.dirichlet(jax.random.split(key, 3)[2], conc)))

    rt = TrainRuntime(TorchConfig(**{**WIDTHS, "num_layers": 1}, **MODES[mode], batch_size=2))
    model = rt.init(state_dict=jax_params_to_state_dict(params)).model
    names = [n for n, _ in model.named_parameters()]
    _, grads, metrics = rt._grads(model, tok, t=t, x0=x0, x_d=x_d)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=1e-5)
    assert set(metrics) == set(metrics_j)
    for k in metrics:
        if k == "loss_continuous" and mode == "mpnn":
            assert np.isnan(float(metrics[k])) and np.isnan(float(metrics_j[k]))
        else:
            np.testing.assert_allclose(float(metrics[k]), float(metrics_j[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    want = jax_params_to_state_dict(jax.device_get(grads_j))
    assert set(want) == set(names)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in zip(names, grads):
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
    assert float(want["emb_to_logits.weight"].abs().max()) > 0  # the head is trained


@pytest.mark.parametrize("sampling_method", ["euler", "dopri5", "mpnn"])
def test_design_inference_matches_jax_with_jax_noise(sampling_method):
    mode = "mpnn" if sampling_method == "mpnn" else "design"
    # dopri5 at 2 layers: its step sizes follow f32 rounding (JAX's own
    # jitted and eager design solves here differ by 2.8e-4 A at 2 layers and
    # by 2.4e-3 A at 1, tools/dopri5_conditioning.py --design)
    cfg = _cfg(mode, sampling_method="euler" if mode == "mpnn" else sampling_method,
               inference_steps=4, num_layers=2 if sampling_method == "dopri5" else 1)
    raw = _windows(cfg.num_frames)
    rt = JaxRuntime(cfg)
    prep_j = jax_prep(cfg, rt._tokenize({k: jnp.asarray(v) for k, v in raw.items()}))
    params = _params(cfg, prep_j.model_kwargs)
    key = jax.random.PRNGKey(5)
    jax_calls = _count_drift_calls(rt)
    with jax.default_matmul_precision("highest"):
        ref, aa_ref = (np.asarray(a) for a in rt.inference(params, raw, key))
    jax.effects_barrier()
    B, T, L = 2, cfg.num_frames, 4
    k_cont, k_disc = jax.random.split(key)
    noise = np.concatenate([
        np.asarray(jax.random.normal(k_cont, (B, T, L, cfg.latent_dim - 20))),
        np.broadcast_to(np.asarray(jax.random.dirichlet(k_disc, jnp.ones((B, L, 20))))[:, None],
                        (B, T, L, 20))], axis=-1)

    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.load_state_dict(jax_params_to_state_dict(params))
    solve = {}
    out, aa = MDGenRuntime(cfg, model).inference(batch_to_device(raw, "cpu"),
                                                 noise=torch.from_numpy(noise.copy()),
                                                 stats=solve)
    out, aa = out.numpy(), aa.numpy()
    assert np.array_equal(aa, aa_ref)
    if mode == "mpnn":
        assert aa.shape == (B, 1, L) and not solve and not jax_calls
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)  # the true tokens' atoms
        return
    assert aa.shape == (B, T, L)
    assert out.shape == ref.shape == (B, T, L, 14, 3) and np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err < (1e-3 if sampling_method == "dopri5" else 1e-4), err
    assert solve["reached_t1"] and solve["evals"] == len(jax_calls), (solve, len(jax_calls))


# -- the CLI, the analysis and the probe -----------------------------------------

CLI_FRAMES, TICA_LAG, MSM_LAG, BATCHES, BATCH = 600, 10, 2, 2, 3


@pytest.fixture(scope="module")
def design_run(tmp_path_factory):
    """A tiny design checkpoint, one rotamer peptide's MD, and the port
    CLI's outputs on the CPU: transition windows, then random windows."""
    work = tmp_path_factory.mktemp("design")
    seq = "ACDE"
    arr = synthetic_rotamer_trajectory(seq, CLI_FRAMES, seed=0)
    np.save(work / f"{seq}.npy", arr)
    split = work / "split.csv"
    split.write_text(f"name,seqres\n{seq},{seq}\n")
    cfg = TorchConfig(**dict(WIDTHS, num_layers=1), **MODES["design"], sampling_method="euler",
                      inference_steps=3)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(
        torch.Generator().manual_seed(0))
    checkpoint.save_checkpoint(str(work / "ckpt"), cfg, model.state_dict())
    runs = {}
    for how in ("transition", "random"):
        out = work / how
        runs[how] = (out, design_inference.main([
            "--sim_ckpt", str(work / "ckpt"), "--data_dir", str(work), "--split", str(split),
            "--out_dir", str(out), "--num_frames", str(cfg.num_frames), "--num_batches",
            str(BATCHES), "--batch_size", str(BATCH), "--tica_lag", str(TICA_LAG), "--msm_lag",
            str(MSM_LAG), "--fused_block", "--device", "cpu",
            *(["--random_start_idx"] if how == "random" else [])]))
    return {"work": work, "runs": runs, "seq": seq, "arr": arr, "T": cfg.num_frames}


def test_design_cli_draws_the_jax_cli_windows(design_run):
    """The MSM's highest-flux states and the drawn start indices of the JAX
    CLI (``design_inference.py:78-110``) on the same data and seed."""
    seq, arr, T = design_run["seq"], design_run["arr"], design_run["T"]
    meta = jax_reference_msm.build_reference_msm(arr, rc.str_sequence_to_aatype(seq),
                                                 tica_lag=TICA_LAG, msm_lag=MSM_LAG, seed=137)
    start_state, end_state = jax_reference_msm.highest_flux_states(meta["cmsm"])
    ref = meta["ref_discrete"]
    trans_idx = np.where((ref == start_state)[:-T] * (ref == end_state)[T:])[0]
    assert len(trans_idx) > 0 and start_state != end_state
    for how, draw in (("transition", lambda rng: rng.choice(trans_idx, BATCH)),
                      ("random", lambda rng: rng.integers(0, len(arr) - T, BATCH))):
        out, records = design_run["runs"][how]
        port_meta = reference_msm.load_msm_cache(str(out / f"{seq}_metadata.pkl"))
        assert np.array_equal(port_meta["ref_discrete"], ref)
        rng = np.random.default_rng(137)
        want = [int(s) for _ in range(BATCHES) for s in draw(rng)]
        got = json.loads((out / f"{seq}_metadata.json").read_text())
        assert [m["start_idx"] for m in got] == want
        assert all(m["end_idx"] == m["start_idx"] + T for m in got)
        assert {(m["start_state"], m["end_state"]) for m in got} == {(start_state, end_state)}
        from mdgen_tpu_torch.protein import load_pdb_trajectory

        for i, m in enumerate(got):
            assert m["seqres"] == seq and len(m["aa_out"]) == 4 and set(m["aa_out"]) <= set(
                rc.restypes)
            atoms, aat = load_pdb_trajectory(m["path"])
            assert m["path"].endswith(f"{seq}_{i}.pdb") and atoms.shape == (T, 4, 14, 3)
            # the PDB carries the designed sequence
            assert rc.aatype_to_str_sequence(aat) == m["aa_out"] and np.isfinite(atoms).all()
        assert [s for r in records for s in r["aa_out"]] == [m["aa_out"] for m in got]
        assert all(r["solves"][0]["evals"] == 2 for r in records)


def test_analyze_peptide_design_matches_jax_script(design_run, capsys):
    out = design_run["runs"]["transition"][0]
    # a second peptide's metadata: the same designs, another truth
    meta = json.loads((out / "ACDE_metadata.json").read_text())
    (out / "KLMW_metadata.json").write_text(json.dumps([dict(m, seqres="KLMW") for m in meta]))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        "analyze_peptide_design.py"),
                           "--pdbdir", str(out)], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    capsys.readouterr()
    got = analyze_peptide_design.main(["--pdbdir", str(out)])
    printed = capsys.readouterr().out
    assert printed.splitlines() == proc.stdout.splitlines()
    assert len(printed.splitlines()) == 3 and printed.splitlines()[-1].startswith("OVERALL")
    assert set(got["per_peptide"]) == {"ACDE", "KLMW"}
    assert all(0 <= got[k] <= 1 for k in ("designed", "cond", "consensus", "mode_pair"))


def test_design_cli_refuses_what_it_does_not_run(design_run):
    ckpt = str(design_run["work"] / "ckpt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            design_inference.main(["--sim_ckpt", ckpt, "--data_dir", "."])
    # --dp_size runs: two gloo ranks (3 windows, padded to 4) design the
    # one-rank run's sequences and write its samples
    work = design_run["work"]
    one_out, one_records = design_run["runs"]["transition"]
    out = work / "dp2"
    out.mkdir()
    shutil.copy(one_out / "ACDE_metadata.pkl", out)
    records = design_inference.main([
        "--sim_ckpt", ckpt, "--data_dir", str(work), "--split", str(work / "split.csv"),
        "--out_dir", str(out), "--num_frames", str(design_run["T"]), "--num_batches", "1",
        "--batch_size", str(BATCH), "--tica_lag", str(TICA_LAG), "--msm_lag", str(MSM_LAG),
        "--fused_block", "--device", "cpu", "--dp_size", "2"])
    assert records[0]["aa_out"] == one_records[0]["aa_out"]
    assert np.array_equal(records[0]["start_idx"], one_records[0]["start_idx"])
    assert records[0]["solves"] == one_records[0]["solves"]
    for a, b in zip(one_records[0]["paths"], records[0]["paths"]):
        assert open(a).read() == open(b).read()
    from mdgen_tpu.analysis.msm import TICA

    import pickle

    out = design_run["work"] / "jax_cache"
    out.mkdir()
    with open(out / "ACDE_metadata.pkl", "wb") as fh:  # the JAX CLI's cache
        pickle.dump({"tica": TICA(lag=TICA_LAG)}, fh)
    with pytest.raises(ValueError, match="written by the JAX package"):
        design_inference.main(["--sim_ckpt", ckpt, "--data_dir", str(design_run["work"]),
                               "--split", str(design_run["work"] / "split.csv"), "--out_dir",
                               str(out), "--random_start_idx", "--device", "cpu"])


def test_designability_probe_writes_its_metrics(design_run, tmp_path):
    """``train --inference_batches 1``: the probe's recoveries in the val
    CSV, the sampled PDB, and the design metrics of every step."""
    work = design_run["work"]
    rec = train.main([*[f"--{k}" for k, v in MODES["design"].items() if v], "--prepend_ipa",
                      "--abs_pos_emb", "--abs_time_emb", "--crop", "4", "--num_frames", "8",
                      "--num_layers", "1", "--embed_dim", "32", "--mha_heads", "4",
                      "--ipa_head_dim", "8", "--batch_size", "1", "--epochs", "2",
                      "--sampling_method", "euler", "--inference_steps", "3",
                      "--inference_batches", "1", "--designability_freq", "2", "--data_dir",
                      str(work), "--train_split", str(work / "split.csv"), "--val_split",
                      str(work / "split.csv"), "--workdir", str(tmp_path), "--run_name", "probe",
                      "--device", "cpu"])
    run = tmp_path / "probe"
    assert [sorted(k for k in v if "recovery" in k) for v in rec["val"]] == [
        ["val_category_pred_cond_aa_recovery", "val_category_pred_design_aa_recovery"],
        ["val_category_pred_cond_aa_recovery", "val_category_pred_design_aa_recovery",
         "val_cond_aa_recovery", "val_design_aa_recovery"]]  # the probe at epoch 2 only
    header = (run / "val_1.csv").read_text().splitlines()[0].split(",")
    assert {"val_design_aa_recovery", "val_cond_aa_recovery", "val_loss_discrete"} <= set(header)
    assert (run / "epoch1_ACDE.pdb").exists() and not (run / "epoch0_ACDE.pdb").exists()
    assert all(0 <= v["val_design_aa_recovery"] <= 1 for v in rec["val"][1:])
    assert "seq_pred=" in (run / "log.out").read_text()
