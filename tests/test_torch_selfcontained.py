"""The port keeps its own copies: no module of ``mdgen_tpu_torch`` (and
nothing ``chip_smoke.py`` imports) opens or imports a file of the JAX
package, and each copy the port keeps of a jax-free JAX module agrees with
its original: the config, the residue constants, the batching loader, the
metric logger, the graceful stop, the XTC codec, the analysis metrics and
MSM toolkit, the upsampling summarizer, the reference-checkpoint map and
its precision table, the data-parallel batch slice and the eval protocol's
summary; and the rotamer dataset writer, a
port onto the port's geometry, writes the JAX package's files. The TPS,
upsampling and design chains (train, inference, analysis) run on the CPU in
a process that cannot import jax.
"""
import argparse
import ast
import dataclasses
import importlib.util
import inspect
import os
import pickle
import pkgutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import mdgen_tpu_torch
from mdgen_tpu import config as jax_config
from mdgen_tpu import xtc as jax_xtc
from mdgen_tpu.analysis import metrics as jax_metrics
from mdgen_tpu.analysis import msm as jax_msm
from mdgen_tpu.data import write_synthetic_dataset as jax_write_dataset
from mdgen_tpu.data.loader import Loader as JaxLoader
from mdgen_tpu.geometry import constants as jax_rc
from mdgen_tpu.runtime.metrics import MetricLogger as JaxMetricLogger
from mdgen_tpu.runtime.preempt import GracefulStop as JaxGracefulStop
from mdgen_tpu_torch import config as torch_config
from mdgen_tpu_torch import summarize_upsampling as torch_summarize
from mdgen_tpu_torch import xtc as torch_xtc
from mdgen_tpu_torch.analysis import metrics as torch_metrics
from mdgen_tpu_torch.analysis import msm as torch_msm
from mdgen_tpu_torch.data import write_synthetic_dataset as torch_write_dataset
from mdgen_tpu_torch.data.loader import Loader as TorchLoader
from mdgen_tpu_torch.geometry import constants as torch_rc
from mdgen_tpu_torch.runtime.metrics import MetricLogger as TorchMetricLogger
from mdgen_tpu_torch.runtime.preempt import GracefulStop as TorchGracefulStop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Imports the given modules with an audit hook that refuses any open of a
# file under mdgen_tpu/ (a .py or its cached .pyc), then checks that neither
# jax nor any mdgen_tpu module was imported.
_PROBE = textwrap.dedent("""
    import importlib, os, sys
    repo, names = sys.argv[1], sys.argv[2:]
    jax_pkg = os.path.join(repo, "mdgen_tpu") + os.sep
    def hook(event, args):
        if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
            path = os.path.abspath(os.fsdecode(args[0]))
            if path.startswith(jax_pkg):
                raise RuntimeError(f"opened a file of the JAX package: {path}")
    sys.path.insert(0, repo)
    sys.addaudithook(hook)
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "mdgen_tpu"))
    assert not bad, f"imported {bad}"
    print(f"imported {len(names)} modules")
""")


def _probe(names):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", _PROBE, REPO, *names], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def _port_modules():
    names = ["mdgen_tpu_torch"]
    for info in pkgutil.walk_packages(mdgen_tpu_torch.__path__, "mdgen_tpu_torch."):
        names.append(info.name)
    return names


def _chip_smoke_imports():
    """chip_smoke itself and every module it imports anywhere in its body."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = {"chip_smoke"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            for a in node.names:  # `from pkg import module`
                full = f"{node.module}.{a.name}"
                if node.module.startswith("mdgen_tpu_torch") and _is_module(full):
                    names.add(full)
    return sorted(names)


def _is_module(name):
    return os.path.exists(os.path.join(REPO, *name.split(".")) + ".py") or os.path.isdir(
        os.path.join(REPO, *name.split(".")))


# modules the quality chain added; the walk over the package must find them
QUALITY_CHAIN = ["mdgen_tpu_torch.xtc", "mdgen_tpu_torch.protein", "mdgen_tpu_torch.analysis",
                 "mdgen_tpu_torch.analysis.featurize", "mdgen_tpu_torch.analysis.metrics",
                 "mdgen_tpu_torch.analysis.msm", "mdgen_tpu_torch.analysis.reference_msm",
                 "mdgen_tpu_torch.analyze_peptide_sim", "mdgen_tpu_torch.quality_run",
                 "mdgen_tpu_torch.data.synthetic", "mdgen_tpu_torch.transport.integrators"]
# and the TPS and upsampling tasks
TPS_UPSAMPLING = ["mdgen_tpu_torch.tps_inference", "mdgen_tpu_torch.upsampling_inference",
                  "mdgen_tpu_torch.analyze_peptide_tps", "mdgen_tpu_torch.analyze_upsampling",
                  "mdgen_tpu_torch.summarize_upsampling"]
# and inpainting and design
DESIGN = ["mdgen_tpu_torch.design_inference", "mdgen_tpu_torch.analyze_peptide_design",
          "mdgen_tpu_torch.transport.dirichlet"]
# and Hyena, the ATLAS dataset, the no_frames and SDE / likelihood modules
OPTIONS = ["mdgen_tpu_torch.models.hyena", "mdgen_tpu_torch.models.layers",
           "mdgen_tpu_torch.data.dataset", "mdgen_tpu_torch.tasks",
           "mdgen_tpu_torch.transport.paths", "mdgen_tpu_torch.transport.transport"]


# and data-parallel training, reference checkpoints, MD preprocessing and
# the noise-floor protocol
SLICE11 = ["mdgen_tpu_torch.interop", "mdgen_tpu_torch.port_checkpoint",
           "mdgen_tpu_torch.prep_sims", "mdgen_tpu_torch.parallel",
           "mdgen_tpu_torch.parallel.distributed", "mdgen_tpu_torch.noise_floor",
           "mdgen_tpu_torch.eval_protocol"]
# and tensor and sequence parallelism
SLICE12 = ["mdgen_tpu_torch.parallel.mesh"]


@pytest.mark.parametrize("which", ["package", "chip_smoke"])
def test_nothing_opens_a_file_of_the_jax_package(which):
    names = _port_modules() if which == "package" else _chip_smoke_imports()
    assert len(names) > (30 if which == "package" else 10)
    if which == "package":
        want = set(QUALITY_CHAIN + TPS_UPSAMPLING + DESIGN + OPTIONS + SLICE11 + SLICE12)
        assert want <= set(names), want - set(names)
    r = _probe(names)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"imported {len(names)} modules" in r.stdout


def _fields(cls):
    return [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_match():
    assert _fields(torch_config.MDGenConfig) == _fields(jax_config.MDGenConfig)
    j, t = jax_config.MDGenConfig(), torch_config.MDGenConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.to_json() == j.to_json()
    for kw in ({}, {"tps_condition": True}, {"design": True}, {"no_frames": True}):
        assert t.replace(**kw).latent_dim == j.replace(**kw).latent_dim


RECIPE_4AA = ["--sim_condition", "--train_split", "splits/4AA_sim_train.csv", "--val_split",
              "splits/4AA_sim_val.csv", "--data_dir", "data/4AA_sims", "--num_frames", "1000",
              "--prepend_ipa", "--abs_pos_emb", "--crop", "4", "--ckpt_freq", "40",
              "--val_repeat", "25", "--epochs", "10000", "--run_name", "4AA_sim",
              "--abs_time_emb", "--path-type", "GVP", "--precision", "bf16-mixed"]


def test_config_from_4aa_recipe_args_matches():
    def parse(mod):
        parser = mod.add_model_args(argparse.ArgumentParser())
        args, _ = parser.parse_known_args(RECIPE_4AA)
        return dataclasses.asdict(mod.config_from_args(args))

    got, want = parse(torch_config), parse(jax_config)
    assert got == want
    assert got["num_frames"] == 1000 and got["crop"] == 4 and got["sim_condition"]
    # a port config round-trips through the JAX package's JSON and back
    cfg = torch_config.MDGenConfig(**got)
    assert jax_config.MDGenConfig.from_json(cfg.to_json()) == jax_config.MDGenConfig(**want)


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and not callable(v) and not isinstance(v, type(np))
            and k != "annotations"}


def test_residue_constants_match():
    want, got = _public(jax_rc), _public(torch_rc)
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        if isinstance(ref, np.ndarray):
            assert got[name].dtype == ref.dtype and np.array_equal(got[name], ref), name
        elif name == "rigid_group_atom_positions":
            assert {k: [(a, g, p.tolist()) for a, g, p in v] for k, v in got[name].items()} == \
                {k: [(a, g, p.tolist()) for a, g, p in v] for k, v in ref.items()}
        else:
            assert got[name] == ref, name
    for seq in ("ACDE", "XWYZ", ""):
        aat = torch_rc.str_sequence_to_aatype(seq)
        assert np.array_equal(aat, jax_rc.str_sequence_to_aatype(seq))
        assert torch_rc.aatype_to_str_sequence(aat) == jax_rc.aatype_to_str_sequence(aat)


class _Items:
    def __init__(self, n):
        rng = np.random.default_rng(7)
        self.items = [{"atom14": rng.normal(size=(3, 2, 14, 3)).astype(np.float32),
                       "seqres": rng.integers(0, 20, size=2), "mask": np.ones(2, np.float32),
                       "name": f"p{i}"} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("kw", [dict(batch_size=2, seed=3),
                                dict(batch_size=3, seed=0, drop_last=False, max_batches=3),
                                dict(batch_size=4, seed=1, num_shards=2, shard_id=1),
                                dict(batch_size=2, shuffle=False)],
                         ids=["shuffle", "ragged", "shard", "ordered"])
def test_loader_yields_the_same_batches(kw):
    ds = _Items(9)
    want, got = list(JaxLoader(ds, **kw)), list(TorchLoader(ds, **kw))
    assert len(got) == len(want) == len(JaxLoader(ds, **kw)) == len(TorchLoader(ds, **kw))
    assert len(got) > 0
    for a, b in zip(got, want):
        assert a["name"] == b["name"]
        for k in ("atom14", "seqres", "mask"):
            assert np.array_equal(a[k], b[k])


def _sentinel_case(cls, tmp, case):
    """Returns (removed, poll) for one STOP-sentinel scenario."""
    run = os.path.join(tmp, cls.__module__.replace(".", "_"), case)
    os.makedirs(run)
    stop = os.path.join(run, "STOP")
    now = time.time()
    if case != "no_checkpoint":
        os.makedirs(os.path.join(run, "step_10"))
        os.makedirs(os.path.join(run, "step_x"))  # not a step: ignored
    with open(stop, "w"):
        pass
    if case == "consumed":  # the stop that saved step_10
        os.utime(stop, (now - 100, now - 100))
        os.utime(os.path.join(run, "step_10"), (now - 50, now - 50))
    elif case == "queued":  # asked for after the newest checkpoint
        os.utime(os.path.join(run, "step_10"), (now - 100, now - 100))
        os.utime(stop, (now - 50, now - 50))
    gs = cls(sentinel_path=stop, install_signal=False)
    try:
        removed = gs.clear_sentinel(ckpt_dir=run)
        return removed, os.path.exists(stop), gs.poll()
    finally:
        gs.close()


@pytest.mark.parametrize("case", ["consumed", "queued", "no_checkpoint"])
def test_graceful_stop_tells_consumed_from_queued(case, tmp_path):
    want = _sentinel_case(JaxGracefulStop, str(tmp_path), case)
    got = _sentinel_case(TorchGracefulStop, str(tmp_path), case)
    assert got == want
    # commit 1cba0a5: a consumed sentinel is cleared, a queued one is honored
    assert got == ((True, False, False) if case == "consumed" else (False, True, True))


def test_metric_logger_flushes_the_same_means_and_csv(tmp_path):
    """The port writes with ``csv`` the CSV the JAX logger writes with pandas."""
    pytest.importorskip("pandas")
    out = {}
    for name, cls in (("jax", JaxMetricLogger), ("torch", TorchMetricLogger)):
        d = tmp_path / name
        d.mkdir()
        log = cls(model_dir=str(d))
        for i, v in enumerate((0.5, 1.25, float("nan"), 2.0)):
            log.log_dict({"loss": v, "grad_norm": 10 * i})
        log.log("loss", 3.0, stage="val")
        means = log.flush("train", save=True, epoch=3, step=7)
        out[name] = (means, (d / "train_3.csv").read_text(), log.flush("val", epoch=3, step=7))
    (jm, jcsv, jval), (tm, tcsv, tval) = out["jax"], out["torch"]
    assert tm == jm and tval == jval
    assert tm["train_loss"] == pytest.approx(1.25)
    assert tcsv.splitlines() == jcsv.splitlines()


def _seeded_msm_inputs():
    rng = np.random.default_rng(11)
    # a slow 3-well signal in 4 features, and its discretisation
    wells = np.repeat(rng.integers(0, 3, size=60), 25)
    feats = np.stack([np.cos(wells + 0.1 * rng.normal(size=wells.size)),
                      np.sin(wells + 0.1 * rng.normal(size=wells.size)),
                      0.3 * rng.normal(size=wells.size),
                      wells + 0.2 * rng.normal(size=wells.size)], axis=1)
    return feats, wells


def _msm_outputs(msm):
    feats, wells = _seeded_msm_inputs()
    tica = msm.TICA(lag=5).fit(feats)
    Y = tica.transform(feats)
    km = msm.KMeans(k=8, seed=3).fit(Y)
    dtraj = km.transform(Y)
    model = msm.estimate_markov_model(dtraj, lag=2, n_states=8).pcca(3)
    coarse = msm.estimate_markov_model(model.metastable_assignments[dtraj], lag=2, n_states=3)
    tp = msm.sample_tp(coarse.transition_matrix, 0, len(coarse.active_set) - 1, 6, 20,
                       rng=np.random.default_rng(4))
    return [tica.eigenvalues, Y, km.centers, dtraj, model.transition_matrix, model.pi,
            model.active_set, model.metastable_assignments, coarse.transition_matrix, tp,
            msm.get_tp_likelihood(tp, coarse.transition_matrix), msm.get_state_probs(tp, 3),
            msm.pcca_assignments(model.transition_matrix, 2)]


def _metrics_outputs(metrics):
    rng = np.random.default_rng(12)
    a, b = rng.vonmises(0.5, 2.0, size=(2, 500))
    c, d = rng.vonmises(-1.0, 1.0, size=(2, 500))
    p, q = rng.integers(0, 9, size=(2, 30))
    return [metrics.jensen_shannon(p, q), metrics.hist_jsd(a, c), metrics.hist_jsd_2d(a, b, c, d),
            metrics.acovf(a, 50), metrics.acovf(a, 50, adjusted=True, demean=False),
            metrics.autocorrelation(b, 40), metrics.torsion_decorrelation_curve(a, 60),
            metrics.torsion_decorrelation(c, 30)]


@pytest.mark.parametrize("which", ["msm", "metrics"])
def test_analysis_copies_give_the_same_outputs(which):
    run = {"msm": _msm_outputs, "metrics": _metrics_outputs}[which]
    want, got = run({"msm": jax_msm, "metrics": jax_metrics}[which]), \
        run({"msm": torch_msm, "metrics": torch_metrics}[which])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), i


def test_xtc_copy_gives_the_same_outputs(tmp_path):
    rng = np.random.default_rng(13)
    coords = (rng.normal(size=(5, 23, 3)) * 1.7).astype(np.float32)
    mask = rng.random(23) > 0.3
    assert np.array_equal(torch_xtc.superpose(coords, mask), jax_xtc.superpose(coords, mask))
    for fn, (got, want) in {"kabsch": (torch_xtc.kabsch(coords[1], coords[0]),
                                       jax_xtc.kabsch(coords[1], coords[0]))}.items():
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), fn
    a, b = str(tmp_path / "a.xtc"), str(tmp_path / "b.xtc")
    torch_xtc.write_xtc_angstrom(a, coords * 10, steps=np.arange(5) * 7, times=np.arange(5) * 0.5)
    jax_xtc.write_xtc_angstrom(b, coords * 10, steps=np.arange(5) * 7, times=np.arange(5) * 0.5,
                               use_native=False)
    assert open(a, "rb").read() == open(b, "rb").read()
    for g, w in zip(torch_xtc.read_xtc(a), jax_xtc.read_xtc(b)):
        assert np.array_equal(g, w)


ROTAMER_PEPTIDES = [("ACDE", "ACDE"), ("WYNK", "WYNK"), ("FHMT", "FHMT")]


@pytest.mark.parametrize("kw", [dict(), dict(path_seed=5, replay_frames=400)],
                         ids=["default", "path_seed_replay"])
def test_rotamer_dataset_writer_matches_jax(tmp_path, kw):
    """The same split.csv bytes; the same .npy shape and dtype (float16), and
    the same numpy draws: every element within one float16 ulp of the JAX
    file's, or within 2^-22 A for elements near 0 (subnormal float16, whose
    ulp is below the f32 rounding of the Angstrom-sized terms the geometry
    sums). The atoms are rebuilt by f32 geometry in another framework, so a
    few elements round the other way: 1 to 8 of 50400 per peptide at 300
    frames (one of them a 2-subnormal-ulp difference of 1.2e-7 A)."""
    j, t = tmp_path / "jax", tmp_path / "torch"
    jax_csv = jax_write_dataset(str(j), ROTAMER_PEPTIDES, 300, seed=0, rotamers=True, **kw)
    torch_csv = torch_write_dataset(str(t), ROTAMER_PEPTIDES, 300, seed=0, rotamers=True, **kw)
    assert open(torch_csv, "rb").read() == open(jax_csv, "rb").read()
    differ = 0
    for name, _ in ROTAMER_PEPTIDES:
        want, got = np.load(j / f"{name}.npy"), np.load(t / f"{name}.npy")
        assert got.shape == want.shape == (300, 4, 14, 3) and got.dtype == want.dtype == np.float16
        assert np.isfinite(got).all()
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
        diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert (diff <= np.maximum(ulp.astype(np.float32), 2.0**-22)).all(), name
        differ += int((got != want).sum())
    assert differ <= 0.001 * 3 * got.size, differ  # a few in 50400 per peptide


def _original_summarizer():
    spec = importlib.util.spec_from_file_location(
        "summarize_upsampling_original", os.path.join(REPO, "scripts", "summarize_upsampling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_summarize_upsampling_copy_matches_original(tmp_path):
    """The same source and the same JSON on a seeded pickle of three
    peptides: live and sub-Nyquist torsions, a frozen one (nonfinite lags)
    and curves of unequal length."""
    original = _original_summarizer()
    for fn in ("summarize", "main"):
        assert inspect.getsource(getattr(torch_summarize, fn)) == \
            inspect.getsource(getattr(original, fn)), fn
    rng = np.random.default_rng(21)
    results = {}
    for name in ("ACDE", "WYNK", "GSVL"):
        sections = {"backbone": {}, "sidechain": {}}
        for i in range(6):
            n = int(rng.integers(5, 40))
            truth = np.cumprod(np.r_[1.0, rng.uniform(0.2, 0.99, n - 1)]).astype(np.float16)
            gen = (truth + rng.normal(0, 0.05, n)).astype(np.float16)[: n - i % 3]
            if i == 5 and name == "GSVL":
                truth[1:] = np.nan
            sections["backbone" if i < 3 else "sidechain"][f"res{i % 4}_tor{i}"] = {
                "truth": truth, "gen": gen, "naive": truth[:2]}
        results[name] = sections
    pkl = str(tmp_path / "upsampling_out.pkl")
    with open(pkl, "wb") as fh:
        pickle.dump(results, fh)
    for max_lag in (20, 3):
        got, want = torch_summarize.summarize(pkl, max_lag), original.summarize(pkl, max_lag)
        assert got == want
    assert want["live_n"] > 0 and want["sub_nyquist_n"] > 0 and want["skipped_nonfinite"] == 1


_TASK_NO_JAX = textwrap.dedent("""
    import sys
    for m in ("jax", "flax", "optax", "orbax", "pandas", "matplotlib"):
        sys.modules[m] = None  # any import of these now raises ImportError
    import math
    from mdgen_tpu_torch import quality_run

    task, frames = sys.argv[1], sys.argv[2]
    res = quality_run.main(["--task", task, "--out", "q", "--epochs", "3", "--num_frames", frames,
                            "--md_frames", "300", "--embed_dim", "32", "--num_layers", "2",
                            "--mha_heads", "4", "--ipa_head_dim", "8", "--device", "cpu",
                            "--train_extra=--sampling_method euler --inference_steps 3"
                            + (" --inference_batches 1 --val_epoch_freq 3" if task == "design"
                               else "")])
    s = res["summary"]
    if task == "tps":
        assert len(s["per_peptide"]) == 8, s
        vals = [v for d in s["per_peptide"].values() for v in d.values()]
        assert len(res["samples"]) == 16 and all(len(r["paths"]) == 8 for r in res["samples"])
    elif task == "design":
        assert len(s["per_peptide"]) == 8, s
        vals = [s[k] for k in ("designed", "cond", "consensus", "mode_pair")]
        vals += list(s["val_recovery"].values())  # the designability probe's
        assert all(0 <= v <= 1 for v in vals), vals
        assert len(s["val_recovery"]) == 4, s["val_recovery"]
        assert len(res["samples"]) == 16 and all(len(r["paths"]) == 16 for r in res["samples"])
    else:
        assert s["live_n"] + s["sub_nyquist_n"] > 0 and len(s["per_peptide"]) == 8, s
        vals = [s["live_mean_acf_err"] or s["sub_nyquist_mean_acf_err"]]
        assert all(r["frames"] == 300 for r in res["samples"]), [r["frames"] for r in res["samples"]]
    assert all(math.isfinite(v) for v in vals), vals
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "flax", "optax", "orbax", "pandas", "matplotlib") and sys.modules[m] is not None]
    assert not bad, bad
    print("TASK_NO_JAX_OK")
""")


@pytest.mark.parametrize("task,frames", [("tps", "8"), ("upsampling", "20"), ("design", "8")])
def test_task_chain_runs_without_jax(task, frames, tmp_path):
    """``quality_run --task tps|upsampling|design`` at a tiny width on the
    CPU: ``train --tps_condition``, ``--sim_condition --cond_interval 10`` or
    ``--inpainting --design`` (with the designability probe),
    ``tps_inference`` / ``upsampling_inference --xtc`` / ``design_inference``,
    ``analyze_peptide_tps`` / ``analyze_upsampling`` and the summarizer /
    ``analyze_peptide_design``, with jax, flax, optax, orbax, pandas and
    matplotlib unimportable."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _TASK_NO_JAX, task, frames], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TASK_NO_JAX_OK" in proc.stdout
    out = {"tps": "tps_out.pkl", "upsampling": "upsampling_out.pkl",
           "design": "ACDE_metadata.json"}[task]
    assert (tmp_path / "q" / "samples" / out).exists()


def _load_original(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _eval_pickle(path):
    rng = np.random.default_rng(31)
    feats = ["PSI 0 ALA", "PHI 1 CYS", "PSI 1 CYS", "CHI1 1 CYS", "PHI 2 ASP", "CHI2 2 ASP"]
    out = {}
    for name in ("ACDE", "WYNK"):
        jsd = {f: float(v) for f, v in zip(feats, rng.uniform(0.05, 0.6, len(feats)))}
        jsd["PHI 1 CYS|PSI 1 CYS"] = 0.3
        jsd["TICA-0"], jsd["TICA-0,1"] = 0.2, 0.4
        out[name] = {"JSD": jsd}
    with open(path, "wb") as fh:
        pickle.dump(out, fh)
    return path


@pytest.mark.parametrize("copy", ["port_reference_state_dict", "PRECISION_MAP",
                                  "local_batch_slice", "summarize"])
def test_slice11_copies_match_originals(copy, tmp_path):
    """The reference map (element-equal on a seeded reference-layout state
    dict), the Lightning precision table, the dp batch slice and the eval
    protocol's summary (its source and its output)."""
    if copy == "port_reference_state_dict":
        import torch

        from mdgen_tpu.interop import port_reference_state_dict as original
        from mdgen_tpu_torch import interop
        from mdgen_tpu_torch.models import LatentMDGenModel

        cfg = torch_config.MDGenConfig(num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2,
                                       ipa_head_dim=8, ipa_qk=2, ipa_v=2, num_frames=4, crop=4,
                                       sim_condition=True, prepend_ipa=True)
        model = LatentMDGenModel(cfg, cfg.latent_dim)
        model.reset_parameters(torch.Generator().manual_seed(0))
        ref = interop.state_dict_to_reference(model.state_dict(), cfg)
        got = dict(interop._flatten(interop.port_reference_state_dict(ref, cfg, cfg.latent_dim)))
        want = dict(interop._flatten(original(
            ref, jax_config.MDGenConfig(**dataclasses.asdict(cfg)), cfg.latent_dim)))
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], np.asarray(w)) for k, w in want.items())
    elif copy == "PRECISION_MAP":
        from mdgen_tpu_torch.interop import PRECISION_MAP

        assert PRECISION_MAP == _load_original("tools/port_checkpoint.py",
                                               "port_checkpoint_original").PRECISION_MAP
    elif copy == "local_batch_slice":
        from mdgen_tpu.parallel.distributed import local_batch_slice as original
        from mdgen_tpu_torch.parallel import local_batch_slice

        for shards, batch in ((1, 8), (2, 8), (4, 8), (8, 8), (3, 12)):
            for sid in range(shards):
                assert local_batch_slice(shards, sid, batch) == original(shards, sid, batch)
        for fn in (local_batch_slice, original):
            with pytest.raises(AssertionError):
                fn(3, 0, 8)
    else:
        from mdgen_tpu_torch import eval_protocol

        env = dict(os.environ)
        try:
            original = _load_original("scripts/eval_protocol.py", "eval_protocol_original")
        finally:  # the script sets JAX_PLATFORMS when it is loaded
            os.environ.clear()
            os.environ.update(env)
        assert inspect.getsource(eval_protocol.summarize) == inspect.getsource(original.summarize)
        pkl = _eval_pickle(str(tmp_path / "out.pkl"))
        assert eval_protocol.summarize(pkl) == original.summarize(pkl)
