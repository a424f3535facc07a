"""The port's trajectory I/O and analysis chain against the JAX package's.

- ``featurize_torsions`` (angles and cos/sin) and ``describe_features``,
  within 1e-5 rad: the same f32 geometry in another framework;
- the XTC writer byte for byte against ``mdgen_tpu.xtc.write_xtc``'s Python
  encoder, and ``save_trajectory`` -> ``load_trajectory`` against the JAX
  pair (the same files, the same atoms read back);
- ``python -m mdgen_tpu_torch.analyze_peptide_sim`` against
  ``scripts/analyze_peptide_sim.py`` run on the same files in a subprocess:
  the same ``out.pkl`` keys, JSDs within 1e-6. A feature within 1e-5 rad of
  a histogram bin edge may land in the neighbouring bin in one package: such
  a JSD is held to the largest change that moving one count between
  neighbouring bins makes (``_one_flip``). The decorrelation curves are
  float16 in both: within one float16 ulp of each entry, or 1e-4 of the
  curve's largest entry where that is more (entries near 0, whose float16
  ulp is below the f32 difference of the features they are summed from).
- `quality_run` end to end at a tiny width, with jax and pandas
  unimportable.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from mdgen_tpu import protein as jax_protein
from mdgen_tpu import xtc as jax_xtc
from mdgen_tpu.analysis import featurize as jax_featurize
from mdgen_tpu.data import synthetic_rotamer_trajectory
from mdgen_tpu.geometry import constants as rc
from mdgen_tpu_torch import analyze_peptide_sim, protein, xtc
from mdgen_tpu_torch.analysis import featurize
from mdgen_tpu_torch.analysis.metrics import jensen_shannon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEPTIDES = ("ACDE", "WYNK")


@pytest.fixture(scope="module")
def trajs():
    """{name: (reference MD [300, 4, 14, 3] f32, a 'sampled' trajectory of 40
    frames from another path of the same system, aatype)}."""
    out = {}
    for i, seq in enumerate(PEPTIDES):
        md = synthetic_rotamer_trajectory(seq, 300, seed=i).astype(np.float32)
        sampled = synthetic_rotamer_trajectory(seq, 40, seed=i, path_seed=50 + i,
                                               replay_frames=300).astype(np.float32)
        out[seq] = (md, sampled, rc.str_sequence_to_aatype(seq))
    return out


@pytest.mark.parametrize("sidechains", [True, False], ids=["sidechains", "backbone"])
@pytest.mark.parametrize("cossin", [True, False], ids=["cossin", "angles"])
def test_featurize_torsions_matches_jax(trajs, sidechains, cossin):
    for md, _, aatype in trajs.values():
        want = jax_featurize.featurize_torsions(md, aatype, sidechains=sidechains, cossin=cossin)
        got = featurize.featurize_torsions(md, aatype, sidechains=sidechains, cossin=cossin)
        assert got.shape == want.shape and got.dtype == want.dtype
        diff = got - want
        if not cossin:  # wrapped angles: compare on the circle
            diff = (diff + np.pi) % (2 * np.pi) - np.pi
        assert np.abs(diff).max() < 1e-5, np.abs(diff).max()
        for cs in (True, False):
            assert featurize.describe_features(aatype, sidechains, cs) == \
                jax_featurize.describe_features(aatype, sidechains, cs)
        angles, mask = featurize.torsion_angles(md[:5], aatype)
        want_angles, want_mask = jax_featurize.torsion_angles(md[:5], aatype)
        assert np.array_equal(mask, want_mask)
        assert np.abs(np.where(want_mask[None] > 0, angles - want_angles, 0)).max() < 1e-5


def test_xtc_bytes_match_jax_python_encoder(tmp_path):
    rng = np.random.default_rng(3)
    coords = (rng.normal(size=(7, 57, 3)) * 2.5).astype(np.float32)
    coords[3, 5:9] = coords[3, 4]  # runs of nearby atoms (the run-length path)
    for precision in (1000.0, 100.0):
        a, b = tmp_path / f"port{precision}.xtc", tmp_path / f"jax{precision}.xtc"
        xtc.write_xtc(str(a), coords, precision=precision)
        jax_xtc.write_xtc(str(b), coords, precision=precision, use_native=False)
        assert a.read_bytes() == b.read_bytes()
        got, steps, times = xtc.read_xtc(str(a))
        want = jax_xtc.read_xtc(str(b))
        assert np.array_equal(got, want[0]) and np.array_equal(steps, want[1])
        assert np.array_equal(times, want[2])
        assert np.abs(got - coords).max() <= 0.5 / precision + 1e-6


@pytest.mark.parametrize("with_xtc", [True, False], ids=["xtc", "pdb"])
def test_save_and_load_trajectory_match_jax(trajs, tmp_path, with_xtc):
    _, sampled, aatype = trajs["WYNK"]
    paths = {}
    for name, mod in (("port", protein), ("jax", jax_protein)):
        d = tmp_path / name
        d.mkdir()
        pdb = str(d / "WYNK.pdb")
        mod.save_trajectory(sampled, aatype, pdb, xtc_path=str(d / "WYNK.xtc") if with_xtc else None)
        paths[name] = pdb
    files = ("WYNK.pdb", "WYNK.xtc") if with_xtc else ("WYNK.pdb",)
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    got, got_aat = protein.load_trajectory(paths["port"])
    want, want_aat = jax_protein.load_trajectory(paths["jax"])
    assert np.array_equal(got_aat, want_aat) and np.array_equal(got_aat, aatype)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert got.shape == sampled.shape
    # what was written comes back: XTC precision (1e-3 nm) after superposition
    # onto frame 0, PDB precision (1e-3 A) without
    if not with_xtc:
        assert np.abs(got - sampled).max() <= 5e-4 + 1e-5


def _one_flip(counts_ref, counts_traj):
    """The largest change of the JSD that moving one count of either
    histogram into a neighbouring bin makes."""
    base = jensen_shannon(counts_ref, counts_traj)
    worst = 0.0
    for which in (0, 1):
        h = [np.array(counts_ref, np.float64).ravel(), np.array(counts_traj, np.float64).ravel()]
        for i in np.nonzero(h[which])[0]:
            for j in (i - 1, i + 1):
                if 0 <= j < len(h[which]):
                    g = [x.copy() for x in h]
                    g[which][i] -= 1
                    g[which][j] += 1
                    worst = max(worst, abs(jensen_shannon(*g) - base))
    return worst


def _write_pair(trajs, root):
    """Reference MD .npy files and sampled trajectories (frame-0 PDB + XTC,
    as ``sim_inference --xtc`` writes them) under ``root``."""
    mddir, pdbdir = root / "md", root / "samples"
    mddir.mkdir()
    pdbdir.mkdir()
    for name, (md, sampled, aatype) in trajs.items():
        np.save(mddir / f"{name}.npy", md.astype(np.float16))
        protein.save_trajectory(sampled, aatype, str(pdbdir / f"{name}.pdb"),
                                xtc_path=str(pdbdir / f"{name}.xtc"))
    return str(mddir), str(pdbdir)


@pytest.mark.parametrize("flags", [["--no_msm", "--no_decorr", "--tica_lag", "10"],
                                   ["--tica_lag", "10", "--msm_lag", "2"]],
                         ids=["jsd_only", "msm_decorr"])
def test_analyze_peptide_sim_matches_jax_script(trajs, tmp_path, flags):
    mddir, pdbdir = _write_pair(trajs, tmp_path)
    argv = ["--mddir", mddir, "--pdbdir", pdbdir, "--save", *flags]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "analyze_peptide_sim.py"),
                           *argv, "--save_name", "jax.pkl"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = analyze_peptide_sim.main(argv + ["--save_name", "port.pkl"])
    with open(os.path.join(pdbdir, "jax.pkl"), "rb") as fh:
        want = pickle.load(fh)
    with open(os.path.join(pdbdir, "port.pkl"), "rb") as fh:
        assert pickle.load(fh).keys() == got.keys()
    assert got.keys() == want.keys() == set(PEPTIDES)
    for name in PEPTIDES:
        g, w = got[name], want[name]
        assert g.keys() == w.keys(), (sorted(g), sorted(w))
        assert g["features"] == w["features"]
        assert g["JSD"].keys() == w["JSD"].keys()
        md, sampled, aatype = trajs[name]
        ang = {k: featurize.featurize_torsions(x, aatype, sidechains=True, cossin=False)
               for k, x in (("md", md.astype(np.float16).astype(np.float32)), ("ours", protein.load_trajectory(
                   os.path.join(pdbdir, f"{name}.pdb"))[0]))}
        edges = np.linspace(-np.pi, np.pi, 101)
        for i, feat in enumerate(g["features"]):
            err = abs(g["JSD"][feat] - w["JSD"][feat])
            near = any(np.abs(a[:, i, None] - edges).min() < 1e-5 for a in ang.values())
            tol = 1e-6
            if near:
                counts = [np.histogram(a[:, i], range=(-np.pi, np.pi), bins=100)[0]
                          for a in (ang["md"], ang["ours"])]
                tol += _one_flip(*counts)
            assert err <= tol, (name, feat, err, tol)
        for key in g["JSD"]:
            if key not in g["features"]:  # Ramachandran pairs and TICA
                assert abs(g["JSD"][key] - w["JSD"][key]) <= 1e-6, (name, key)
            assert 0.0 <= g["JSD"][key] <= 1.0
        for key in set(g) - {"features", "JSD"}:
            if isinstance(w[key], dict):
                assert g[key].keys() == w[key].keys()
                for f in w[key]:
                    a, b = g[key][f], w[key][f]
                    assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
                    a, b = a.astype(np.float32), b.astype(np.float32)
                    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
                    tol = np.maximum(ulp.astype(np.float32), 1e-4 * np.abs(b).max())
                    assert (np.abs(a - b) <= tol).all(), (name, key, f, np.abs(a - b).max())
            else:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=1e-9,
                                           err_msg=f"{name} {key}")


_QUALITY_NO_JAX = textwrap.dedent("""
    import sys
    for m in ("jax", "flax", "optax", "orbax", "pandas", "matplotlib"):
        sys.modules[m] = None  # any import of these now raises ImportError
    import json, math
    from mdgen_tpu_torch import quality_run

    res = quality_run.main(["--out", "q", "--epochs", "3", "--num_frames", "8",
                            "--md_frames", "200", "--num_rollouts", "2", "--embed_dim", "32",
                            "--num_layers", "2", "--mha_heads", "4", "--ipa_head_dim", "8",
                            "--device", "cpu"])
    s = res["summary"]
    assert set(s) == {"per_peptide_mean_torsion_jsd", "mean_torsion_jsd", "mean_all_jsd"}
    assert len(s["per_peptide_mean_torsion_jsd"]) == 8
    vals = [s["mean_torsion_jsd"], s["mean_all_jsd"], *s["per_peptide_mean_torsion_jsd"].values()]
    assert all(math.isfinite(v) and 0 <= v <= 1 for v in vals), vals
    assert all(x["reached_t1"] for r in res["samples"] for x in r["solves"])
    assert json.loads(json.dumps(s)) == s
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "flax", "optax", "orbax", "pandas", "matplotlib") and sys.modules[m] is not None]
    assert not bad, bad
    print("QUALITY_NO_JAX_OK")
""")


def test_quality_run_without_jax(tmp_path):
    """``quality_run`` at a tiny width on the CPU (dataset, 3 train steps,
    2 dopri5 rollouts with --xtc, analysis), with jax, flax, optax, orbax,
    pandas and matplotlib unimportable: prints the original script's JSON."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _QUALITY_NO_JAX], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "QUALITY_NO_JAX_OK" in proc.stdout
    assert '"mean_torsion_jsd"' in proc.stdout
    for name in ("ACDE", "LCTV"):
        assert (tmp_path / "q" / "samples" / f"{name}.xtc").exists()
    assert (tmp_path / "q" / "samples" / "out.pkl").exists()
