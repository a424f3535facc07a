"""The noise-floor protocol on the port (``python -m
mdgen_tpu_torch.noise_floor`` and ``eval_protocol``) against
``scripts/noise_floor.py``.

The floor's JSDs (``floor.pkl``) at 300 MD frames and 200 generated frames
in 2 paths, all 8 peptides of the script:
  * with the JAX package's rotamer generator in the port's protocol, equal
    to the script's within 1e-6 relative: the same systems, paths, frames,
    files and analysis;
  * with the port's own generator, within 5e-3: that writer agrees with
    JAX's to one float16 ulp in a few elements per peptide
    (``test_torch_selfcontained.py::test_rotamer_dataset_writer_matches_jax``),
    which moves a torsion of a frame across a histogram bin edge now and
    then (1.2e-3 at these sizes).
The eval protocol runs its four stages (eval data, sampling, analysis,
floor) on a tiny trained run on the CPU, in a process that cannot import
jax, and prints a finite table.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import mdgen_tpu_torch.data
from mdgen_tpu.data import synthetic_rotamer_trajectory as jax_rotamer_trajectory
from mdgen_tpu.data import write_synthetic_dataset as jax_write_dataset
from mdgen_tpu_torch import noise_floor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOOR_ARGS = ["--md_frames", "300", "--n_gen", "200", "--n_paths", "2"]


@pytest.fixture(scope="module")
def script_floor(tmp_path_factory):
    out = tmp_path_factory.mktemp("floor") / "jax"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "noise_floor.py"),
                        "--out", str(out), *FLOOR_ARGS], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out / "samples" / "floor.pkl", "rb") as fh:
        return pickle.load(fh)


@pytest.mark.parametrize("generator,rtol,atol", [("jax", 1e-6, 0.0), ("port", 0.0, 5e-3)])
def test_noise_floor_matches_script(script_floor, generator, rtol, atol, tmp_path, monkeypatch):
    if generator == "jax":
        monkeypatch.setattr(mdgen_tpu_torch.data, "synthetic_rotamer_trajectory",
                            jax_rotamer_trajectory)
        monkeypatch.setattr(mdgen_tpu_torch.data, "write_synthetic_dataset", jax_write_dataset)
    got = noise_floor.main(["--out", str(tmp_path), *FLOOR_ARGS])
    with open(tmp_path / "samples" / "floor.pkl", "rb") as fh:
        assert pickle.load(fh).keys() == got.keys()
    assert sorted(got) == sorted(script_floor) == sorted(noise_floor.PEPTIDES)
    for name, want in script_floor.items():
        assert got[name]["JSD"].keys() == want["JSD"].keys()
        for k, w in want["JSD"].items():
            np.testing.assert_allclose(got[name]["JSD"][k], w, rtol=rtol, atol=atol,
                                       err_msg=f"{name} {k}")


_EVAL_NO_JAX = textwrap.dedent("""
    import math, sys
    for m in ("jax", "flax", "optax", "orbax", "pandas", "matplotlib"):
        sys.modules[m] = None  # any import of these now raises ImportError
    from mdgen_tpu_torch import eval_protocol, train
    from mdgen_tpu_torch.data import write_synthetic_dataset

    split = write_synthetic_dataset("train_data", [(s, s) for s in eval_protocol.PEPTIDES],
                                    num_frames=300, seed=0, rotamers=True)
    rec = train.main(["--device", "cpu", "--sim_condition", "--prepend_ipa", "--abs_pos_emb",
                      "--abs_time_emb", "--crop", "4", "--num_frames", "8", "--num_layers", "2",
                      "--embed_dim", "32", "--mha_heads", "4", "--ipa_head_dim", "8",
                      "--batch_size", "8", "--epochs", "2", "--no_validate",
                      "--sampling_method", "euler", "--inference_steps", "3",
                      "--train_split", split, "--val_split", split, "--data_dir", "train_data",
                      "--workdir", "workdir", "--run_name", "tiny"])
    res = eval_protocol.main(["--ckpt", rec["model_dir"], "--train_data", "train_data",
                              "--out", "eval", "--train_frames", "300", "--eval_frames", "400",
                              "--num_rollouts", "1", "--device", "cpu"])
    t = res["table"]
    vals = [t["mean_torsion_jsd"], t["floor_torsion_jsd"], t["ratio"]]
    vals += [v[k] for v in t["per_type"].values() for k in ("model", "floor", "ratio")]
    assert len(t["per_type"]) >= 3 and all(math.isfinite(v) for v in vals), t
    assert len(res["samples"]) == 8 and all(r["frames"] == 8 for r in res["samples"])
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "flax", "optax", "orbax", "pandas", "matplotlib") and sys.modules[m] is not None]
    assert not bad, bad
    print("EVAL_NO_JAX_OK")
""")


def test_eval_protocol_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _EVAL_NO_JAX], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "EVAL_NO_JAX_OK" in r.stdout and "EVAL PROTOCOL OK" in r.stdout
    assert "drift evaluations per solve" in r.stdout
    for f in ("samples/out_eval.pkl", "floor/samples/floor.pkl", "data/split.csv"):
        assert (tmp_path / "eval" / f).exists(), f
